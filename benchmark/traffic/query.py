"""Traffic kind ``query``: a planner querying a map, closed loop, one
client.

The map is an ``SDFQueryEngine`` over the configuration's model with the
benchmark's weights (handed over through params_from_jax) and the room's
scene frame. Each request asks for ``points`` points drawn uniformly in
the room; requests alternate between SDF values and spatial gradients,
and cycle through ``distinct`` point sets made at set-up. A request's
latency runs from the call to the returned array. Every ``check_every``-th
answer (from an offset drawn from the seed) is kept and held against the
plain reference once the window has closed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import common
from benchmark import counts as CNT
from benchmark import inputs as I
from benchmark import reference as REF
from benchmark.trace import Profiler


def make_engine(ctx, cfg, layers, room):
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.serve import SDFQueryEngine
    from isdf_tpu_torch.utils.config import config_from_dict

    c = config_from_dict(cfg)
    model = M.SDFModel(
        embedding_size=c.embedding_size, hidden_size=c.hidden_feature_size,
        hidden_layers_block=c.hidden_layers_block,
        scale_output=c.scale_output, scale_input=c.scale_input, min_deg=0,
        max_deg=c.n_embed_funcs, mm_precision=c.mm_precision,
        compute_dtype=c.compute_dtype)
    params = M.params_from_jax(I.as_tree(layers, c.hidden_layers_block),
                               model, device=ctx.device)
    transform = torch.as_tensor(
        np.linalg.inv(room.bounds_transform()).astype(np.float32),
        device=ctx.device)
    return SDFQueryEngine(params=params, model=model, transform=transform)


def run(ctx) -> common.Outcome:
    cfg = ctx.config()
    p = ctx.params
    dev = ctx.device
    mp = REF.Map(cfg)
    n, every = int(p["points"]), int(p["check_every"])
    room = I.Room(ctx.seed)
    layers = I.make_weights(ctx.seed, mp.E, mp.H, mp.blocks, dev)
    pool = [I.query_points(ctx.seed, i, n, room)
            for i in range(int(p["distinct"]))]
    offset = int(I.rng(ctx.seed, 3).integers(0, every))
    engine = make_engine(ctx, cfg, layers, room)
    calls = (engine.sdf, engine.grad)
    for _ in range(2):       # every shape the window uses, twice
        for f in calls:
            f(pool[0])
    # a run-in: the card reads slow for its first seconds under load
    warm = time.perf_counter() + float(p.get("warm_s", 0.0))
    i = 0
    while time.perf_counter() < warm:
        calls[i % 2](pool[i % len(pool)])
        i += 1
    prof = Profiler(ctx.trace, ctx.scratch)
    prof.wrap(engine, "sdf", "bench.query")
    prof.wrap(engine, "grad", "bench.query")
    calls = (engine.sdf, engine.grad)
    seconds = (min(ctx.seconds, float(p["trace_seconds"])) if ctx.trace
               else ctx.seconds)
    lat, kept = [], []
    flops = 0
    setup_s = time.perf_counter() - ctx.t_process
    with prof.window(lambda: torch.cuda.synchronize(dev)
                     if dev.type == "cuda" else None):
        t0 = time.perf_counter()
        i = 0
        while True:
            pts = pool[i % len(pool)]
            grad = i % 2 == 1
            a = time.perf_counter()
            out = calls[grad](pts)
            lat.append(time.perf_counter() - a)
            flops += CNT.query_flops(mp.E, mp.H, mp.blocks, mp.n_freqs, n,
                                     grad)
            if i % every == offset:
                kept.append((i, grad, out))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
    ctx.note(f"window: {i} requests of {n} points in {wall:.4f} s; "
             f"median {1e3 * float(np.median(lat)):.4f} ms, "
             f"kept {len(kept)} answers for the comparison")
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    engine = calls = None
    gc.collect()
    checks = _compare(ctx, cfg, layers, room, pool, kept, "f32")
    counters = {"requests": i, "wall_s": wall, "query_flops": flops}
    e2e = {"query_p95_ms": 1e3 * common.percentile(lat, 95.0),
           "setup_s": setup_s}
    return common.Outcome(e2e=e2e, counters=counters, checks=checks,
                          attempted=i, failed=0, memory_peak_bytes=mem,
                          trace=prof.trace)


def gaps(ctx, cfg, layers, room, pool, kept, prec):
    """The worst relative gaps of the kept answers against the reference at
    ``prec``: (SDF values, gradients)."""
    mp = REF.Map(cfg)
    dev = ctx.device
    T = torch.as_tensor(np.linalg.inv(room.bounds_transform())
                        .astype(np.float32), device=dev)
    s_gap = g_gap = 0.0
    for i, grad, out in kept:
        x = torch.as_tensor(pool[i % len(pool)], device=dev)
        o = torch.as_tensor(out, device=dev)
        s, g = REF.query_gaps(layers, mp, T, x, None if grad else o,
                              o if grad else None, prec)
        s_gap, g_gap = max(s_gap, s), max(g_gap, g)
    return s_gap, g_gap


def _compare(ctx, cfg, layers, room, pool, kept, prec):
    s_gap, g_gap = gaps(ctx, cfg, layers, room, pool, kept, prec)
    vals = {"sdf_gap": s_gap, "grad_gap": g_gap}
    return [[k, vals[k], ctx.limit(k)] for k in ctx.cell["limits"]]
