"""The measured window of the training cells, and what follows it.

The window calls the cell's entry with ``bundle`` steps back to back for
``--seconds`` (a traced run: for the cell's ``trace_seconds``, under the
profiler). Each trainer's bundle of steps (its ``fns.train_bundle``, the
call its sim clock times) is timed by a CUDA-event pair of the
benchmark's own on the card's stream: the device time the sim clock bills,
a CUDA graph's replays and the host gaps between their launches included,
the scalars' fetch after it not. Then the device peak is read, the
program's state dropped, and the reference run.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import common
from benchmark import counts as CNT
from benchmark import trainers as TR
from benchmark.trace import Profiler


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EventPairs:
    """CUDA-event pairs around calls on the card (the host clock on the
    CPU), recorded while ``on``; ``seconds()`` sums them once the work has
    finished."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pairs = []
        self.on = True

    def __call__(self, fn, *a, **k):
        if not self.on:
            return fn(*a, **k)
        if self.cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            self.pairs.append((s, e))
        else:
            t = time.perf_counter()
            out = fn(*a, **k)
            self.pairs.append(time.perf_counter() - t)
        return out

    def around(self, obj, method: str):
        """Time every call of ``obj.method`` (this instance only)."""
        fn = getattr(obj, method)
        setattr(obj, method, lambda *a, **k: self(fn, *a, **k))

    def each(self):
        """Each call's seconds."""
        if self.cuda:
            return [s.elapsed_time(e) * 1e-3 for s, e in self.pairs]
        return list(self.pairs)

    def seconds(self) -> float:
        return float(sum(self.each()))


def train_op(cfg: dict) -> dict:
    """The fused train op of a config and its operations and bytes per
    step (counts.py)."""
    mp = TR.REF.Map(cfg)
    s, mo = cfg["sample"], cfg["model"]
    N = (int(mo["window_size"]) * int(s["n_rays"])
         * (int(s["n_strat_samples"]) + int(s["n_surf_samples"])))
    name = "K1-pc" if cfg["loss"]["bounds_method"] == "pc" else "K1-ray"
    R = min(int(mo["window_size"]) * int(s["n_rays"]),
            int(cfg.get("tpu", {}).get("pc_surf_budget", 1000)))
    fb, ff = CNT.flop_count(name, mp.n_layers, mp.H, N, R)
    return {"kernel": name, "bf16": fb, "f32": ff,
            "bytes": CNT.byte_count(name, mp.n_layers, mp.E, N, R)}


def train_window(ctx, cfg: dict, scenes, firsts, prog) -> common.Outcome:
    """Run the window over ``prog`` ({"call": (object, method), "wrap":
    spans to record}), then compare each scene's first steps."""
    p = ctx.params
    dev = ctx.device
    bundle = int(p["bundle"])
    prof = Profiler(ctx.trace, ctx.scratch)
    for obj, method, name in prog["wrap"]:
        prof.wrap(obj, method, name)
    obj, method = prog["call"]
    call = getattr(obj, method)
    seconds = (min(ctx.seconds, float(p["trace_seconds"])) if ctx.trace
               else ctx.seconds)
    ev = EventPairs(dev)
    for sc in scenes:
        ev.around(sc.trainer.fns, "train_bundle")
    # a run-in: the card reads up to 4% slow for its first 10-20 s under
    # load (PERF.md, section 2)
    t_warm = time.perf_counter()
    warm = t_warm + float(p.get("warm_s", 0.0))
    while time.perf_counter() < warm:
        call(bundle)
    sync(dev)
    ev.pairs.clear()
    graphs = [s.trainer.fns.graphs.stats for s in scenes
              if s.trainer.fns.graphs is not None]
    ctx.note(f"set-up: run-in {time.perf_counter() - t_warm:.3f} s; graph "
             f"warm-ups {sum(g['warm_s'] for g in graphs):.3f} s, captures "
             f"{sum(g['captures'] for g in graphs)} in "
             f"{sum(g['capture_s'] for g in graphs):.3f} s")
    setup_s = time.perf_counter() - ctx.t_process
    calls = 0
    m0 = sum(s.trainer.measured_s for s in scenes)
    with prof.window(lambda: sync(dev)):
        t0 = time.perf_counter()
        while True:
            call(bundle)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(dev)
        wall = time.perf_counter() - t0
    billed = ev.seconds()
    K = len(scenes)
    steps = calls * bundle
    each = ev.each()
    n = len(each)
    fifths = [1e3 * sum(each[i * n // 5:(i + 1) * n // 5])
              / max(bundle * ((i + 1) * n // 5 - i * n // 5) / K, 1)
              for i in range(5)]
    ctx.note("window: billed ms a step by fifths of the window: "
             + " ".join(f"{x:.4f}" for x in fifths))
    program_s = (sum(s.trainer.measured_s for s in scenes) - m0) / K
    ctx.note(f"window: {calls} calls of {bundle} steps x {K} scene(s) in "
             f"{wall:.4f} s; billed {billed:.6f} s (the trainers' own "
             f"measured_s over the window: {program_s:.6f} s a scene)")
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    counters = {"steps": K * steps, "scenes": K, "wall_s": wall,
                "billed_s": billed, "bundle": bundle,
                "train_op": train_op(cfg)}
    e2e = {"step_ms": 1e3 * billed / steps, "steps_per_s": K * steps / wall,
           "setup_s": setup_s}
    t_free = time.perf_counter()
    prog.clear()
    call = obj = None
    for s in scenes:
        s.trainer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    worst = {}
    for s, fs in zip(scenes, firsts):
        for k, v in TR.compare(ctx, s, cfg, fs).items():
            worst[k] = max(worst.get(k, 0.0), v)
    ctx.note("reference: " + " ".join(f"{k} {v!r}" for k, v in worst.items())
             + f" ({time.perf_counter() - t_ref:.3f} s; the program's state "
             f"freed in {t_ref - t_free:.3f} s)")
    checks = [[k, worst[k], ctx.limit(k)] for k in ctx.cell["limits"]]
    return common.Outcome(e2e=e2e, counters=counters, checks=checks,
                          attempted=K * steps, failed=0,
                          memory_peak_bytes=mem, trace=prof.trace)
