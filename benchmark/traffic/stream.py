"""Traffic kind ``stream``: online mapping as the paper runs it.

Set-up writes a ReplicaCAD-format sequence from the seed (sequence.py)
into the run's scratch directory and builds a Trainer of the
configuration over it with the benchmark's weights. The window drives the
port's ``engine/loop.py::train_loop`` unchanged: ingestion through the
port's reader, keyframe decisions, 10- and 60-step bundles, the sim clock
unpinned, evals and saves off.

The window opens at the first ``control_hook`` call once ``warm_s``
seconds have passed since the loop's opening bundle (a run-in: the card
reads slow for its first seconds under load) and a bundle has run over
more than a window of keyframes, so that the step's window-selection
graph key is captured. Just before it opens, the compared steps are taken
there, through the loop's own ``run_steps`` at the window's graph key and
batch: the arena as the loop filled it, the parameters set to the
benchmark's weights, the optimiser and the priorities to their start;
then the loop's state is copied back in place and the window opens. The
hook ends the window once ``--seconds`` have passed. Every bundle of steps
in the window (``fns.train_bundle``, the call the sim clock times) is timed
by the benchmark's own CUDA-event pair. Once the window has closed, the
arena's depth rows and poses, at the check and at the close, are held
exactly against the views the benchmark wrote for their frame ids, and the
reference redoes the compared steps over those views.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

import numpy as np
import torch

from benchmark import common
from benchmark import inputs as I
from benchmark import reference as REF
from benchmark import sequence as SEQ
from benchmark import trainers as TR
from benchmark.trace import Profiler
from benchmark.window import EventPairs, sync, train_op


class _Stop(Exception):
    """Raised by the control hook to end the window."""


class _Spanned:
    """The trainer's dataset with a span around each frame read."""

    def __init__(self, ds, prof):
        self._ds, self._prof = ds, prof

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        with self._prof.span("bench.read_frame"):
            return self._ds[i]

    def __getattr__(self, name):
        return getattr(self._ds, name)


def run(ctx, keep: dict = None) -> common.Outcome:
    """One run; ``keep`` (calibrate.py) receives the compared readings and
    a maker of the reference at a given precision."""
    from isdf_tpu_torch.engine.loop import train_loop

    cfg = ctx.config()
    p = ctx.params
    dev = ctx.device
    fps = float(cfg["dataset"]["fps"])
    scale = float(cfg["dataset"]["depth_scale"])
    distinct = int(p["distinct"])
    # the sim clock bills device time only, so the camera runs no faster
    # than the wall: this many frames outlast set-up and the window
    n_frames = int(fps * (ctx.seconds + float(p["lead_s"])))
    tr, layers, depth_u16, poses, cam, gt = build(ctx, cfg, distinct,
                                                  n_frames)
    c = tr.cfg

    prof = Profiler(ctx.trace, ctx.scratch)
    if ctx.trace:
        tr.dataset = _Spanned(tr.dataset, prof)
    for method, name in (("get_data", "bench.get_data"),
                         ("check_keyframe_latest", "bench.kf_check"),
                         ("add_frame", "bench.add_frame"),
                         ("run_steps", "bench.run_steps")):
        prof.wrap(tr, method, name)

    ev = EventPairs(dev)
    ev.on = False
    ev.around(tr.fns, "train_bundle")
    state = {"open": False, "t0": None, "steps0": 0, "ready": False,
             "warm": None}
    inner = tr.run_steps
    seconds = (min(ctx.seconds, float(p["trace_seconds"])) if ctx.trace
               else ctx.seconds)

    def run_steps(n):
        ready = tr.buffer.count > c.window_size
        out = inner(n)
        if state["warm"] is None:    # the loop's opening bundle
            state["warm"] = time.perf_counter() + float(p.get("warm_s", 0))
        state["ready"] = state["ready"] or ready
        return out

    tr.run_steps = run_steps
    stack = contextlib.ExitStack()

    def hook():
        if state["open"]:
            wall = time.perf_counter() - state["t0"]
            if wall >= seconds:
                state["wall"] = wall
                raise _Stop
        elif state["ready"] and time.perf_counter() >= state["warm"]:
            t = time.perf_counter()
            state["first"], state["ids"] = _compared_steps(tr, inner, cfg,
                                                           layers)
            state["gap0"] = _arena_gap(tr, depth_u16, poses, scale,
                                       c.max_depth, distinct)
            ctx.note(f"set-up: compared steps over {len(state['ids'])} "
                     f"keyframes in {time.perf_counter() - t:.3f} s")
            sync(dev)
            state["setup_s"] = time.perf_counter() - ctx.t_process
            stack.enter_context(prof.window(lambda: sync(dev)))
            ev.on = True
            state.update(open=True, t0=time.perf_counter(),
                         steps0=tr.steps_taken, kf0=tr.buffer.count)
        return {}

    try:
        train_loop(tr, max_steps=1 << 40, extra_opt_steps=0,
                   control_hook=hook)
        raise RuntimeError("the sequence ended before the window closed")
    except _Stop:
        pass
    stack.close()
    wall = state["wall"]
    if prof.trace is not None:
        ctx.note("host split: " + host_split(prof.trace))
    steps = tr.steps_taken - state["steps0"]
    billed = ev.seconds()
    ctx.note(f"window: {steps} steps in {len(ev.pairs)} bundles, "
             f"{wall:.4f} s wall, billed {billed:.6f} s; "
             f"{steps / wall:.2f} steps/s of wall; frame "
             f"{tr.get_latest_frame_id()} of {n_frames}; keyframes "
             f"{state['kf0']} -> {tr.buffer.count}")
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    arena = max(state["gap0"], _arena_gap(tr, depth_u16, poses, scale,
                                          c.max_depth, distinct))
    fs, ids, setup_s = state["first"], state["ids"], state["setup_s"]
    tr = inner = None
    state.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def ref(prec, half_batch=False):
        return reference(ctx, cfg, layers, depth_u16, poses, cam, gt, ids,
                         prec, half_batch)

    vals = REF.compare_first_steps(ref(TR.stated_precision(cfg)), fs.losses,
                                   fs.grad0, fs.delta)
    vals["arena_gap"] = arena
    ctx.note("reference: " + " ".join(f"{k} {v!r}" for k, v in vals.items()))
    if keep is not None:
        keep.update(vals=vals, reference=ref)
    checks = [[k, vals[k], ctx.limit(k)] for k in ctx.cell["limits"]]
    counters = {"steps": steps, "scenes": 1, "wall_s": wall,
                "billed_s": billed, "train_op": train_op(cfg)}
    e2e = {"step_ms": 1e3 * billed / max(steps, 1), "setup_s": setup_s}
    return common.Outcome(e2e=e2e, counters=counters, checks=checks,
                          attempted=steps, failed=0, memory_peak_bytes=mem,
                          trace=prof.trace)


def _compared_steps(tr, run_steps, cfg, layers):
    """The first three steps from the benchmark's weights over the arena
    as the loop has filled it, through ``run_steps`` at the loop's graph
    key: the parameters set to the weights, the optimiser's state and the
    arena's priorities to their start, the step counter to 0 and the noise
    to a frame's; the loop's state is copied back afterwards, in place.
    -> (the readings, the arena's frame ids)."""
    from isdf_tpu_torch.models import sdf_mlp as M

    mp = REF.Map(cfg)
    loop = TR.snapshot(tr)
    kept = (tr.noise_std, tr.lr_scale, tr.tail_mode)
    init = M.params_from_jax(I.as_tree(layers, mp.blocks), tr.model,
                             device=tr.device)
    for k, v in tr.params.items():
        v.copy_(init[k])
    for x in TR.stepped_tensors(tr)[len(tr.params):]:
        x.zero_()
    tr.steps_taken = 0
    tr.noise_std = float(cfg["model"]["noise_frame"])
    tr.lr_scale, tr.tail_mode = 1.0, False
    fs = TR.first_steps(lambda n: [run_steps(n)["total_loss"].tolist()],
                        [tr], mp)[0]
    TR.restore(tr, loop)
    tr.noise_std, tr.lr_scale, tr.tail_mode = kept
    return fs, tr.buffer.frame_id[:tr.buffer.count].cpu().numpy().copy()


def build(ctx, cfg, distinct: int, n_frames: int):
    """Write the seed's sequence and build a Trainer over it with the
    benchmark's weights (``cfg`` gets the sequence's paths) -> (trainer,
    weights, stored depth [distinct, H, W] uint16, poses, camera, GT
    directory)."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import fused_adamw
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.utils.config import config_from_dict

    dev = ctx.device
    mp = REF.Map(cfg)
    ds = cfg["dataset"]
    cam = dict(H=int(ds["camera"]["h"]), W=int(ds["camera"]["w"]),
               fx=float(ds["camera"]["fx"]), fy=float(ds["camera"]["fy"]),
               cx=float(ds["camera"]["cx"]), cy=float(ds["camera"]["cy"]))
    room = I.Room(ctx.seed)
    t = time.perf_counter()
    seq, gt, depth_u16, poses = SEQ.write(
        os.path.join(ctx.scratch, "data"), room, ctx.seed, cam, distinct,
        n_frames, float(ds["depth_scale"]), dev)
    ctx.note(f"set-up: wrote {distinct} views ({n_frames} frames) in "
             f"{time.perf_counter() - t:.3f} s")
    ds.update(seq_dir=seq, gt_sdf_dir=gt)
    tr = Trainer(config_from_dict(cfg), seed=ctx.seed, device=dev)
    layers = I.make_weights(ctx.seed, mp.E, mp.H, mp.blocks, dev)
    tr.params = M.params_from_jax(I.as_tree(layers, mp.blocks), tr.model,
                                  device=dev)
    tr.frozen_params = M.copy_params(tr.params)
    tr.opt_state = fused_adamw.init_state(tr.params)
    return tr, layers, depth_u16, poses, cam, gt


def host_split(trace) -> str:
    """ms a call of each host span of the loop's thread in a traced window,
    and the card's idle share over the window."""
    parts = []
    for name in ("bench.read_frame", "bench.get_data", "bench.kf_check",
                 "bench.add_frame", "bench.run_steps"):
        d = [x for _, x, n in trace.spans if n == name]
        if d:
            parts.append(f"{name[6:]} {1e-3 * sum(d) / len(d):.3f} ms x "
                         f"{len(d)}")
    return ", ".join(parts) + f"; card idle {100 * trace.idle_share():.2f}%"


def reference(ctx, cfg, layers, depth_u16, poses, cam, gt, ids, prec,
              half_batch=False) -> REF.RefStep:
    """The reference of the compared steps: the views the benchmark wrote
    for the arena's frame ids, in its order, in the scene frame of the GT
    mesh's PCA box."""
    ds = cfg["dataset"]
    max_depth = float(cfg["sample"]["depth_range"][1])
    dev = ctx.device
    views = np.asarray(ids) % depth_u16.shape[0]
    depth = np.stack([_depth_m(depth_u16[v], float(ds["depth_scale"]),
                               max_depth) for v in views])
    return REF.RefStep(
        cfg, layers, torch.as_tensor(depth, device=dev),
        torch.as_tensor(poses[views], device=dev), cam,
        torch.as_tensor(REF.scene_transform(os.path.join(gt, "mesh.obj")),
                        device=dev),
        ctx.seed, prec=prec, half_batch=half_batch,
        capacity=int(cfg["tpu"]["kf_buffer_size"]))


def _depth_m(u16, scale, max_depth):
    """The depth in metres that the reader makes of a stored view."""
    d = u16.astype(np.float32) * (1.0 / scale)
    d[d > max_depth] = 0.0
    return d


def _arena_gap(tr, depth_u16, poses, scale, max_depth, distinct) -> float:
    """The largest gap between the arena's keyframes (depth rows and
    poses) and the views the benchmark wrote for their frame ids."""
    n = tr.buffer.count
    ids = tr.buffer.frame_id[:n].cpu().numpy()
    gap = 0.0
    for row, fid in enumerate(ids):
        want = torch.as_tensor(_depth_m(depth_u16[fid % distinct], scale,
                                        max_depth), device=tr.device)
        gap = max(gap, float((tr.buffer.depth[row] - want).abs().max()))
        gap = max(gap, float(np.abs(tr.buffer.T_WC[row].cpu().numpy()
                                    - poses[fid % distinct]).max()))
    return gap
