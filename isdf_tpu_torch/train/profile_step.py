#!/usr/bin/env python
"""Where the time of a training step goes on the card.

    python -m isdf_tpu_torch.train.profile_step [--scenes K] \
        [--devices DEV,DEV,...] [SECTION.KEY=VALUE ...]

Steps K copies of train/configs/synthetic.json with the given config
overrides, e.g. tpu.pe_in_kernel=false tpu.use_pallas=true, scene i with
seed 1 + i, in lockstep through parallel/multi_scene.py (K = 1: one
trainer, the same launches as Trainer.run_steps). ``--devices`` gives each
trainer the mesh of tpu.data_parallel (``cuda:0,cuda:0`` with
tpu.data_parallel=2: two shards on one card). The simulated clock is
pinned at 1/300 s per step. After 300 steps of multi_scene_loop it times
20 more rounds of 10 steps per scene (MultiSceneStepper.run_steps) twice:
once bare, once under torch.profiler tracing the card only. Prints, per
round and per scene-step, the host-clock time of both (the difference is
what tracing costs), the billed device time (the stepper's CUDA events,
the trainers' ``measured_s``) and, read from the exported trace, the
kernels by device time and the device's idle share inside the stepper's
rounds: 1 - (union of the device operations inside the program's
``fleet.round`` spans, utils/profiling.py) / (the spans' time), a round
holding its bundles, the scalars' fetch and the bill; also the CUDA graph
replays and captures (engine/step.py), and the peak memory.

The steps run as replays of captured CUDA graphs, the trainers' route on
the card. ``profile()`` returns the readings for chip_smoke.py; its
``eager=True`` runs the plain loop of steps instead (the yardstick).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "synthetic.json")
WARMUP, STEPS, BUNDLE = 300, 200, 10


def kernel_intervals(trace_path, cats=("kernel",)):
    """[(start_us, dur_us, name)] of the device kernels (``cats``: the
    device events of those categories) in a Chrome trace that
    torch.profiler exported."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["dur"]), e["name"]) for e in events
            if e.get("cat") in cats and e.get("ph") == "X"]


def busy_us(intervals):
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, d, _ in sorted(intervals):
        if s + d > end:
            total += s + d - max(s, end)
            end = s + d
    return total


def idle_within(intervals, spans):
    """1 - (union of the intervals inside the spans) / (the spans' time);
    None without spans."""
    total = sum(s.t1 - s.t0 for s in spans)
    if total <= 0:
        return None
    busy = sum(busy_us([(max(a, s.t0), min(a + d, s.t1) - max(a, s.t0), n)
                        for a, d, n in intervals if a < s.t1 and a + d > s.t0])
               for s in spans)
    return 1.0 - busy / total


def profile(overrides=(), scenes: int = 1, eager: bool = False,
            warmup: int = WARMUP, steps: int = STEPS, bundle: int = BUNDLE,
            devices=None):
    """Readings of K = ``scenes`` trainers stepped in lockstep, ``steps``
    steps per scene timed after ``warmup``: host wall (bare and traced),
    billed device time, kernel time, kernels and graph replays per
    scene-step, the idle share of the traced window, peak memory, the
    captures and their seconds, and the kernels by device time (a dict).
    ``devices``: each trainer's device argument (a list: its dp mesh)."""
    from torch.profiler import ProfilerActivity, profile as trace

    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.parallel.multi_scene import (MultiSceneStepper,
                                                     multi_scene_loop)
    from isdf_tpu_torch.utils import profiling
    from isdf_tpu_torch.utils.config import load_config

    K = scenes
    cfg = load_config(CONFIG, overrides=list(overrides) or None)
    torch.cuda.reset_peak_memory_stats()
    trainers = [Trainer(cfg, seed=1 + i, eager=eager, device=devices)
                for i in range(K)]
    stepper = MultiSceneStepper(trainers)
    stepper._per_step_device_s = 1.0 / 300
    multi_scene_loop(trainers, max_steps=warmup, stepper=stepper)
    n_calls = steps // bundle
    n = K * n_calls * bundle   # scene-steps timed

    def replays():
        return sum(t.fns.graphs.stats["replays"] for t in trainers
                   if t.fns.graphs is not None)

    def timed():
        torch.cuda.synchronize()
        dev0, r0, t0 = stepper.measured_s, replays(), time.perf_counter()
        for _ in range(n_calls):
            stepper.run_steps(bundle)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, stepper.measured_s - dev0,
                replays() - r0)

    stepper.run_steps(bundle)
    wall_bare, dev, n_replays = timed()
    profiling.clear()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        wall_traced, _, _ = timed()
    rounds = [s for s in profiling.recorded() if s.name == "fleet.round"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        ivs = kernel_intervals(path)
        ops = kernel_intervals(path, ("kernel", "gpu_memcpy", "gpu_memset"))
    stats = [t.fns.graphs.stats for t in trainers if t.fns.graphs]
    out = dict(
        card=torch.cuda.get_device_name(0), scenes=K, eager=eager,
        overrides=list(overrides), scene_steps=n, bundle=bundle,
        host_ms_bare=1e3 * wall_bare / n, host_ms_traced=1e3 * wall_traced / n,
        billed_device_ms=1e3 * dev / n, replays_per_step=n_replays / n,
        captures=sum(s["captures"] for s in stats),
        capture_s=sum(s["capture_s"] for s in stats),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        kernels_per_step=len(ivs) / n, kernel_ms=None, idle_share=None,
        by_kernel={})
    if ivs:
        by_name = defaultdict(lambda: [0.0, 0])
        for _, dur, name in ivs:
            by_name[name][0] += dur
            by_name[name][1] += 1
        out.update(
            kernel_ms=sum(v[0] for v in by_name.values()) / 1e3 / n,
            idle_share=idle_within(ops, rounds),
            by_kernel={k: (v[0] / 1e3 / n, v[1] / n)
                       for k, v in by_name.items()})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", type=int, default=1,
                        help="copies of the config stepped in lockstep")
    parser.add_argument("--devices", type=str, default=None,
                        metavar="DEV,DEV,...",
                        help="each trainer's device, or its data-parallel "
                             "mesh (with tpu.data_parallel)")
    parser.add_argument("overrides", nargs="*", metavar="SECTION.KEY=VALUE")
    args = parser.parse_args(argv)
    from isdf_tpu_torch.parallel.mesh import parse_devices
    r = profile(args.overrides, scenes=args.scenes,
                devices=parse_devices(args.devices))
    n, rounds = r["scene_steps"], STEPS // BUNDLE
    K = r["scenes"]
    print(f"card: {r['card']}; scenes: {K}; overrides: {args.overrides}; "
          f"route: CUDA graphs")
    print(f"timed: {rounds} rounds of {BUNDLE} steps per scene "
          f"({n} scene-steps)")
    for what, key in (("host wall, bare", "host_ms_bare"),
                      ("host wall, traced", "host_ms_traced"),
                      ("billed device time (CUDA events around rounds, "
                       "bare)", "billed_device_ms")):
        print(f"{what}: {r[key] * n / rounds:.4f} ms per round, "
              f"{r[key]:.4f} ms per scene-step")
    print(f"graph replays: {r['replays_per_step']:.2f} per scene-step; "
          f"captures: {r['captures']} in {r['capture_s']:.3f} s")
    print(f"max memory allocated: {r['peak_memory_gb']:.3f} GB")
    if r["kernel_ms"] is None:
        print("the trace holds no device kernels")
        return
    print(f"kernel time: {r['kernel_ms'] * n / rounds:.4f} ms per round, "
          f"{r['kernel_ms']:.4f} ms per scene-step; kernels: "
          f"{r['kernels_per_step'] * n / rounds:.1f} per round, "
          f"{r['kernels_per_step']:.1f} per scene-step")
    idle = r["idle_share"]
    print(f"device kernels and graph replays are counted apart; idle share "
          f"inside the rounds (traced): "
          + ("no fleet.round span recorded" if idle is None
             else f"{idle:.4f}"))
    print(f"{'device ms/step':>14} {'share':>7} {'calls/step':>10}  kernel")
    for name, (ms, cnt) in sorted(r["by_kernel"].items(),
                                  key=lambda kv: -kv[1][0])[:20]:
        print(f"{ms:14.4f} {ms / r['kernel_ms']:7.4f} {cnt:10.2f}  "
              f"{name[:90]}")


if __name__ == "__main__":
    main()
