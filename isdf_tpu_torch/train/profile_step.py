#!/usr/bin/env python
"""Where the time of a training step goes on the card.

    python -m isdf_tpu_torch.train.profile_step [--scenes K] \
        [SECTION.KEY=VALUE ...]

Steps K copies of train/configs/synthetic.json with the given config
overrides, e.g. tpu.pe_in_kernel=false tpu.use_pallas=true, scene i with
seed 1 + i, in lockstep through parallel/multi_scene.py (K = 1: one
trainer, the same launches as Trainer.run_steps). The simulated clock is
pinned at 1/300 s per step. After 300 steps of multi_scene_loop it times
20 more rounds of 10 steps per scene (MultiSceneStepper.run_steps) twice:
once bare, once under torch.profiler tracing the card only. Prints, per
round and per scene-step, the host-clock time of both (the difference is
what tracing costs), the device time from the stepper's CUDA events and,
read from the exported trace, the kernels by device time and the device's
idle share: 1 - (union of kernel intervals) / (first kernel start to last
kernel end).
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


def kernel_intervals(trace_path):
    """[(start_us, dur_us, name)] of the device kernels in a Chrome trace
    that torch.profiler exported."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["dur"]), e["name"]) for e in events
            if e.get("cat") == "kernel" and e.get("ph") == "X"]


def busy_us(intervals):
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, d, _ in sorted(intervals):
        if s + d > end:
            total += s + d - max(s, end)
            end = s + d
    return total


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile

    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.parallel.multi_scene import (MultiSceneStepper,
                                                     multi_scene_loop)
    from isdf_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", type=int, default=1,
                        help="copies of the config stepped in lockstep")
    parser.add_argument("overrides", nargs="*", metavar="SECTION.KEY=VALUE")
    args = parser.parse_args(argv)
    K = args.scenes
    cfg = load_config(CONFIG, overrides=args.overrides or None)
    trainers = [Trainer(cfg, seed=1 + i) for i in range(K)]
    stepper = MultiSceneStepper(trainers)
    stepper._per_step_device_s, stepper._bill_exact = 1.0 / 300, True
    multi_scene_loop(trainers, max_steps=WARMUP, stepper=stepper)
    n_calls = STEPS // BUNDLE
    steps = K * STEPS   # scene-steps timed

    def timed():
        torch.cuda.synchronize()
        dev0, t0 = stepper.measured_s, time.perf_counter()
        for _ in range(n_calls):
            stepper.run_steps(BUNDLE)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, stepper.measured_s - dev0

    stepper.run_steps(BUNDLE)
    wall_bare, dev = timed()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_traced, _ = timed()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        ivs = kernel_intervals(path)

    print(f"card: {torch.cuda.get_device_name(0)}; scenes: {K}; "
          f"overrides: {args.overrides}")
    print(f"timed: {n_calls} rounds of {BUNDLE} steps per scene "
          f"({steps} scene-steps)")
    for what, v in (("host wall, bare", wall_bare),
                    ("host wall, traced", wall_traced),
                    ("device time (CUDA events around rounds, bare)", dev)):
        print(f"{what}: {1e3 * v / n_calls:.4f} ms per round, "
              f"{1e3 * v / steps:.4f} ms per scene-step")
    print(f"max memory allocated: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if not ivs:
        print("the trace holds no device kernels")
        return
    by_name = defaultdict(lambda: [0.0, 0])
    for _, dur, name in ivs:
        by_name[name][0] += dur
        by_name[name][1] += 1
    kernel_us = sum(v[0] for v in by_name.values())
    window = max(s + d for s, d, _ in ivs) - min(s for s, _, _ in ivs)
    print(f"kernel time: {kernel_us / 1e3 / n_calls:.4f} ms per round, "
          f"{kernel_us / 1e3 / steps:.4f} ms per scene-step; kernels: "
          f"{len(ivs) / n_calls:.1f} per round, {len(ivs) / steps:.1f} per "
          f"scene-step")
    print(f"traced device window per round: {window / 1e3 / n_calls:.4f} "
          f"ms; idle share: {1.0 - busy_us(ivs) / window:.4f}")
    print(f"{'device ms/step':>14} {'share':>7} {'calls/step':>10}  kernel")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :20]:
        print(f"{us / 1e3 / steps:14.4f} {us / kernel_us:7.4f} "
              f"{cnt / steps:10.2f}  {name[:90]}")


if __name__ == "__main__":
    main()
