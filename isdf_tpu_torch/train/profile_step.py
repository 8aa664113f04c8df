#!/usr/bin/env python
"""Where the time of a training step goes on the card.

    python -m isdf_tpu_torch.train.profile_step [SECTION.KEY=VALUE ...]

Runs the online trainer on train/configs/synthetic.json with the given
config overrides, e.g. tpu.pe_in_kernel=false tpu.use_pallas=true (Trainer
+ train_loop, simulated clock pinned at 1/300 s per step) for 300 steps, then
times 200 more steps of the steady training bundle (Trainer.run_steps, 10
steps per call) twice: once bare, once under torch.profiler tracing the
card only. Prints the host-clock time per step of both (the difference is
what tracing costs), the device time per step from the trainer's CUDA
events, and, read from the exported trace, the kernels by device time and
the device's idle share: 1 - (union of kernel intervals) / (first kernel
start to last kernel end).
"""

from __future__ import annotations

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
    import sys

    from torch.profiler import ProfilerActivity, profile

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    overrides = list(sys.argv[1:] if argv is None else argv)
    tr = Trainer(load_config(CONFIG, overrides=overrides or None), seed=1)
    tr._per_step_device_s = 1.0 / 300
    tr._bill_exact = True
    train_loop(tr, max_steps=WARMUP,
               eval_hook=lambda t: {"sdf_mae": t.dataset.sdf_mae(t.sdf_fn)})
    n_calls = STEPS // BUNDLE

    def timed():
        torch.cuda.synchronize()
        dev0, t0 = tr.measured_s, time.perf_counter()
        for _ in range(n_calls):
            tr.run_steps(BUNDLE)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tr.measured_s - dev0

    tr.run_steps(BUNDLE)
    wall_bare, dev = timed()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_traced, _ = timed()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        ivs = kernel_intervals(path)

    print(f"card: {torch.cuda.get_device_name(0)}; overrides: {overrides}")
    print(f"steps timed: {STEPS} in bundles of {BUNDLE}")
    print(f"host wall per step, bare: {1e3 * wall_bare / STEPS:.4f} ms")
    print(f"host wall per step, traced: {1e3 * wall_traced / STEPS:.4f} ms")
    print(f"device time per step (CUDA events around bundles, bare): "
          f"{1e3 * dev / STEPS:.4f} ms")
    if not ivs:
        print("the trace holds no device kernels")
        return
    by_name = defaultdict(lambda: [0.0, 0])
    for _, dur, name in ivs:
        by_name[name][0] += dur
        by_name[name][1] += 1
    kernel_us = sum(v[0] for v in by_name.values())
    window = max(s + d for s, d, _ in ivs) - min(s for s, _, _ in ivs)
    print(f"kernel time per step: {kernel_us / 1e3 / STEPS:.4f} ms; "
          f"kernels per step: {len(ivs) / STEPS:.1f}")
    print(f"traced device window per step: {window / 1e3 / STEPS:.4f} ms; "
          f"idle share: {1.0 - busy_us(ivs) / window:.4f}")
    print(f"{'device ms/step':>14} {'share':>7} {'calls/step':>10}  kernel")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :20]:
        print(f"{us / 1e3 / STEPS:14.4f} {us / kernel_us:7.4f} "
              f"{cnt / STEPS:10.2f}  {name[:90]}")


if __name__ == "__main__":
    main()
