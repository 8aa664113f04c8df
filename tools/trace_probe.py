#!/usr/bin/env python
"""How often a torch.profiler trace of the card loses kernel events, and
where in the trace the lost ones lie.

    python -m tools.trace_probe [--traces N]     (from the repo's root)

chip_smoke.py times a kernel from a trace of back-to-back calls and
requires one traced launch of each device kernel a call. This script
builds the kernels, takes the wrappers' timed calls from chip_smoke.py's
phase 2 (K4, K2 and K1-pc-f32, at the trainer's shapes), and traces each
N times in each of four ways:

* plain: a profile() around the calls and a synchronize;
* padded: the same with 20 ms of host sleep before the first call and
  after the synchronize, inside the profile;
* warmup: a profiler schedule of one warm-up step (one call) and one
  active step (the calls), the documented way to let CUPTI settle;
* shipped: chip_smoke.traced_kernels, the instrument as it stands
  (padded, at chip_smoke.TRACE_PAD_S).

Per way and kernel it prints the traces that came back short, the
launches lost, and for each short trace where they were lost: inside the
run (a gap in the CUPTI correlation ids, which advance by the same step a
call) or at its edges (the first or last calls missing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("K4", "K2", "K1-pc-f32")


def _kernel_events(torch, prof):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"
            and e.get("ph") == "X"]


def trace(torch, way, fn, reps):
    """The kernel events of ``reps`` calls of ``fn`` traced one way."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    if way == "warmup":
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        return _kernel_events(torch, prof)
    pad = 0.02 if way == "padded" else 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return _kernel_events(torch, prof)


def where_lost(events, name, reps):
    """(launches lost inside the run, at its edges) of device kernel
    ``name``, from the step of the correlation ids between calls."""
    ids = sorted(e["args"]["correlation"] for e in events
                 if name in e["name"] and "correlation" in e.get("args", {}))
    lost = reps - len(ids)
    if len(ids) < 2:
        return 0, lost
    steps = [b - a for a, b in zip(ids, ids[1:])]
    step = Counter(steps).most_common(1)[0][0]
    inside = sum(max(round(s / step) - 1, 0) for s in steps)
    return inside, lost - inside


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=40)
    args = parser.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from isdf_tpu_torch.utils import nvcc
    print(C.card_line(), f"; torch {torch.__version__}", flush=True)
    nvcc.load_all(("bounds_pc", "reverse_fused", "train_mlp_f32"))
    fns = {}
    shipped_device_ms = C.device_ms

    def capture(torch_, name, fn, reps):
        fns[name] = (fn, reps)
        return 0.0, {k: 0.0 for k in C.KERNEL_NAMES[name]}

    C.device_ms = capture
    s = C.Setup(torch)
    for name in KERNELS:
        C.check(torch, s, name)
    C.device_ms = shipped_device_ms
    ways = ("plain", "padded", "warmup", "shipped")
    for name in KERNELS:
        fn, reps = fns[name]
        tally = {w: Counter() for w in ways}
        for _ in range(args.traces):  # the ways in turn
            for way in ways:
                t0 = time.perf_counter()
                if way == "shipped":
                    events = [dict(name=n, args={}) for _, _, n in
                              C.traced_kernels(torch, fn, reps)]
                else:
                    events = trace(torch, way, fn, reps)
                t = tally[way]
                t["seconds"] += time.perf_counter() - t0
                for k in C.KERNEL_NAMES[name]:
                    n = sum(k in e["name"] for e in events)
                    if n == reps:
                        continue
                    t["short"] += 1
                    t["lost"] += reps - n
                    if way != "shipped":
                        inside, edges = where_lost(events, k, reps)
                        t["inside"] += inside
                        t["edges"] += edges
                    print(f"  {name} [{way}]: {n} of {reps} launches of "
                          f"{k}", flush=True)
        for way, t in tally.items():
            print(f"{name} [{way}]: {args.traces} traces of {reps} calls: "
                  f"{t['short']} short, {t['lost']} launches lost "
                  f"({t['inside']} inside the run, {t['edges']} at its "
                  f"edges); {t['seconds']:.1f} s", flush=True)

if __name__ == "__main__":
    main()
