#!/usr/bin/env python
"""Split the bill of chip_smoke.py phase 12's runs by part, on the card.

    python -m tools.serve_bill_split [PAIRS]     (from the repo's root)

Runs the phase's cold plain run, then PAIRS (default 4) pairs of a plain
run and a watched run (train_vis --serve --serve-queries with the client
process), as chip_smoke.py's _plain_vis_run and _watched_once make them.
Per run it prints one line ``split {...}``: the billed ms (the sum of the
bundles' CUDA-event spans, Trainer.run_steps), the graphs' set-up in host
ms (GraphRunner.warm per call, capture_s), and per bundle the lead, the
span from the bundle's start event to an event recorded just before its
first graph replay (the prologue, and in a bundle that captures, the
warm-up and the capture), and the span from there to the stop event.
The SM clock and the throttle reasons, sampled by nvidia-smi every
100 ms over the run, are printed beside them.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS  # noqa: E402  (light at import: torch loads in main)

BUNDLES, CUR, SMI = [], {}, []


def instrument():
    """Wrap the trainer's bundle clock and a captured graph's replay."""
    import torch

    from isdf_tpu_torch.engine import trainer as TRM
    from isdf_tpu_torch.utils import graphs as G
    from isdf_tpu_torch.utils import profiling as PR

    class Clock(PR.BundleClock):
        def __init__(self, device, others=()):
            super().__init__(device, others)
            CUR.clear()
            CUR.update(clock=self, first=None)

        def stop(self):
            super().stop()
            BUNDLES.append(dict(CUR))

    replay = G.Captured.replay

    def first_marked(self, times=1):
        if "clock" in CUR and CUR["first"] is None:
            CUR["first"] = torch.cuda.Event(enable_timing=True)
            CUR["first"].record()
        return replay(self, times)

    TRM.BundleClock = Clock
    G.Captured.replay = first_marked


def sample_clocks(stop):
    p = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks_throttle_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    for line in p.stdout:
        SMI.append((time.perf_counter(), line.strip()))
        if stop.is_set():
            break
    p.terminate()
    p.wait()


def split(label, tr, t0, t1):
    import torch
    torch.cuda.synchronize()
    total, leads, spans = 0.0, [], []
    for b in BUNDLES:
        start, stop = b["clock"]._ev
        total += start.elapsed_time(stop)
        if b["first"] is not None:
            leads.append(start.elapsed_time(b["first"]))
            spans.append(b["first"].elapsed_time(stop))
    BUNDLES.clear()
    st = tr.fns.graphs.stats
    seen = [s.split(",") for t, s in SMI if t0 <= t <= t1]
    sm = sorted(int(c) for c, _ in seen)
    print("split " + json.dumps(dict(
        run=label, bundles=len(leads), billed_ms=total,
        per_step_ms=total / CS.VIS_STEPS,
        warm_ms=1e3 * st["warm_s"], capture_ms=1e3 * st["capture_s"],
        less_setup_per_step_ms=(total - 1e3 * (st["warm_s"]
                                               + st["capture_s"]))
        / CS.VIS_STEPS,
        lead_ms=sum(leads), leads_over_1ms=[x for x in leads if x > 1],
        after_first_replay_ms=sum(spans), largest_span_ms=max(spans),
        sm_clock_min_median_max=(sm[0], sm[len(sm) // 2], sm[-1])
        if sm else None,
        throttle=sorted({r.strip() for _, r in seen}))), flush=True)


def main():
    import torch

    from isdf_tpu_torch.utils import nvcc
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    instrument()
    print(CS.card_line(), flush=True)
    nvcc.load_all(CS.SOURCES)
    stop = threading.Event()
    th = threading.Thread(target=sample_clocks, args=(stop,), daemon=True)
    th.start()
    with tempfile.TemporaryDirectory() as root:
        for i in range(-1, pairs):
            gc.collect()
            t = time.perf_counter()
            p, _, _ = CS._plain_vis_run(torch, root, f"plain_{i}")
            split("cold" if i < 0 else f"plain {i}", p, t,
                  time.perf_counter())
            del p
            if i < 0:
                continue
            gc.collect()
            t = time.perf_counter()
            _, tr, web = CS._watched_once(torch, root, f"watched_{i}")
            split(f"watched {i}", tr, t, time.perf_counter())
            del tr, web
    stop.set()
    th.join(timeout=5)


if __name__ == "__main__":
    main()
