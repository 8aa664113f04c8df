"""Tracing and rolling step-time statistics (isdf_tpu/utils/profiling.py):
a torch.profiler trace context, and the reference GUI's 20-second compute
balance readout (isdf_window.py:694-708)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Dict


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block, the CPU and (where there is one) the
    CUDA device; writes a Chrome trace, ``trace.json`` in ``log_dir``,
    when the block ends. Yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling window of per-bundle timings, like the reference GUI's
    20-second compute-balance readout (isdf_window.py:694-708)."""

    def __init__(self, window_s: float = 20.0):
        self.window_s = window_s
        self.events: Deque = deque()

    def add(self, kind: str, seconds: float, steps: int = 0):
        now = time.perf_counter()
        self.events.append((now, kind, seconds, steps))
        cutoff = now - self.window_s
        while self.events and self.events[0][0] < cutoff:
            self.events.popleft()

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        steps = 0
        for _, kind, sec, st in self.events:
            out[kind] = out.get(kind, 0.0) + sec
            steps += st
        total = sum(out.values())
        if total > 0:
            out["steps_per_sec"] = steps / total
        return out
