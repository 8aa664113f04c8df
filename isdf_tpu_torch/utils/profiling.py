"""Tracing, bundle timing and rolling step-time statistics
(isdf_tpu/utils/profiling.py): a torch.profiler trace context, the clock
that times a bundle on its device, and the reference GUI's 20-second
compute balance readout (isdf_window.py:694-708)."""

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


class BundleClock:
    """The measured time of a bundle of launches: CUDA events recorded
    around them on the card's stream (the reference's own timing,
    isdf/eval/metrics.py:13-38), the host's wall clock on the CPU.

    Start it before the launches, ``stop()`` after them, and read
    ``seconds()`` once a fetch of the bundle's results has synced."""

    def __init__(self, device):
        import torch
        self._ev = None
        if device.type == "cuda":
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._ev is not None:
            self._ev[1].record()

    def seconds(self) -> float:
        if self._ev is not None:
            return self._ev[0].elapsed_time(self._ev[1]) * 1e-3
        return time.perf_counter() - self._t0


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
