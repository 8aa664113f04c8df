"""Rolling step-time statistics (the reference GUI's 20-second compute
balance readout, isdf_window.py:694-708)."""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict


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
