"""The benchmark's tracing: host spans around the calls into each layer,
and the reduction of a torch.profiler trace of the card to busy time,
idle gaps and device time by kernel.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<what>``
so that they land in the profiler's trace on the same clock as the card's
kernels. They are recorded only in traced runs: ``wrap`` puts one around a
method of an object the benchmark built, never in the program's code.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from collections import defaultdict
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host time on either side of the traced window: the profiler loses
# launches at the very edges of a trace
PAD_S = 0.02


class Trace:
    """A reduced trace: the window [t0, t1) in us, the device operations
    [(start, dur, name)] that overlap it, clipped to it, and the host spans
    [(start, dur, name)] recorded inside it."""

    def __init__(self, t0: float, t1: float, ops, spans):
        self.t0, self.t1 = t0, t1
        self.ops: List[Tuple[float, float, str]] = ops
        self.spans: List[Tuple[float, float, str]] = spans

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self, ops=None) -> float:
        return union_us(self.ops if ops is None else ops) * 1e-6

    def idle_share(self) -> float:
        """1 - (union of device operations) / (the window's span)."""
        return 1.0 - union_us(self.ops) / max(self.t1 - self.t0, 1e-9)

    def op_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches the
        regular expression ``pattern`` as a whole word."""
        rx = re.compile(r"(?<![A-Za-z0-9_])(?:%s)(?![A-Za-z0-9_])" % pattern)
        return sum(d for _, d, n in self.ops if rx.search(n)) * 1e-6

    def ops_within(self, name: str):
        """The device operations that start inside a span called
        ``name``."""
        sp = sorted((s, s + d) for s, d, n in self.spans if n == name)
        out, k = [], 0
        for op in sorted(self.ops):
            while k < len(sp) and sp[k][1] <= op[0]:
                k += 1
            if k < len(sp) and sp[k][0] <= op[0]:
                out.append(op)
        return out

    def busy_within(self, name: str) -> Tuple[float, float]:
        """(device-busy seconds inside the spans called ``name``, the
        spans' seconds)."""
        busy = total = 0.0
        for s, d, n in self.spans:
            if n != name:
                continue
            total += d
            busy += union_us(_clip(self.ops, s, s + d))
        return busy * 1e-6, total * 1e-6

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for _, d, n in self.ops:
            by[short_name(n)] += d * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The device's idle time inside the window, by what the host was
        doing: each gap between busy intervals is given to the innermost
        host span that covers its middle ("host.other" where none does)."""
        gaps = []
        end = self.t0
        for s, d in merged(self.ops):
            if s > end:
                gaps.append((end, s))
            end = max(end, s + d)
        if self.t1 > end:
            gaps.append((end, self.t1))
        spans = sorted(self.spans, key=lambda x: x[1])
        by = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = next((n for s, d, n in spans if s <= mid < s + d),
                        "host.other")
            by[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    base = name.split("(")[0]
    base = re.sub(r"<.*", "", base)
    return base.replace("void ", "").strip()[:120] or name[:120]


def _clip(ops, a, b):
    return [(max(s, a), min(s + d, b) - max(s, a), n) for s, d, n in ops
            if s < b and s + d > a]


def merged(ops):
    """The union of the intervals as sorted disjoint (start, dur)."""
    out = []
    for s, d, _ in sorted(ops):
        if out and s <= out[-1][0] + out[-1][1]:
            ps, pd = out[-1]
            out[-1] = (ps, max(pd, s + d - ps))
        else:
            out.append((s, d))
    return out


def union_us(ops) -> float:
    return sum(d for _, d in merged(ops))


def parse(path: str, window: str = "bench.window") -> Optional[Trace]:
    """The reduced trace of a Chrome trace that torch.profiler exported,
    cut to its ``window`` span; None if the span is missing."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == window
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    ops = _clip([(float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS], t0, t1)
    spans = [(float(e["ts"]), float(e["dur"]), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("bench.") and e["name"] != window
             and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]
    return Trace(t0, t1, ops, spans)


class Profiler:
    """torch.profiler over the card and the host around a window, or
    nothing where ``on`` is false. ``span(name)`` records a host span in a
    traced window and costs nothing otherwise."""

    def __init__(self, on: bool, out_dir: str):
        self.on, self.out_dir = on, out_dir
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def wrap(self, obj, method: str, name: str):
        """Record a span around ``obj.method`` (this instance only)."""
        if not self.on:
            return
        fn = getattr(obj, method)

        def spanned(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        setattr(obj, method, spanned)

    @contextlib.contextmanager
    def window(self, sync):
        """The traced window: ``sync`` () waits for the card's work."""
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            time.sleep(PAD_S)
            with torch.profiler.record_function("bench.window"):
                yield
                sync()
            time.sleep(PAD_S)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        prof.export_chrome_trace(path)
        self.trace = parse(path)
        os.remove(path)
