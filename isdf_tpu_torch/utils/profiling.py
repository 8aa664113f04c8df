"""Tracing, bundle timing and rolling step-time statistics
(isdf_tpu/utils/profiling.py): a torch.profiler trace context, the
program's own spans, the clock that times a bundle on its device, and the
reference GUI's 20-second compute balance readout (isdf_window.py:694-708).

Spans. ``span(name, **counts)`` marks a piece of the program's host work
(a bundle, a request's copy-in, a frame read). It is on exactly while a
torch profiler runs (``device_trace``, any ``torch.profiler.profile``),
read from the profiler's own enabled flag; otherwise it returns one shared
context that does nothing. On, it opens a record_function range
``"isdf." + name`` (on the profiler's fast path: an event of category
``cpu_op``), so that the span lands in the Chrome trace beside the
kernels, and keeps a ``Span`` record in memory: name, start and end in
microseconds on the exported trace's clock, its id, the id of the span
that encloses it on its thread, the thread, and its counts (``bytes=``,
``steps=``, ...; more may be added inside the block with ``.count()``).
``recorded(t0_us, t1_us)`` returns the records that overlap a window of
the trace, ``clear()`` empties them. The records are bounded
(``SPAN_CAP``); those past the bound are counted in ``dropped()``. No span
may sit inside code a CUDA graph captures.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _tprof

# record_function's fast path, the one torch's compiled code takes: a
# range in C++ with no operator dispatched, 1-2 us on against 12-16 us for
# torch.profiler.record_function, so that little lies between a span's
# stamp and the profiler's own
_RANGE = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block, the CPU and (where there is one) the
    CUDA device; writes a Chrome trace, ``trace.json`` in ``log_dir``,
    when the block ends. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# torch's Chrome exporter writes each timestamp less a base: unix time
# rounded down to a multiple of this period (``baseTimeNanoseconds`` in
# the exported file)
TRACE_BASE_PERIOD_NS = 7_889_238 * 10 ** 9
SPAN_CAP = 1 << 18


def trace_us(unix_ns: int) -> float:
    """A unix time in ns on the exported Chrome trace's clock (us)."""
    return (unix_ns - unix_ns // TRACE_BASE_PERIOD_NS
            * TRACE_BASE_PERIOD_NS) * 1e-3


class Span(NamedTuple):
    """One recorded span: ``t0``, ``t1`` in us on the trace's clock;
    ``parent`` the ``sid`` of the span enclosing it on its thread."""
    name: str
    t0: float
    t1: float
    sid: int
    parent: Optional[int]
    thread: int
    counts: Dict[str, float]


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.dropped = 0
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def keep(self, rec: Span):
        with self.lock:
            if len(self.spans) < SPAN_CAP:
                self.spans.append(rec)
            else:
                self.dropped += 1


_REC = _Recorder()


class _Off:
    """The span while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "sid", "parent", "t0", "range")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        st = _REC.stack()
        self.parent = st[-1].sid if st else None
        self.sid = next(_REC.ids)
        st.append(self)
        self.range = _RANGE("isdf." + self.name)
        # the profiler stamps a range last on entry and first on exit, so
        # the stamps here are taken inside it
        self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.range.__exit__(*exc)
        st = _REC.stack()
        if st and st[-1] is self:
            st.pop()
        _REC.keep(Span(self.name, trace_us(self.t0), trace_us(t1), self.sid,
                       self.parent, threading.get_ident(), self.counts))
        return False

    def count(self, **counts):
        self.counts.update(counts)


def span(name: str, **counts):
    """A context recording the block as span ``name`` while a torch
    profiler runs; one shared no-op context otherwise."""
    if not _tprof._is_profiler_enabled:
        return _OFF
    return _On(name, counts)


def recorded(t0_us: float = float("-inf"),
             t1_us: float = float("inf")) -> List[Span]:
    """The kept spans that overlap [t0_us, t1_us) on the trace's clock,
    in the order they ended."""
    with _REC.lock:
        spans = list(_REC.spans)
    return [s for s in spans if s.t1 > t0_us and s.t0 < t1_us]


def dropped() -> int:
    """Spans not kept since the last clear(): the recorder was full."""
    return _REC.dropped


def clear():
    with _REC.lock:
        _REC.spans.clear()
        _REC.dropped = 0


class BundleClock:
    """The measured time of a bundle of launches: CUDA events recorded
    around them on the card's stream (the reference's own timing,
    isdf/eval/metrics.py:13-38), the host's wall clock on the CPU.

    Start it before the launches, ``stop()`` after them, and read
    ``seconds()`` once a fetch of the bundle's results has synced.

    ``others``: the other cards of a mesh (parallel/mesh.py). Their
    streams are ordered after the start event and joined back into this
    card's stream before the stop event, so the time spans every shard:
    on distinct cards the slowest card's, on shards of one card their
    sum."""

    def __init__(self, device, others=()):
        self._ev = None
        self._others = []
        if device.type == "cuda":
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
            cur = torch.cuda.current_stream(device)
            self._others = [torch.cuda.current_stream(d) for d in others
                            if d.type == "cuda" and d != cur.device]
            for st in self._others:
                st.wait_stream(cur)
        self._t0 = time.perf_counter()

    def stop(self):
        if self._ev is not None:
            for st in self._others:
                torch.cuda.current_stream().wait_stream(st)
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
