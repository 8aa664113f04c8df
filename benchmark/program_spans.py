"""The program's own spans (isdf_tpu_torch/utils/profiling.py) inside a
traced window, for the per-layer metrics that read them.

The port records a span while a torch profiler runs, on the exported
trace's clock, so the spans and the reduced trace's device operations
share one time axis. A checkout whose port records no spans yields None
here, and the metrics that read them report nothing.
"""

from __future__ import annotations

import bisect

from benchmark.trace import merged


def within(trace, *names):
    """The port's recorded spans called one of ``names`` that lie wholly
    inside the trace's window, in start order; None where the trace, the
    recorder or such spans are missing."""
    if trace is None:
        return None
    from isdf_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    out = sorted((s for s in recorded(trace.t0, trace.t1)
                  if s.name in names and trace.t0 <= s.t0
                  and s.t1 <= trace.t1), key=lambda s: s.t0)
    return out or None


class Device:
    """The trace's device operations, sorted, for questions about
    intervals of its timeline (us)."""

    def __init__(self, ops):
        self.ops = sorted((s, s + d) for s, d, _ in ops)
        self.starts = [s for s, _ in self.ops]
        self.longest = max((e - s for s, e in self.ops), default=0.0)
        self.reach = []          # the latest end among the first k + 1
        m = float("-inf")
        for _, e in self.ops:
            m = max(m, e)
            self.reach.append(m)

    def last_end_before(self, t: float):
        """The latest end of the operations that start before ``t``."""
        k = bisect.bisect_left(self.starts, t)
        return self.reach[k - 1] if k else None

    def gaps(self, a: float, b: float):
        """The idle stretches [(start, end)] of the device in [a, b)."""
        lo = bisect.bisect_left(self.starts, a - self.longest)
        hi = bisect.bisect_left(self.starts, b)
        busy = merged([(max(s, a), min(e, b) - max(s, a), "")
                       for s, e in self.ops[lo:hi] if e > a])
        out, end = [], a
        for s, d in busy:
            if s > end:
                out.append((end, s))
            end = max(end, s + d)
        if b > end:
            out.append((end, b))
        return out


def union(intervals):
    """The union of [(start, end)] as sorted disjoint [(start, end)]."""
    return [(a, a + d) for a, d in merged([(a, b - a, "")
                                           for a, b in intervals])]


def bundle_gaps(trace):
    """(the card's idle stretches inside the bundles, the steps the
    bundles carry), or None without ``step.bundle`` spans.

    A bundle's interval on the card runs from its span's start until the
    fetch that follows it has landed: the latest end of the device
    operations that start before the first ``trainer.fetch`` or
    ``fleet.fetch`` span after the bundle ends (its own end where no fetch
    follows). The host returns from a bundle of graph replays long before
    the card has run them, and the scalars' fetch waits for them. The
    bundles of a round overlap there, so their union is taken."""
    bundles = within(trace, "step.bundle")
    if bundles is None:
        return None
    fetches = within(trace, "trainer.fetch", "fleet.fetch") or []
    dev = Device(trace.ops)
    ivs = []
    for b in bundles:
        f = next((x for x in fetches if x.t0 >= b.t1), None)
        end = dev.last_end_before(f.t1) if f is not None else None
        ivs.append((b.t0, max(b.t1, end if end is not None else b.t1)))
    steps = sum(b.counts.get("steps", 0) for b in bundles)
    out = []
    for a, b in union(ivs):
        out += dev.gaps(a, b)
    return out, steps
