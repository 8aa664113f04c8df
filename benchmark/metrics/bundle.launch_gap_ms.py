"""bundle.launch_gap_ms: the part of bundle.gap_ms in idle stretches whose
middle lies inside the program's ``step.table``, ``step.replay`` or
``step.eager`` spans: the card waiting on the host's launches, a step.
Moves step_ms."""

import bisect

from benchmark import program_spans as PS


def read(counters, trace):
    got = PS.bundle_gaps(trace)
    if got is None or not got[1]:
        return None
    gaps, steps = got
    launch = PS.within(trace, "step.table", "step.replay",
                       "step.eager") or []
    starts = [s.t0 for s in launch]
    total = 0.0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid)
        if k and launch[k - 1].t1 > mid:
            total += b - a
    return total * 1e-3 / steps
