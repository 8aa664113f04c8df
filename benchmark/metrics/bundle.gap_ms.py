"""bundle.gap_ms: the card's idle time inside the bundles of steps, a
step: the program's ``step.bundle`` spans (StepFunctions.train_bundle, the
call the sim clock bills), each from its start until the scalars' fetch
after it has landed (program_spans.bundle_gaps), less the union of the
device operations there, over the steps the spans carry. Moves step_ms."""

from benchmark import program_spans as PS


def read(counters, trace):
    got = PS.bundle_gaps(trace)
    if got is None or not got[1]:
        return None
    gaps, steps = got
    return sum(b - a for a, b in gaps) * 1e-3 / steps
