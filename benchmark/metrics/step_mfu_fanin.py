"""step_mfu_fanin: the whole step's share of the chip's peak at the map's
own fan-ins. The train op's operations of every step in the traced window
(counts_fanin.py, the op's shape from the program's step.bundle spans; bf16
products at the bf16 peak, the f32 work at the f32 peak) over the steps'
billed time (the benchmark's CUDA events), in percent. None unless every
step.bundle span of the window names the kernel variant it launched.
Moves step_ms."""

from benchmark import counts as CNT
from benchmark import counts_fanin as CF


def read(counters, trace):
    shape = CF.bundle_shape(trace) if trace is not None else None
    if shape is None or not counters.get("billed_s"):
        return None
    fb, ff = CF.k1_flops(**shape)
    least = CNT.peak_seconds(fb, ff) * counters["steps"]
    return 100.0 * least / counters["billed_s"]
