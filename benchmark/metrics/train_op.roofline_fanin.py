"""train_op.roofline_fanin: the fused train op's share of its roofline at
the map's own fan-ins, in percent: the larger of its operations at the
chip's peaks and its bytes at the memory rate (counts_fanin.py, the op's
shape from the program's step.bundle spans) over the op's device time a
step in the trace (train_op.ms's kernels). None unless every step.bundle
span of the window names the kernel variant it launched. Moves step_ms."""

from benchmark import common
from benchmark import counts as CNT
from benchmark import counts_fanin as CF


def read(counters, trace):
    shape = CF.bundle_shape(trace) if trace is not None else None
    if shape is None or not counters.get("steps"):
        return None
    kernels = common.metric_module("train_op.ms").KERNELS
    t = trace.op_seconds("|".join(kernels)) / counters["steps"]
    if t <= 0:
        return None
    fb, ff = CF.k1_flops(**shape)
    least = max(CNT.peak_seconds(fb, ff),
                CF.k1_bytes(**shape) / CNT.PEAKS["hbm_bytes"])
    return 100.0 * least / t
