"""train_op.roofline: the fused train op's share of its roofline, in
percent: the larger of its operations at the chip's peaks and its bytes
(each input read once, each output written once) at the memory rate,
over the op's device time per step in the trace. Moves step_ms."""

from benchmark import common
from benchmark import counts as CNT


def read(counters, trace):
    op = counters.get("train_op")
    if trace is None or not op or not counters.get("steps"):
        return None
    kernels = common.metric_module("train_op.ms").KERNELS
    t = trace.op_seconds("|".join(kernels)) / counters["steps"]
    if t <= 0:
        return None
    least = max(CNT.peak_seconds(op["bf16"], op["f32"]),
                op["bytes"] / CNT.PEAKS["hbm_bytes"])
    return 100.0 * least / t
