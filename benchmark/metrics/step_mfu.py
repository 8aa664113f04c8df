"""step_mfu: the whole step's share of the chip's peak. The train op's
operations of every step in the traced window (bf16 products at the bf16
peak, the f32 work at the f32 peak; counts.py) over the steps' billed time
(the benchmark's CUDA events), in percent. Moves step_ms."""

from benchmark import counts as CNT


def read(counters, trace):
    op = counters.get("train_op")
    if not op or not counters.get("billed_s"):
        return None
    least = CNT.peak_seconds(op["bf16"], op["f32"]) * counters["steps"]
    return 100.0 * least / counters["billed_s"]
