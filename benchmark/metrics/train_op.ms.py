"""train_op.ms: device ms per step of the fused train op's kernels in the
trace. The op's kernels are named here, as the trace shows them: K1's
phase-1 tile, its split-K dW products and their reduction. Moves step_ms."""

KERNELS = ("k_train_tile", "k_dw", "k_reduce")


def read(counters, trace):
    if trace is None or not counters.get("steps"):
        return None
    s = trace.op_seconds("|".join(KERNELS))
    return 1e3 * s / counters["steps"] if s > 0 else None
