"""step.glue_ms: device ms per step of every kernel, copy and fill that
starts inside the benchmark's spans around run_steps, other than the
fused train op's (window selection, sampling, gathers, AdamW, the
write-back). Moves step_ms."""

import re

from benchmark import common


def read(counters, trace):
    if trace is None or not trace.ops or not counters.get("steps"):
        return None
    kernels = common.metric_module("train_op.ms").KERNELS
    rx = re.compile(r"(?<![A-Za-z0-9_])(?:%s)(?![A-Za-z0-9_])"
                    % "|".join(kernels))
    glue = sum(d for _, d, n in trace.ops_within("bench.run_steps")
               if not rx.search(n)) * 1e-6
    return 1e3 * glue / counters["steps"]
