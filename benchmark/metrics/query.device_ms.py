"""query.device_ms: the card's operation time per request in the trace
(the sum of durations over the requests of the traced window). Moves
query_p95_ms."""


def read(counters, trace):
    if trace is None or not trace.ops or not counters.get("requests"):
        return None
    return 1e3 * sum(d for _, d, _ in trace.ops) * 1e-6 \
        / counters["requests"]
