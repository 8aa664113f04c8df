"""device.idle_share.query: as device.idle_share, in a query cell. Moves
query_p95_ms."""


def read(counters, trace):
    if trace is None or not trace.ops or "requests" not in counters:
        return None
    return 100.0 * trace.idle_share()
