"""query.gap_ms: the card's idle time inside the program's
``serve.request`` spans (SDFQueryEngine: validation, lock, copy-in,
launches and the fetch that waits for them), a request. Moves
query_p95_ms."""

from benchmark import program_spans as PS


def read(counters, trace):
    reqs = PS.within(trace, "serve.request")
    if reqs is None:
        return None
    dev = PS.Device(trace.ops)
    idle = sum(b - a for r in reqs for a, b in dev.gaps(r.t0, r.t1))
    return idle * 1e-3 / len(reqs)
