"""query.copy_in_ms: the host's time inside the program's
``serve.copy_in`` spans (a request's points copied to the card), a
request of the window. Moves query_p95_ms."""

from benchmark import program_spans as PS


def read(counters, trace):
    reqs = PS.within(trace, "serve.request")
    if reqs is None:
        return None
    copies = PS.within(trace, "serve.copy_in") or []
    return sum(c.t1 - c.t0 for c in copies) * 1e-3 / len(reqs)
