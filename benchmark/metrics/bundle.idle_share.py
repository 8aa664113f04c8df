"""bundle.idle_share: the card's idle share inside the benchmark's spans
around each run_steps call (a bundle of graph replays and its fetch):
1 - (union of device operations inside the spans) / (the spans' time), in
percent. Moves step_ms."""


def read(counters, trace):
    if trace is None:
        return None
    busy, total = trace.busy_within("bench.run_steps")
    return 100.0 * (1.0 - busy / total) if total > 0 else None
