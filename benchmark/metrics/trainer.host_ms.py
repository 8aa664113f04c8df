"""trainer.host_ms: the host's time between bundles, per step: (the
window's wall time - the billed device time of its bundles) / steps. Moves
steps_per_s."""


def read(counters, trace):
    if not counters.get("steps") or "billed_s" not in counters:
        return None
    return 1e3 * (counters["wall_s"] - counters["billed_s"]) \
        / counters["steps"]
