"""query_mfu: the f32 operations of every request of the traced window
(the forward, and a gradient request's input-gradient chain; counts.py)
over the window's wall time, as a share of the f32 peak, in percent. The
query path multiplies in IEEE float32 (TF32 off). Moves query_p95_ms."""

from benchmark import counts as CNT


def read(counters, trace):
    if not counters.get("query_flops") or not counters.get("wall_s"):
        return None
    return 100.0 * counters["query_flops"] / CNT.PEAKS["f32_flops"] \
        / counters["wall_s"]
