"""CUDA graphs for the port's hot loops: a training step and a pose burst
(isdf_tpu jits a bundle of steps and a burst as one compiled program each;
here each is one captured step replayed).

``GraphRunner`` owns a side stream and a memory pool of the card. ``warm``
runs a function eagerly on the side stream: a key's first call, which sets
up what a capture cannot (autograd's device thread, cuBLAS's workspace on
that stream, lazily loaded kernels) and counts as a call like any other.
``capture`` records a function's launches as a CUDA graph on that stream;
the returned ``Captured`` replays them on the current stream. The kernels'
launch counts of a capture are tallied (utils/nvcc.py) and added once per
replay. The generators the function draws from are registered with the
graph: a replay reads each one's seed and offset when it starts and
advances the offset as the eager call would, so ``manual_seed`` before a
replay gives the eager call's draws.

A failed capture raises; nothing carries on eagerly in its place. The
caller keeps a captured function's inputs at fixed addresses: a graph
reads and writes the tensors it was captured with.

A capture begins in CUDA's global mode, in which a call such as
``cudaMalloc`` or a synchronising copy from any thread of the process
invalidates it (a planner's query from an HTTP thread did, on the card:
``cudaErrorStreamCaptureInvalidated`` in the loop, ``...Unsupported`` in
the query). So ``capture`` holds ``CAPTURE_LOCK`` from its begin to its
end, and device work on a thread other than the loop's takes it around
its launches and copies (serve.py's queries, vis/server.py's handlers
over a trainer that no loop runs). Nothing else holds it: the loop's
bundles and the handlers' host work run beside each other. Python's
cyclic collector is held off during a capture too: a graph it frees there
(a dropped trainer's, in a reference cycle) resets, which a capture
forbids, and the capture is invalidated (``cudaErrorStreamCaptureInvalidated``
in the next launch, on the card).
"""

from __future__ import annotations

import gc
import threading
import time

import torch

from isdf_tpu_torch.utils import nvcc
from isdf_tpu_torch.utils.profiling import span

# process-wide, as CUDA's global capture mode is; re-entrant, so device
# work that calls other locked work does not wait on itself
CAPTURE_LOCK = threading.RLock()


def captured_on(tensors, transform):
    """What a set of graphs was captured on: the tensors they read (the
    objects, held, so that an address cannot come to name another tensor)
    and the version of the scene transform (an edit in place bumps it)."""
    return (tuple(tensors), getattr(transform, "_version", None))


def same_inputs(a, b) -> bool:
    """Whether two captured_on records name the same tensors and
    transform version."""
    return (a is not None and b is not None and a[1] == b[1]
            and len(a[0]) == len(b[0])
            and all(x is y for x, y in zip(a[0], b[0])))


class Captured:
    """A captured function: ``replay()`` runs its launches once."""

    def __init__(self, graph, tally, owner):
        self.graph, self.tally, self._owner = graph, tally, owner

    def replay(self, times: int = 1):
        for _ in range(times):
            self.graph.replay()
        nvcc.add_tally(self.tally, times)
        self._owner.stats["replays"] += times


class GraphRunner:
    """Warm-up and capture of functions on one side stream of a card, the
    graphs sharing one memory pool. A shared pool is safe here because the
    owner reads a graph's outputs before it replays another graph of the
    same runner, and never replays two at once."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        # intervals: (capture_begin, capture_end) on time.perf_counter();
        # warm_s: the host seconds of warm(), a key's eager first call
        self.stats = {"captures": 0, "capture_s": 0.0, "warm_s": 0.0,
                      "replays": 0, "intervals": []}

    def warm(self, fn):
        """fn() eagerly on the side stream, ordered after the current
        stream's work and before its later work."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with span("graphs.warm"), torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        self.stats["warm_s"] += time.perf_counter() - t0
        return out

    def capture(self, fn, generators=()) -> Captured:
        """Record fn()'s launches as a graph; fn runs once, on the host
        only. Its tensors come from the runner's pool and stay valid for
        the graph's replays. The span ``graphs.capture`` encloses the
        capture; none opens inside it."""
        with span("graphs.capture"):
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with CAPTURE_LOCK, torch.cuda.stream(self.stream), \
                        nvcc.capture_tally() as tally:
                    tb = time.perf_counter()
                    graph.capture_begin(pool=self.pool)
                    try:
                        fn()
                    except BaseException:
                        try:
                            graph.capture_end()
                        except Exception:   # the capture is invalid already
                            pass
                        raise
                    graph.capture_end()
                    te = time.perf_counter()
            finally:
                if collecting:
                    gc.enable()
            cur.wait_stream(self.stream)
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
            self.stats["intervals"].append((tb, te))
            return Captured(graph, list(tally), self)
