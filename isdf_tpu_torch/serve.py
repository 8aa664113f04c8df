"""Standalone SDF query service: a trained map served to planners
(isdf_tpu/serve.py).

The reference's downstream use is robot planning: the learned SDF is
queried for values and gradients (reference trainer.py:2066-2078) and
turned into CHOMP or linear collision costs (reference metrics.py:95-113).

* :class:`SDFQueryEngine` — batched queries on a device against a trained
  map, built from a live :class:`Trainer` or from a checkpoint archive
  alone (the archive stores the model description and the scene frame, so
  serving a saved map needs no config or dataset). Archives of either
  package load.
* :class:`EnsembleEngine` — the uniform mean of several maps.
* :class:`SDFQueryServer` — a threaded stdlib-HTTP JSON API (GET
  /healthz; POST /sdf, /grad, /query, /collision); several maps are served
  under /scene/<NAME>/<route>.
* The CLI: ``python -m isdf_tpu_torch.serve --checkpoint [NAME=]PATH``
  (repeatable; '+' joins the members of an ensemble) runs on the card
  unless ``--device cpu``.

A POST body is parsed, and an answer with arrays serialised, by the json
module in a worker process of its own (``_codec``): a 65,536-point body
is some 4 MB of JSON, and json holds the interpreter for its whole C call
(100-300 ms), during which a training loop in this process (train_vis
--serve-queries) could launch nothing. The bytes are the json module's,
as in process.

A query is cut into chunks of ``chunk_size`` points, run on the engine's
device into one output tensor there and fetched once. A chunk takes one
of two routes (``route``, fixed by the map and the device): on a
CUDA device a float32 map with the icosahedron PE and hidden width 256 is
answered by one launch of the query kernel a chunk
(models/cuda_query.py); every other map, and every map on the CPU, by
the eager ``apply`` / ``sdf_and_grad`` in the map's compute dtype (a map
trained with ``tpu.compute_dtype: "bfloat16"`` is served in bf16, as
isdf_tpu serves it). On the card a request's copies and launches run on
a stream of the engine's own, and the answer comes back through pinned
memory once an event says the card is done: a training loop in the same
process then neither queues behind a query nor waits on its copy. A
served map owns a copy
of the parameters, since the trainer updates its own in place;
``refresh_from_trainer`` swaps in a new copy atomically.
"""

from __future__ import annotations

import contextlib
import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from isdf_tpu_torch.eval.metrics import chomp_cost, linear_cost
from isdf_tpu_torch.models import cuda_query as CQ
from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.utils.device import resolve_device
from isdf_tpu_torch.utils.graphs import CAPTURE_LOCK
from isdf_tpu_torch.utils.profiling import span

# cap per request: 1M points (12 MB of float32 xyz); bigger batches stream
# several requests
MAX_POINTS = 1 << 20


def _collision(sdf, margin: float) -> Dict[str, Any]:
    below = sdf <= margin
    return {"min_sdf": float(sdf.min()) if sdf.size else float("inf"),
            "argmin": int(sdf.argmin()) if sdf.size else -1,
            "n_below": int(below.sum()),
            "collides": bool(below.any())}


_CODEC = []
_CODEC_LOCK = threading.Lock()


def _codec():
    """The process-wide JSON worker, started at first use."""
    with _CODEC_LOCK:
        if not _CODEC:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            _CODEC.append(ProcessPoolExecutor(
                max_workers=1,
                mp_context=multiprocessing.get_context("spawn")))
        return _CODEC[0]


def _decode(body: bytes):
    """(the request without its points, the points as float32) of a POST
    body; in the worker."""
    req = json.loads(body or b"{}")
    pts = np.asarray(req.get("points", []), np.float32)
    req.pop("points", None)
    return req, pts


def _encode(obj: Dict[str, Any]) -> bytes:
    """The JSON of an answer whose values may be arrays; in the worker."""
    return json.dumps({k: v.tolist() if isinstance(v, np.ndarray) else v
                       for k, v in obj.items()}).encode()


@dataclass
class SDFQueryEngine:
    """Batched SDF, gradient, cost and collision queries against a map."""

    params: Dict[str, torch.Tensor]
    model: M.SDFModel
    transform: torch.Tensor         # world -> unit-box frame [4, 4]
    chunk_size: int = 1 << 16
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()
        self.device = self.transform.device
        self.route = ("kernel" if CQ.supports(self.model, self.device)
                      else "eager")
        # a request's copies and launches run on a stream of the engine's
        # own: on the caller's current stream, the legacy default stream,
        # which a training loop in this process also uses, every op of the
        # loop waited for every query queued before it
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------- build
    @classmethod
    def from_trainer(cls, trainer, chunk_size: int = 1 << 16):
        return cls(params=M.copy_params(trainer.params), model=trainer.model,
                   transform=trainer.transform_dev.clone(),
                   chunk_size=chunk_size, meta={"source": "trainer"})

    @classmethod
    def from_checkpoint(cls, path: str, config=None,
                        chunk_size: int = 1 << 16, device=None):
        """A map from a checkpoint archive alone (utils/checkpoint.py, or
        isdf_tpu's). ``config`` (utils.config.Config) overrides the stored
        model description; archives without one need it."""
        from isdf_tpu_torch.utils import checkpoint as CK
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as z:
            meta = CK.read_meta(z)
            if config is not None:
                model = M.SDFModel(
                    embedding_size=config.embedding_size,
                    hidden_size=config.hidden_feature_size,
                    hidden_layers_block=config.hidden_layers_block,
                    scale_output=config.scale_output,
                    scale_input=config.scale_input,
                    min_deg=0, max_deg=config.n_embed_funcs,
                    gauss_embed=config.gauss_embed,
                    gauss_embed_std=config.gauss_embed_std,
                    mm_precision=config.mm_precision,
                    compute_dtype=config.compute_dtype)
            elif "model" in meta:
                model = CK.model_from_meta(meta["model"])
            else:
                raise ValueError(
                    f"{path} has no stored model description; pass the "
                    "training config")
            template = M.params_to_jax(M.init_params(
                torch.Generator().manual_seed(0), model), model)
            params = CK.read_params(z, "params/", model, template, dev)
        if "bounds_transform" in meta:
            transform = torch.as_tensor(np.linalg.inv(np.asarray(
                meta["bounds_transform"], np.float32)).astype(np.float32),
                device=dev)
        else:
            transform = torch.eye(4, device=dev)
        return cls(params=params, model=model, transform=transform,
                   chunk_size=chunk_size,
                   meta={"source": path, "step": meta.get("step"),
                         "sim_time_s": meta.get("tot_step_time")})

    def refresh_from_trainer(self, trainer):
        """Swap in a copy of the trainer's current map atomically: readers
        see the old or the new map, never a mix."""
        p = M.copy_params(trainer.params)
        tr = trainer.transform_dev.clone()
        with self._lock:
            self.params, self.transform = p, tr

    # ------------------------------------------------------------ queries
    def _chunked(self, pts, grad: bool) -> np.ndarray:
        """Traced, a request is the span ``serve.request`` with the children
        ``serve.validate``, ``serve.lock`` (waiting for CAPTURE_LOCK),
        ``serve.copy_in``, ``serve.compute`` (the launches, counting
        ``kernel_chunks`` and ``eager_chunks``) and ``serve.fetch`` (the
        copy back, which waits for the card)."""
        with span("serve.request", grad=int(grad)) as req:
            with span("serve.validate"):
                pts = np.ascontiguousarray(pts, np.float32)
                if pts.ndim != 2 or pts.shape[1] != 3:
                    raise ValueError(
                        f"points must be [N,3], got {pts.shape}")
                n = pts.shape[0]
                req.count(points=n)
                if n > MAX_POINTS:
                    raise ValueError(f"{n} points exceeds the {MAX_POINTS} "
                                     "cap; stream multiple requests")
                if not np.isfinite(pts).all():
                    # JSON's NaN / Infinity tokens parse, but would come
                    # back as bare NaN, which strict JSON clients reject
                    raise ValueError("points contain non-finite values")
            with self._lock:
                params, transform = self.params, self.transform
            if n == 0:
                return np.zeros((0, 3) if grad else (0,), np.float32)
            K = self.chunk_size
            # queries come from threads beside a training loop, whose graph
            # captures another thread's device work would break
            # (utils/graphs)
            with span("serve.lock"):
                CAPTURE_LOCK.acquire()
            kernel = self.route == "kernel"
            chunk = CQ.query_cuda if kernel else CQ.query_plain
            try:
                with self._on_stream():
                    with span("serve.copy_in"):
                        x = torch.from_numpy(pts).to(self.device)
                    out = torch.empty((n, 3) if grad else (n,),
                                      device=self.device)
                    with span("serve.compute") as sp:
                        for i in range(0, n, K):
                            chunk(params, x[i:i + K], self.model, transform,
                                  out[i:i + K], grad)
                        chunks = -(-n // K)
                        sp.count(kernel_chunks=chunks if kernel else 0,
                                 eager_chunks=0 if kernel else chunks)
                    with span("serve.fetch"):
                        if self._stream is None:
                            return out.cpu().numpy()
                        # into pinned memory, then a wait on an event: a
                        # copy into pageable memory waits for the kernel
                        # inside the copy call, and a loop beside
                        # back-to-back planners ran some 5x slower for it
                        host = torch.empty(out.shape, pin_memory=True)
                        host.copy_(out, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record()
                        done.synchronize()
                        return host.numpy().copy()
            finally:
                CAPTURE_LOCK.release()

    @contextlib.contextmanager
    def _on_stream(self):
        """The engine's stream, after the work the caller's stream has
        queued (the served copy of the parameters among it)."""
        if self._stream is None:
            yield
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            yield

    def sdf(self, pts) -> np.ndarray:
        """SDF values [N] (metres) at world points [N, 3]."""
        return self._chunked(pts, grad=False)

    def grad(self, pts) -> np.ndarray:
        """Spatial SDF gradients [N, 3] at world points [N, 3]."""
        return self._chunked(pts, grad=True)

    def chomp_cost(self, pts, epsilon: float = 2.0) -> np.ndarray:
        """Per-point CHOMP obstacle cost (reference metrics.py:95-104)."""
        return np.asarray(chomp_cost(self.sdf(pts), epsilon=epsilon))

    def linear_cost(self, pts, epsilon: float = 1.5) -> np.ndarray:
        """Hinge cost max(epsilon - sdf, 0) (reference metrics.py:107-113)."""
        return np.asarray(linear_cost(self.sdf(pts), epsilon=epsilon))

    def collision(self, pts, margin: float = 0.0) -> Dict[str, Any]:
        """Does any query point lie within ``margin`` metres of (or inside)
        the surface?"""
        return _collision(self.sdf(pts), margin)

    def info(self) -> Dict[str, Any]:
        return {"ok": True,
                "param_count": M.param_count(self.params, self.model),
                "embedding_size": self.model.embedding_size,
                "hidden_size": self.model.hidden_size,
                "chunk_size": self.chunk_size,
                "max_points": MAX_POINTS,
                "device": str(self.device),
                "route": self.route,
                **self.meta}


class EnsembleEngine:
    """The uniform mean of member engines (one scene, independent seeds).
    It has SDFQueryEngine's query interface, so it serves unchanged."""

    def __init__(self, members):
        if len(members) < 1:
            raise ValueError("ensemble needs at least one member")
        self.members = list(members)

    def sdf(self, pts) -> np.ndarray:
        return np.mean([m.sdf(pts) for m in self.members], axis=0)

    def grad(self, pts) -> np.ndarray:
        # the gradient of the mean is the mean of the gradients
        return np.mean([m.grad(pts) for m in self.members], axis=0)

    def collision(self, pts, margin: float = 0.0) -> Dict[str, Any]:
        return _collision(self.sdf(pts), margin)

    def info(self) -> Dict[str, Any]:
        return {"ok": True, "ensemble": len(self.members),
                "members": [m.info() for m in self.members]}


# --------------------------------------------------------------------- http
class _QueryHandler(BaseHTTPRequestHandler):
    engines: Dict[str, SDFQueryEngine] = None  # bound by SDFQueryServer

    def log_message(self, *a):  # quiet
        pass

    def _send(self, obj, code=200, close=False, body=None):
        """Answer obj as JSON; an answer with arrays comes in as ``body``,
        serialised by the worker."""
        if body is None:
            body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if close:
            self.close_connection = True
            self.send_header("Connection", "close")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_arrays(self, obj):
        self._send(None, body=_codec().submit(_encode, obj).result())

    def _resolve(self):
        """(engine, route, error) of the request path: /scene/<name>/<route>
        for a fleet of maps; bare routes while exactly one map is
        served."""
        p = self.path.rstrip("/")
        if p.startswith("/scene/"):
            parts = p.split("/", 3)  # '', 'scene', name, route
            name = parts[2] if len(parts) > 2 else ""
            e = self.engines.get(name)
            if e is None:
                return None, None, {"error": f"unknown scene {name!r}",
                                    "scenes": sorted(self.engines)}
            return e, ("/" + parts[3] if len(parts) > 3 else ""), None
        if len(self.engines) == 1:
            return next(iter(self.engines.values())), p, None
        return None, None, {"error": "multiple scenes loaded; use "
                                     "/scene/<name>/<route>",
                            "scenes": sorted(self.engines)}

    def do_GET(self):  # noqa: N802 (stdlib API)
        p = self.path.rstrip("/")
        if p in ("", "/healthz"):
            if len(self.engines) == 1:
                return self._send(next(iter(self.engines.values())).info())
            return self._send({"scenes": {
                k: e.info() for k, e in sorted(self.engines.items())}})
        e, route, err = self._resolve()
        if err:
            return self._send(err, 404)
        if route in ("", "/healthz"):
            return self._send(e.info())
        self._send({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802 (stdlib API)
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > 64 * MAX_POINTS:  # ~64 B a point of JSON is generous
                # the body stays unread: close the connection so the client
                # reads the 413 and the keep-alive stream stays in step
                return self._send({"error": "request too large"}, 413,
                                  close=True)
            req, pts = _codec().submit(_decode, self.rfile.read(n)).result()
            if pts.size == 0:
                return self._send({"error": "no points"}, 400)
            e, p, err = self._resolve()
            if err:
                return self._send(err, 404)
            if p == "/sdf":
                return self._send_arrays({"sdf": e.sdf(pts)})
            if p == "/grad":
                return self._send_arrays({"grad": e.grad(pts)})
            if p == "/collision":
                return self._send(
                    e.collision(pts, margin=float(req.get("margin", 0.0))))
            if p == "/query":
                sdf = e.sdf(pts)
                out = {"sdf": sdf,
                       "chomp_cost": np.asarray(chomp_cost(
                           sdf, epsilon=float(req.get("epsilon", 2.0))))}
                if req.get("grad", True):
                    out["grad"] = e.grad(pts)
                return self._send_arrays(out)
            self._send({"error": "not found"}, 404)
        except BrokenPipeError:
            pass
        except (ValueError, json.JSONDecodeError) as err:
            self._send({"error": str(err)}, 400)
        except Exception as err:  # keep serving
            self._send({"error": repr(err)}, 500)


class SDFQueryServer:
    """Threaded HTTP JSON API around one engine (bare /sdf, /grad, ...
    routes) or a {name: engine} fleet (/scene/<name>/<route>)."""

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1"):
        engines = (dict(engine) if isinstance(engine, dict)
                   else {"0": engine})
        handler = type("Handler", (_QueryHandler,), {"engines": engines})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.engines = engines
        self.engine = next(iter(engines.values()))
        self._thread: Optional[threading.Thread] = None

    def start(self):
        _codec().submit(_decode, b"{}")   # the worker starts meanwhile
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve one or more trained SDF maps over HTTP")
    ap.add_argument("--checkpoint", required=True, action="append",
                    dest="checkpoints", metavar="[NAME=]PATH[+PATH...]",
                    help="a checkpoint archive (utils/checkpoint.py); repeat "
                         "to serve several maps under /scene/<NAME>/ (NAME "
                         "defaults to the index); '+' joins the members of "
                         "an ensemble served as one map")
    ap.add_argument("--config", default=None,
                    help="training config JSON (only for archives without "
                         "a stored model description)")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--chunk", type=int, default=1 << 16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = None
    if args.config:
        from isdf_tpu_torch.utils.config import load_config
        cfg = load_config(args.config)
    engines = {}
    for i, spec in enumerate(args.checkpoints):
        name, _, paths = spec.rpartition("=")
        members = [SDFQueryEngine.from_checkpoint(
            p, config=cfg, chunk_size=args.chunk, device=args.device)
            for p in paths.split("+")]
        engines[name or str(i)] = (members[0] if len(members) == 1
                                   else EnsembleEngine(members))
    srv = SDFQueryServer(engines if len(engines) > 1
                         else next(iter(engines.values())),
                         port=args.port, host=args.host).start()

    def _desc(e):
        i = e.info()
        return (f"ensemble of {i['ensemble']}" if "ensemble" in i
                else f"{i['param_count']} params on {i['device']}")

    print(f"serving {len(engines)} map(s) on http://{args.host}:"
          f"{srv.port} " + " ".join(
              f"[{k}: {_desc(e)}]" for k, e in engines.items()), flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
