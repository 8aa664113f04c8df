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

A query is cut into chunks of ``chunk_size`` points, run on the engine's
device, gathered there and fetched once. The forward and its gradient are
the eager float32 ``apply`` / ``sdf_and_grad``. A served map owns a copy
of the parameters, since the trainer updates its own in place;
``refresh_from_trainer`` swaps in a new copy atomically.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from isdf_tpu_torch.eval.metrics import chomp_cost, linear_cost
from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.utils.device import resolve_device

# cap per request: 1M points (12 MB of float32 xyz); bigger batches stream
# several requests
MAX_POINTS = 1 << 20


def param_count(params, model: M.SDFModel) -> int:
    """Trained entries of the map: the layer weights and biases (not the
    packed planes' padding), and B with the Gaussian embedding."""
    n = sum(w.numel() + b.numel() for w, b in M.unpack(params, model))
    return n + (params["B"].numel() if "B" in params else 0)


def _collision(sdf, margin: float) -> Dict[str, Any]:
    below = sdf <= margin
    return {"min_sdf": float(sdf.min()) if sdf.size else float("inf"),
            "argmin": int(sdf.argmin()) if sdf.size else -1,
            "n_below": int(below.sum()),
            "collides": bool(below.any())}


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
                    mm_precision=config.mm_precision)
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
        pts = np.ascontiguousarray(pts, np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"points must be [N,3], got {pts.shape}")
        n = pts.shape[0]
        if n > MAX_POINTS:
            raise ValueError(f"{n} points exceeds the {MAX_POINTS} cap; "
                             "stream multiple requests")
        if not np.isfinite(pts).all():
            # JSON's NaN / Infinity tokens parse, but would come back as
            # bare NaN, which strict JSON clients reject
            raise ValueError("points contain non-finite values")
        with self._lock:
            params, transform = self.params, self.transform
        if n == 0:
            return np.zeros((0, 3) if grad else (0,), np.float32)
        x = torch.from_numpy(pts).to(self.device)
        K = self.chunk_size
        out = []
        for i in range(0, n, K):
            if grad:
                out.append(M.sdf_and_grad(params, x[i:i + K], self.model,
                                          transform=transform)[1])
            else:
                with torch.no_grad():
                    out.append(M.apply(params, x[i:i + K], self.model,
                                       transform=transform))
        return torch.cat(out).cpu().numpy()

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
                "param_count": param_count(self.params, self.model),
                "embedding_size": self.model.embedding_size,
                "hidden_size": self.model.hidden_size,
                "chunk_size": self.chunk_size,
                "max_points": MAX_POINTS,
                "device": str(self.device),
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

    def _send(self, obj, code=200, close=False):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if close:
            self.close_connection = True
            self.send_header("Connection", "close")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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
            req = json.loads(self.rfile.read(n) or b"{}")
            pts = np.asarray(req.get("points", []), np.float32)
            if pts.size == 0:
                return self._send({"error": "no points"}, 400)
            e, p, err = self._resolve()
            if err:
                return self._send(err, 404)
            if p == "/sdf":
                return self._send({"sdf": e.sdf(pts).tolist()})
            if p == "/grad":
                return self._send({"grad": e.grad(pts).tolist()})
            if p == "/collision":
                return self._send(
                    e.collision(pts, margin=float(req.get("margin", 0.0))))
            if p == "/query":
                sdf = e.sdf(pts)
                out = {"sdf": sdf.tolist(),
                       "chomp_cost": np.asarray(chomp_cost(
                           sdf, epsilon=float(req.get("epsilon", 2.0)))
                       ).tolist()}
                if req.get("grad", True):
                    out["grad"] = e.grad(pts).tolist()
                return self._send(out)
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
