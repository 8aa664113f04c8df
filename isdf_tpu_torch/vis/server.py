"""Interactive SDF viewer served over HTTP, stdlib only (isdf_tpu
vis/server.py; reference isdf_window.py:29-806, sdf_viewer.py:66-498).

The reference ships an Open3D app and a trimesh/pyglet slice viewer; the
card host has no display, so the page is controls and images in a
browser and the model stays on the card:

  * slice scrubbing through the SDF volume (slider / arrow keys), with
    click-to-query: a pixel reports its world point and SDF value;
  * an orbiting shaded mesh render (vis/viewer.py::render_mesh_image) and
    the navigable 3-D scene (vis/composite.py): mesh, keyframe frustums,
    trajectory, the latest depth as points;
  * the keyframe strip, live training scalars and the training controls
    (pause, iterations a step, monitor toggles) when attached to a
    Trainer;
  * a refresh that re-snapshots grid and mesh from the live parameters.

PNGs come from the port's codec (utils/image_io.py::encode_png).

With ``loop_attached`` (``train_vis --serve``) the training loop owns the
trainer, and no handler thread touches a CUDA tensor: queries read the
snapshot grid, refreshes run on the loop's thread (``refresh_if_watched``
from the monitor or the control hook), ``status`` reads host numbers and
the 3-D scene reads the cached mesh and the frame store's host mirrors.
A source over a trainer that no loop runs (a checkpoint) evaluates on the
handler's thread, under utils/graphs.CAPTURE_LOCK: a loop that the caller
runs beside it may be capturing a step.

    viewer = SDFWebViewer(ViewerSource.from_trainer(trainer)).start()
    python -m isdf_tpu_torch.vis.server --grid sdf_grid.npy --port 8787
    python -m isdf_tpu_torch.vis.server --config cfg.json \\
        --load_checkpoint map.ckpt [--device cpu]
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.utils.graphs import CAPTURE_LOCK

MAX_BODY = 4096   # bytes of a POST body


def _png(img_rgb: np.ndarray) -> bytes:
    return IO.encode_png(np.ascontiguousarray(np.asarray(img_rgb)[..., ::-1]))


class ViewerSource:
    """Snapshot of an SDF volume, with optional live hooks.

    grid     : [D, D, D] SDF values
    grid_pc  : [D, D, D, 3] world coordinates of the lattice
    sdf_fn   : exact point queries (else the nearest grid value)
    trainer  : keyframes, status, refresh and the training controls
    """

    def __init__(self, grid: np.ndarray, grid_pc: np.ndarray,
                 sdf_fn=None, trainer=None, up_ix: int = 1,
                 loop_attached: bool = False):
        self.trainer = trainer
        self.sdf_fn = sdf_fn
        self.loop_attached = loop_attached
        self.up_ix = up_ix
        # _lock: the controls and the snapshot, held briefly (the loop
        # takes it); _draw_lock: the mesh cache and its draws
        self._lock, self._draw_lock = threading.Lock(), threading.Lock()
        self._mesh_cache = {}
        self.last_request = 0.0   # any HTTP hit bumps this (see _Handler)
        self.last_refresh = 0.0
        self.refresh_requested = False
        # the training controls (reference isdf_window.py:546-712: play /
        # pause, the iterations slider, the monitor's mesh and slices, the
        # 3-D scene's checkboxes), written by handler threads and read by
        # the loop between bundles; iters_per_step 0: the config's budget
        self.controls = {"paused": False, "iters_per_step": 0,
                         "do_mesh": True, "do_slices": True,
                         "scene_mesh": True, "scene_frustums": True,
                         "scene_traj": True, "scene_pc": False}
        self._set_grid(grid, grid_pc)

    def update_controls(self, d: dict) -> dict:
        """A control update from a handler thread: unknown keys ignored,
        values coerced and clamped. Returns the resulting controls."""
        with self._lock:
            if "paused" in d:
                self.controls["paused"] = bool(d["paused"])
            if "iters_per_step" in d:
                v = int(d["iters_per_step"])
                self.controls["iters_per_step"] = max(0, min(v, 10000))
            for k in ("do_mesh", "do_slices", "scene_mesh",
                      "scene_frustums", "scene_traj", "scene_pc"):
                if k in d:
                    self.controls[k] = bool(d[k])
            return dict(self.controls)

    def get_controls(self) -> dict:
        with self._lock:
            return dict(self.controls)

    def _set_grid(self, grid, grid_pc):
        grid = np.asarray(grid, np.float32)
        assert grid.ndim == 3, grid.shape
        self.grid = grid
        self.grid_pc = np.asarray(grid_pc, np.float32).reshape(
            grid.shape + (3,))
        self.version = getattr(self, "version", -1) + 1
        lo, hi = float(grid.min()), float(grid.max())
        self.sdf_range = (min(lo, -1e-3), max(hi, 1e-3))
        self._verts = self._faces = None

    # -- constructors --------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer, up_ix: Optional[int] = None,
                     loop_attached: bool = False):
        """The trainer's dense grid and lattice, fetched to the host (the
        lattice is a device tensor of the trainer)."""
        d = trainer.grid_dim
        pc = trainer.grid_pc.cpu().numpy().reshape(d, d, d, 3)
        return cls(trainer.get_sdf_grid(), pc, sdf_fn=trainer.sdf_fn,
                   trainer=trainer,
                   up_ix=getattr(trainer, "up_ix", 1)
                   if up_ix is None else up_ix,
                   loop_attached=loop_attached)

    @classmethod
    def from_grid(cls, grid: np.ndarray, extents=None, centre=(0, 0, 0),
                  sdf_fn=None, up_ix: int = 1):
        grid = np.asarray(grid, np.float32)
        if extents is None:
            extents = (2.0, 2.0, 2.0)
        axes = [np.linspace(c - e / 2, c + e / 2, n) for c, e, n in
                zip(centre, np.broadcast_to(extents, (3,)), grid.shape)]
        pc = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        return cls(grid, pc, sdf_fn=sdf_fn, up_ix=up_ix)

    # -- content -------------------------------------------------------
    def n_slices(self) -> int:
        return self.grid.shape[self.up_ix]

    def slice_png(self, i: int, scale: int = 3) -> bytes:
        from isdf_tpu_torch.vis.slices import sdf_colormap
        i = int(np.clip(i, 0, self.n_slices() - 1))
        img = sdf_colormap(np.take(self.grid, i, axis=self.up_ix),
                           self.sdf_range)
        if scale > 1:
            img = np.repeat(np.repeat(img, scale, 0), scale, 1)
        return _png(img)

    def query(self, i: int, r: int, c: int):
        """Slice pixel (slice i, row r, col c) -> world point and SDF."""
        other = [a for a in range(3) if a != self.up_ix]
        idx = [0, 0, 0]
        idx[self.up_ix] = int(np.clip(i, 0, self.n_slices() - 1))
        idx[other[0]] = int(np.clip(r, 0, self.grid.shape[other[0]] - 1))
        idx[other[1]] = int(np.clip(c, 0, self.grid.shape[other[1]] - 1))
        pt = self.grid_pc[tuple(idx)]
        if self.sdf_fn is not None and not self.loop_attached:
            with CAPTURE_LOCK:
                sdf = float(np.asarray(self.sdf_fn(
                    pt[None].astype(np.float32))).reshape(-1)[0])
        else:
            # loop-attached: the loop owns the device, so a query reads the
            # snapshot grid (exact at lattice points after a refresh)
            sdf = float(self.grid[tuple(idx)])
        return {"point": [round(float(v), 4) for v in pt],
                "sdf": round(sdf, 5),
                "grid_sdf": round(float(self.grid[tuple(idx)]), 5)}

    def _ensure_mesh(self):
        """(version, verts, faces) of the current snapshot, marched once a
        version. The march runs outside ``_lock``, which the loop takes
        for the controls and its refresh: a refresh may swap the grid
        meanwhile, and then the mesh is not kept."""
        with self._lock:
            version, grid, pc = self.version, self.grid, self.grid_pc
            verts, faces = self._verts, self._faces
        if faces is None:
            from isdf_tpu_torch.utils import mesh3d
            verts_idx, faces = mesh3d.marching_tetrahedra(grid)
            if len(verts_idx):
                # index space -> world through the lattice's corners (the
                # lattice is affine)
                lo, hi = pc[0, 0, 0], pc[-1, -1, -1]
                span = np.asarray(grid.shape, np.float32) - 1
                verts = lo + verts_idx / span * (hi - lo)
            else:
                verts = verts_idx
            with self._lock:
                if self.version == version:
                    self._verts, self._faces = verts, faces
        return version, verts, faces

    def _cached_png(self, key, draw) -> bytes:
        """The PNG of draw(verts, faces) on the snapshot's mesh, cached by
        (version, key). Draws hold ``_draw_lock`` (one at a time), never
        ``_lock``: the loop reads the controls between bundles and would
        otherwise wait out a render."""
        with self._draw_lock:
            with self._lock:
                version = self.version
            png = self._mesh_cache.get((version, key))
            if png is None:
                version, verts, faces = self._ensure_mesh()
                png = _png(draw(verts, faces))
                if len(self._mesh_cache) > 64:
                    self._mesh_cache.clear()
                self._mesh_cache[(version, key)] = png
        return png

    def render_png(self, azim: float, elev: float) -> bytes:
        def draw(verts, faces):
            if len(faces) == 0:
                return np.full((480, 480, 3), 32, np.uint8)
            from isdf_tpu_torch.vis.viewer import render_mesh_image
            return render_mesh_image(verts, faces, azim=azim, elev=elev,
                                     size=480)
        return self._cached_png((round(azim), round(elev)), draw)

    def scene_png(self, azim: float, elev: float,
                  zoom: float = 1.0) -> bytes:
        """The 3-D composite scene (vis/composite.py) at a camera: the
        cached mesh, keyframe frustums, trajectory and, toggled on, the
        latest depth as points. Reads the mesh cache and the frame store's
        host mirrors only (the cached verts are never None, so
        composite_from_trainer does not mesh)."""
        from isdf_tpu_torch.vis.composite import (composite_from_trainer,
                                                  render_composite)
        ctl = self.get_controls()
        n_kf = len(self.trainer.frames) if self.trainer is not None else 0
        key = ("scene", n_kf, round(azim), round(elev),
               round(float(zoom), 2), ctl["scene_mesh"],
               ctl["scene_frustums"], ctl["scene_traj"], ctl["scene_pc"])

        def draw(verts, faces):
            if self.trainer is not None:
                return composite_from_trainer(
                    self.trainer, verts=verts, faces=faces,
                    azim=azim, elev=elev, zoom=zoom,
                    show_mesh=ctl["scene_mesh"],
                    show_frustums=ctl["scene_frustums"],
                    show_traj=ctl["scene_traj"], show_pc=ctl["scene_pc"])
            return render_composite(
                verts=verts if ctl["scene_mesh"] else None,
                faces=faces if ctl["scene_mesh"] else None,
                azim=azim, elev=elev, zoom=zoom)
        return self._cached_png(key, draw)

    def keyframes_png(self) -> Optional[bytes]:
        if self.trainer is None or len(self.trainer.frames) == 0:
            return None
        from isdf_tpu_torch.vis.views import keyframe_strip
        return _png(keyframe_strip(self.trainer))

    def status(self):
        """Host numbers only: the trainer's step count and sim clock are
        Python numbers, perf_summary() its host timer."""
        out = {"version": self.version, "live": self.trainer is not None}
        if self.trainer is not None:
            out["paused"] = bool(self.controls["paused"])
            out["steps"] = int(self.trainer.steps_taken)
            out["keyframes"] = len(self.trainer.frames)
            out["sim_time_s"] = round(float(self.trainer.tot_step_time), 2)
            out.update({k: round(float(v), 4) for k, v in
                        self.trainer.perf_summary().items()})
        return out

    def refresh(self):
        """Re-snapshot the grid (and lazily the mesh) from the trainer.
        Loop-attached, only the loop's thread calls it (through
        refresh_if_watched); a handler thread asks with request_refresh."""
        if self.trainer is None:
            return {"refreshed": False}
        d = self.trainer.grid_dim
        # loop-attached, this is the loop's thread, which captures itself
        with (contextlib.nullcontext() if self.loop_attached
              else CAPTURE_LOCK):
            grid = self.trainer.get_sdf_grid()
            pc = self.trainer.grid_pc.cpu().numpy().reshape(d, d, d, 3)
        with self._lock:
            self._set_grid(grid, pc)
            self.last_refresh = time.time()
            self.refresh_requested = False
        return {"refreshed": True, "version": self.version}

    def request_refresh(self):
        """Handler-thread entry. Loop-attached: mark a refresh pending for
        the loop's next monitor or control tick. Else refresh inline."""
        if self.trainer is None:
            return {"refreshed": False}
        if not self.loop_attached:
            return self.refresh()
        self.refresh_requested = True
        return {"refreshed": False, "pending": True,
                "version": self.version}

    def refresh_if_watched(self):
        """Refresh only when a browser asked, or touched the server since
        the last snapshot: an idle viewer bills no grid evaluation to the
        run. Called on the loop's thread."""
        if self.trainer is not None and (
                self.refresh_requested
                or self.last_request > self.last_refresh):
            return self.refresh()
        return {"refreshed": False}

    def meta(self):
        other = [a for a in range(3) if a != self.up_ix]
        return {"shape": list(self.grid.shape), "up_ix": self.up_ix,
                "n_slices": self.n_slices(),
                "sdf_range": [round(v, 4) for v in self.sdf_range],
                "row_axis": other[0], "col_axis": other[1],
                "live": self.trainer is not None, "version": self.version}


class SlabSource(ViewerSource):
    """The z-slabs of a scattered SDF pointcloud (vis/viewer.py::
    SDFPointcloudViewer): slice i is the viewer's slab image i, a query
    reports the slab's z. The mesh and scene panels stay empty."""

    def __init__(self, viewer):
        n = len(viewer.zs)
        # a lattice of n slices, all outside the surface: no mesh
        super().__init__(np.ones((2, n, 2), np.float32),
                         np.zeros((2, n, 2, 3), np.float32), up_ix=1)
        self.viewer = viewer
        self.sdf_range = tuple(viewer.sdf_range)

    def slice_png(self, i: int, scale: int = 1) -> bytes:
        i = int(np.clip(i, 0, self.n_slices() - 1))
        return _png(self.viewer._slab_img(i))

    def query(self, i: int, r: int, c: int):
        i = int(np.clip(i, 0, self.n_slices() - 1))
        return {"slab": i, "z": round(float(self.viewer.zs[i]), 4)}


INDEX_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>isdf_tpu_torch viewer</title><style>
body{background:#14161a;color:#d7dae0;font:14px system-ui;margin:0}
#bar{padding:8px 14px;background:#1d2026;display:flex;gap:18px;
     align-items:center;flex-wrap:wrap}
.panel{display:inline-block;vertical-align:top;margin:14px;text-align:center}
img{image-rendering:pixelated;border:1px solid #333;max-width:42vw}
input[type=range]{width:220px;vertical-align:middle}
button{background:#2d323b;color:#d7dae0;border:1px solid #444;
       padding:4px 12px;border-radius:4px;cursor:pointer}
#q{color:#8fd18f;min-width:260px;display:inline-block}
#status{color:#9ab}
</style></head><body>
<div id="bar"><b>isdf_tpu_torch SDF viewer</b>
 <span>slice <input type=range id=sl min=0 max=0 value=0>
       <span id=sln></span></span>
 <span>azim <input type=range id=az min=0 max=360 value=45 step=15></span>
 <span>elev <input type=range id=el min=-90 max=90 value=25 step=15></span>
 <button id=rf>refresh from model</button>
 <button id=pp style="display:none">pause</button>
 <span id=ipsw style="display:none">iters/step
   <input type=number id=ips min=0 max=10000 value=0 step=10
          style="width:64px" title="0 = config budget"></span>
 <label id=dmw style="display:none"><input type=checkbox id=dm checked>
   mesh</label>
 <label id=dsw style="display:none"><input type=checkbox id=dsl checked>
   slices</label>
 <span id=q>click the slice to query the SDF</span>
 <span id=status></span></div>
<div class=panel><h3>SDF slice</h3><img id=slice></div>
<div class=panel><h3>mesh</h3><img id=mesh></div>
<div class=panel><h3>scene</h3>
  <div style="margin-bottom:6px">
   azim <input type=range id=saz min=0 max=360 value=45 step=15>
   elev <input type=range id=sel min=-90 max=90 value=25 step=15>
   zoom <input type=range id=szm min=0.5 max=4 value=1 step=0.25>
   <label><input type=checkbox id=smesh checked>mesh</label>
   <label><input type=checkbox id=sfru checked>frustums</label>
   <label><input type=checkbox id=straj checked>traj</label>
   <label><input type=checkbox id=spc>pointcloud</label>
  </div><img id=scene></div>
<div class=panel id=kfp style="display:none"><h3>keyframes</h3>
  <img id=kf style="max-width:88vw"></div>
<script>
let meta=null,v=0;
const $=id=>document.getElementById(id);
async function loadMeta(){meta=await (await fetch('api/meta')).json();
  v=meta.version;$('sl').max=meta.n_slices-1;
  if(+$('sl').value==0)$('sl').value=Math.floor(meta.n_slices/2);
  if(meta.live){$('kfp').style.display='inline-block';
    $('kf').src='api/keyframes.png?v='+v;
    for(const id of['pp','ipsw','dmw','dsw'])
      $(id).style.display='inline-block';
    const c=await (await fetch('api/control')).json();applyCtl(c);}
  upd();}
function applyCtl(c){$('pp').textContent=c.paused?'resume':'pause';
  $('ips').value=c.iters_per_step;$('dm').checked=c.do_mesh;
  $('dsl').checked=c.do_slices;
  $('smesh').checked=c.scene_mesh;$('sfru').checked=c.scene_frustums;
  $('straj').checked=c.scene_traj;$('spc').checked=c.scene_pc;}
async function postCtl(d){const c=await (await fetch('api/control',
  {method:'POST',body:JSON.stringify(d)})).json();applyCtl(c);}
$('pp').onclick=()=>postCtl({paused:$('pp').textContent=='pause'});
$('ips').onchange=()=>postCtl({iters_per_step:+$('ips').value});
$('dm').onchange=()=>postCtl({do_mesh:$('dm').checked});
$('dsl').onchange=()=>postCtl({do_slices:$('dsl').checked});
function upd(){const i=$('sl').value;$('sln').textContent=i;
  $('slice').src=`api/slice/${i}.png?v=${v}`;
  $('mesh').src=`api/render.png?azim=${$('az').value}`+
                `&elev=${$('el').value}&v=${v}`;
  $('scene').src=`api/scene.png?azim=${$('saz').value}`+
                 `&elev=${$('sel').value}&zoom=${$('szm').value}&v=${v}`;}
for(const id of['sl','az','el','saz','sel','szm'])$(id).oninput=upd;
for(const[id,k]of[['smesh','scene_mesh'],['sfru','scene_frustums'],
                  ['straj','scene_traj'],['spc','scene_pc']])
  $(id).onchange=async()=>{await postCtl({[k]:$(id).checked});upd();};
document.addEventListener('keydown',e=>{
  if(e.key=='ArrowLeft'||e.key=='ArrowRight'){
    $('sl').value=+$('sl').value+(e.key=='ArrowRight'?1:-1);upd();}});
$('slice').onclick=async e=>{
  const r=e.target.getBoundingClientRect();
  const row=Math.floor(e.offsetY/r.height*meta.shape[meta.row_axis]);
  const col=Math.floor(e.offsetX/r.width*meta.shape[meta.col_axis]);
  const q=await (await fetch(
    `api/query?i=${$('sl').value}&r=${row}&c=${col}`)).json();
  $('q').textContent=('z' in q)?`slab ${q.slab}: z = ${q.z}`:
    `sdf(${q.point.map(x=>x.toFixed(2))}) = ${q.sdf}`;};
$('rf').onclick=async()=>{   // refresh is serviced by the train loop's
  const r=await (await fetch('api/refresh')).json();  // next monitor tick
  if(!r.pending){await loadMeta();return;}
  $('q').textContent='refresh pending…';
  for(let t=0;t<40;t++){await new Promise(d=>setTimeout(d,500));
    const m=await (await fetch('api/meta')).json();
    if(m.version!=v){await loadMeta();
      $('q').textContent='refreshed';return;}}
  $('q').textContent='refresh pending (loop busy)';};
setInterval(async()=>{const s=await (await fetch('api/status')).json();
  $('status').textContent=s.live?
    `step ${s.steps} · ${s.keyframes} kf · t=${s.sim_time_s}s`+
    (s.paused?' · PAUSED':''):'';
  if(s.live&&s.version!=v){v=s.version;upd();}},3000);
loadMeta();
</script></body></html>"""


def _json(obj) -> bytes:
    return json.dumps(obj).encode()


class _Handler(BaseHTTPRequestHandler):
    source: ViewerSource = None  # bound by SDFWebViewer

    def log_message(self, *a):  # quiet
        pass

    def _send(self, body, ctype, code=200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route_get(self, s: ViewerSource):
        """(body, content type) of a GET, or None for a 404."""
        u = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        p = u.path.rstrip("/") or "/"
        if p == "/":
            return INDEX_HTML.encode(), "text/html"
        if p == "/api/meta":
            return _json(s.meta()), "application/json"
        if p == "/api/status":
            return _json(s.status()), "application/json"
        if p == "/api/refresh":
            return _json(s.request_refresh()), "application/json"
        if p == "/api/control":
            return _json(s.get_controls()), "application/json"
        if p == "/api/query":
            return _json(s.query(int(q.get("i", 0)), int(q.get("r", 0)),
                                 int(q.get("c", 0)))), "application/json"
        if p.startswith("/api/slice/") and p.endswith(".png"):
            i = int(p[len("/api/slice/"):-len(".png")])
            return s.slice_png(i), "image/png"
        if p == "/api/render.png":
            return s.render_png(float(q.get("azim", 45)),
                                float(q.get("elev", 25))), "image/png"
        if p == "/api/scene.png":
            return s.scene_png(float(q.get("azim", 45)),
                               float(q.get("elev", 25)),
                               float(q.get("zoom", 1.0))), "image/png"
        if p == "/api/keyframes.png":
            body = s.keyframes_png()
            if body is not None:
                return body, "image/png"
        return None

    def do_GET(self):  # noqa: N802 (stdlib API)
        try:
            self.source.last_request = time.time()
            out = self._route_get(self.source)
            if out is None:
                return self._send(b"not found", "text/plain", 404)
            self._send(*out)
        except BrokenPipeError:  # the client went away mid-image
            pass
        except Exception as e:  # report to the client, keep serving
            self._send(_json({"error": repr(e)}), "application/json", 500)

    def do_POST(self):  # noqa: N802 (stdlib API)
        """POST /api/control with any subset of the controls (JSON);
        POST /api/refresh."""
        try:
            self.source.last_request = time.time()
            p = urlparse(self.path).path.rstrip("/")
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY:
                self.close_connection = True
                return self._send(b'{"error":"body too large"}',
                                  "application/json", 413)
            body = self.rfile.read(n) if n else b"{}"
            if p == "/api/control":
                try:
                    d = json.loads(body or b"{}")
                    if not isinstance(d, dict):
                        raise TypeError(f"expected an object, got {d!r}")
                    out = self.source.update_controls(d)
                except (ValueError, TypeError) as e:
                    return self._send(_json({"error": repr(e)}),
                                      "application/json", 400)
                return self._send(_json(out), "application/json")
            if p == "/api/refresh":
                return self._send(_json(self.source.request_refresh()),
                                  "application/json")
            self._send(b"not found", "text/plain", 404)
        except BrokenPipeError:
            pass
        except Exception as e:
            self._send(_json({"error": repr(e)}), "application/json", 500)


class SDFWebViewer:
    """A threaded HTTP server around a ViewerSource."""

    def __init__(self, source: ViewerSource, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("Handler", (_Handler,), {"source": source})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.source = source
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def serve_until_interrupted(self):
        """Serve on this thread until ctrl-c, then close."""
        print(f"serving on http://127.0.0.1:{self.port}  (ctrl-c to stop)",
              flush=True)
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.httpd.server_close()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="serve an SDF grid/checkpoint")
    ap.add_argument("--grid", type=str, help=".npy dense SDF grid [D,D,D]")
    ap.add_argument("--extents", type=float, nargs=3, default=None,
                    help="world size of the grid box (default 2 2 2)")
    ap.add_argument("--centre", type=float, nargs=3, default=(0, 0, 0))
    ap.add_argument("--config", type=str,
                    help="serve a Trainer built from this config instead")
    ap.add_argument("--load_checkpoint", type=str, default=None)
    ap.add_argument("--grid_dim", type=int, default=128)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--up", type=int, default=1)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu, with --config")
    args = ap.parse_args(argv)

    if args.config:
        from isdf_tpu_torch.engine.trainer import Trainer
        from isdf_tpu_torch.utils.config import load_config
        trainer = Trainer(load_config(args.config), grid_dim=args.grid_dim,
                          device=args.device)
        if args.load_checkpoint:
            trainer.load_checkpoint(args.load_checkpoint)
        src = ViewerSource.from_trainer(trainer, up_ix=args.up)
    else:
        if not args.grid:
            ap.error("--grid or --config required")
        src = ViewerSource.from_grid(np.load(args.grid),
                                     extents=args.extents,
                                     centre=args.centre, up_ix=args.up)
    SDFWebViewer(src, port=args.port).serve_until_interrupted()


if __name__ == "__main__":
    main()
