"""Headless SDF viewers and renders (isdf_tpu/vis/viewer.py; reference
isdf/visualisation/sdf_viewer.py, isdf_window.py).

* SDFSliceViewer: slices of an SDF grid through the surface-band colormap
  (the reference SDFViewer's slice mode), saved as PNGs;
* SDFPointcloudViewer: z-slabs of a scattered SDF pointcloud (its
  ``sdf_pc`` mode), rendered through vis/raster.py;
* render_mesh_image / render_pointcloud_image: isdf_tpu's matplotlib
  mplot3d renders, through the port's rasteriser (vis/raster.py);
* save_level_sets, save_traj_seq, mesh_turntable: render sequences;
* monitor: one live frame of keyframes + the latest render + the
  compute-balance text, as train_vis writes it.

``show()`` opens a matplotlib window in isdf_tpu. The card host has no
display and the port no matplotlib, so here it serves the viewer's own
images through the HTTP viewer (vis/server.py) on a port; the page's
slider and arrow keys scrub as matplotlib's scroll and keys did.
"""

from __future__ import annotations

import os

import numpy as np

from isdf_tpu_torch.utils import image_io as IO
from isdf_tpu_torch.vis import raster as RS
from isdf_tpu_torch.vis.slices import sdf_colormap



def _serve(source, port: int, block: bool):
    """Serve a vis/server.py source: until ctrl-c with ``block``, else
    return the started SDFWebViewer (the caller stops it)."""
    from isdf_tpu_torch.vis.server import SDFWebViewer
    web = SDFWebViewer(source, port=port)
    if block:
        web.serve_until_interrupted()
        return None
    print(f"serving on http://127.0.0.1:{web.port}", flush=True)
    return web.start()


class SDFSliceViewer:
    """Slices of a dense SDF grid; ``save(dir)`` writes every ``stride``-th
    slice as PNG."""

    def __init__(self, sdf_grid: np.ndarray, up_ix: int = 1,
                 sdf_range=(-2.0, 2.0)):
        self.grid = np.asarray(sdf_grid)
        self.up_ix = up_ix
        self.sdf_range = sdf_range
        self.idx = self.grid.shape[up_ix] // 2

    def _slice_img(self, i):
        sl = np.take(self.grid, i, axis=self.up_ix)
        return sdf_colormap(sl, self.sdf_range)

    def save(self, out_dir: str, stride: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        n = self.grid.shape[self.up_ix]
        for i in range(0, n, stride):
            IO.imwrite(os.path.join(out_dir, f"slice_{i:04d}.png"),
                       self._slice_img(i)[..., ::-1])

    def show(self, port: int = 8787, block: bool = True):
        """Serve the slices over HTTP (vis/server.py) with the grid's
        up_ix and this viewer's sdf_range; slice i is _slice_img(i)
        repeated 3-fold. ``block=False`` returns the started server."""
        from isdf_tpu_torch.vis.server import ViewerSource
        src = ViewerSource.from_grid(self.grid, up_ix=self.up_ix)
        src.sdf_range = tuple(self.sdf_range)
        return _serve(src, port, block)


class SDFPointcloudViewer:
    """Z-slabs of a scattered SDF pointcloud [n, 4] = (xyz, sdf): z
    quantised into at most ``max_slabs`` levels by the integer slab index,
    one slab rendered at a time with the surface-band colormap."""

    def __init__(self, sdf_pc: np.ndarray, max_slabs: int = 40,
                 sdf_range=None, up_ix: int = 2):
        pc = np.asarray(sdf_pc, np.float32).copy()
        assert pc.ndim == 2 and pc.shape[1] == 4, "sdf_pc must be [n,4]"
        self.up_ix = up_ix
        z = pc[:, up_ix]
        zs = np.unique(z)
        if len(zs) > max_slabs:
            z0 = float(z.min())
            step = (float(z.max()) - z0) / (max_slabs - 1)
            idx = np.clip(np.floor((z - z0) / step), 0, max_slabs - 1)
            pc[:, up_ix] = (z0 + idx * step).astype(np.float32)
            zs = np.unique(pc[:, up_ix])
        self.pc = pc
        self.zs = zs
        if sdf_range is None:
            # the diverging colormap needs vmin < 0 < vmax
            sdf_range = (min(float(pc[:, 3].min()), -1e-3),
                         max(float(pc[:, 3].max()), 1e-3))
        self.sdf_range = sdf_range
        self.idx = len(zs) // 2

    def _slab_img(self, i, size=480):
        m = self.pc[:, self.up_ix] == self.zs[i]
        pts = self.pc[m, :3]
        cols = sdf_colormap(self.pc[m, 3][None, :],
                            self.sdf_range)[0] / 255.0
        return render_pointcloud_image(pts, cols, size=size,
                                       bounds=self.pc[:, :3])

    def save(self, out_dir: str, stride: int = 1):
        os.makedirs(out_dir, exist_ok=True)
        for i in range(0, len(self.zs), stride):
            IO.imwrite(os.path.join(out_dir, f"slab_{i:04d}.png"),
                       self._slab_img(i)[..., ::-1])

    def show(self, port: int = 8787, block: bool = True):
        """Serve the slabs over HTTP (vis/server.py::SlabSource): slice i
        is _slab_img(i), a query reports slab i's z. ``block=False``
        returns the started server."""
        from isdf_tpu_torch.vis.server import SlabSource
        return _serve(SlabSource(self), port, block)


def mesh_shades(tri: np.ndarray, ambient: float = 0.3) -> np.ndarray:
    """Lambert term of each face's normal against the light (0.4, 0.6,
    0.7): ambient + (1 - ambient) * clip(n . l, 0, 1), per face [n]."""
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    light = np.array([0.4, 0.6, 0.7])
    return ambient + (1 - ambient) * np.clip(n @ light, 0, 1)


def mesh_view(verts: np.ndarray, faces: np.ndarray, azim: float = 45.0,
              elev: float = 25.0, size: int = 640) -> RS.View3D:
    """render_mesh_image's figure: grey-blue Lambert-shaded faces in a
    cube around the vertices."""
    view = RS.View3D(size)
    tri = verts[faces]
    shade = mesh_shades(tri)
    col = np.stack([shade, shade, shade * 0.95], axis=1)
    view.add_polys(tri, col, verts=verts, faces=faces)
    lo, hi = verts.min(0), verts.max(0)
    c = (lo + hi) / 2
    r = (hi - lo).max() / 2
    view.set_lims((c[0] - r, c[0] + r), (c[1] - r, c[1] + r),
                  (c[2] - r, c[2] + r))
    view.view_init(elev=elev, azim=azim)
    return view


def render_mesh_image(verts: np.ndarray, faces: np.ndarray,
                      azim: float = 45.0, elev: float = 25.0,
                      size: int = 640) -> np.ndarray:
    """Offscreen shaded render of a mesh, uint8 RGB [size, size, 3]."""
    return mesh_view(verts, faces, azim, elev, size).render()


def render_pointcloud_image(pts: np.ndarray, cols: np.ndarray,
                            azim: float = 45.0, elev: float = 25.0,
                            size: int = 640, bounds=None) -> np.ndarray:
    """Offscreen scatter render of a coloured pointcloud (the headless
    counterpart of the reference viewer's trimesh.PointCloud scenes)."""
    view = RS.View3D(size)
    if len(pts):
        view.scatter(pts, cols, s=1.0)
    ref = pts if bounds is None else np.asarray(bounds)
    if len(ref):
        lo, hi = ref.min(0), ref.max(0)
        c = (lo + hi) / 2
        r = max((hi - lo).max() / 2, 1e-3)
        view.set_lims((c[0] - r, c[0] + r), (c[1] - r, c[1] + r),
                      (c[2] - r, c[2] + r))
    view.view_init(elev=elev, azim=azim)
    return view.render()


def save_level_sets(trainer, out_dir: str, limits=None,
                    max_points: int = 200000, azim: float = 45.0):
    """Level-set render sequence: the SDF pointcloud stripped by lower
    limits, one frame a limit (the reference SDFViewer.save_level_sets,
    sdf_viewer.py:433-451)."""
    os.makedirs(out_dir, exist_ok=True)
    pts = trainer.grid_pc.cpu().numpy()
    sdf = trainer.sdf_fn(pts).reshape(-1)
    if limits is None:
        limits = np.linspace(sdf.min(), 0.5 * sdf.max(), 12)
    rng = np.random.default_rng(0)
    bounds = pts[:: max(len(pts) // 1000, 1)]
    out = []
    for i, lim in enumerate(limits):
        keep = sdf > lim
        p = pts[keep]
        s = sdf[keep]
        if len(p) > max_points:
            sel = rng.choice(len(p), max_points, replace=False)
            p, s = p[sel], s[sel]
        cols = sdf_colormap(s).astype(np.float32) / 255.0
        img = render_pointcloud_image(p, cols, azim=azim, bounds=bounds)
        fname = os.path.join(out_dir, f"{i:04d}.png")
        IO.imwrite(fname, img[..., ::-1])
        out.append(fname)
    return out


def save_traj_seq(trainer, out_dir: str, poses=None, stride: int = 1):
    """Trajectory fly-through: the reconstruction rendered from each
    camera pose's look direction (the reference SDFViewer.save_seq,
    sdf_viewer.py:452-486)."""
    from isdf_tpu_torch.vis.mesh_export import reconstruct_mesh

    os.makedirs(out_dir, exist_ok=True)
    if poses is None:
        poses = trainer.frames.T_WC_batch_np()
    poses = np.asarray(poses)[::stride]
    verts, faces = reconstruct_mesh(trainer)
    if len(faces) == 0:
        return []
    out = []
    for i, T in enumerate(poses):
        # look direction -> azim/elev for the offscreen camera
        fwd = T[:3, 2]
        azim = float(np.degrees(np.arctan2(fwd[1], fwd[0])))
        elev = float(np.degrees(np.arcsin(np.clip(-fwd[2], -1, 1))))
        img = render_mesh_image(verts, faces, azim=azim, elev=elev)
        fname = os.path.join(out_dir, f"{i:04d}.png")
        IO.imwrite(fname, img[..., ::-1])
        out.append(fname)
    return out


def mesh_turntable(trainer, out_dir: str, n_views: int = 8):
    """Ring of offscreen mesh renders, ``view_XX.png``. Returns the
    triangle count rendered (0: no surface, no file)."""
    from isdf_tpu_torch.vis.mesh_export import reconstruct_mesh

    os.makedirs(out_dir, exist_ok=True)
    verts, faces = reconstruct_mesh(trainer)
    if len(faces) == 0:
        return 0
    # render_mesh_image's figure, its faces and shades built once
    view = mesh_view(verts, faces)
    for i in range(n_views):
        view.view_init(elev=25.0, azim=360.0 * i / n_views)
        IO.imwrite(os.path.join(out_dir, f"view_{i:02d}.png"),
                   view.render()[..., ::-1])
    return len(faces)


def monitor(trainer, out_dir: str, tag: str = "", times=None):
    """One monitoring frame: ``{tag}keyframes.png`` and ``{tag}latest.png``
    (the latest render with the compute balance). ``times``: a dict that
    gets the seconds of the latest-frame render ("latest") and of the
    writes ("write")."""
    import time

    from isdf_tpu_torch.vis import text as TX
    from isdf_tpu_torch.vis.views import keyframe_strip, latest_frame_vis

    os.makedirs(out_dir, exist_ok=True)
    if len(trainer.frames) == 0:
        return
    t0 = time.perf_counter()
    strip = keyframe_strip(trainer)
    latest = latest_frame_vis(trainer)
    # perf readout on the live panel (reference GUI's compute-balance
    # label, isdf_window.py:694-708)
    bal = trainer.perf_summary()
    if bal:
        txt = (f"{bal.get('steps_per_sec', 0):.0f} steps/s  "
               + " ".join(f"{k}:{v:.1f}s" for k, v in bal.items()
                          if k != "steps_per_sec"))
        latest = np.ascontiguousarray(latest)
        TX.put_text(latest, txt, (8, 18), 0.45, (255, 255, 0))
    t1 = time.perf_counter()
    IO.imwrite(os.path.join(out_dir, f"{tag}keyframes.png"),
               strip[..., ::-1])
    IO.imwrite(os.path.join(out_dir, f"{tag}latest.png"),
               latest[..., ::-1])
    if times is not None:
        times["latest"] = times.get("latest", 0.0) + t1 - t0
        times["write"] = times.get("write", 0.0) + time.perf_counter() - t1
