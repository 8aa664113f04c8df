"""Offscreen 3-D renders without matplotlib: the camera, depth order and
fill of the mplot3d figures isdf_tpu draws (its vis/viewer.py
render_mesh_image / render_pointcloud_image and vis/composite.py
render_composite).

``View3D`` stands for one ``Axes3D`` as those functions set it up: a
``figsize=(size/100, size/100)``, ``dpi=100`` figure, ``set_axis_off()``,
``tight_layout(pad=0)``, cube limits, ``view_init(elev, azim)``. What it
copies from matplotlib 3.10, as constants and code:

* the projection: ``Axes3D.get_proj`` with its defaults (perspective,
  focal length 1, box aspect (4, 4, 3) scaled as ``set_box_aspect`` does,
  camera distance 10, roll 0, z up), ``proj3d.proj_transform`` and the
  data-to-pixel transform (``set_top_view``'s view limits [-0.095, 0.09]
  on both axes over the whole figure);
* the order: each ``Poly3DCollection`` face by its mean projected depth,
  farthest first (a stable sort, as ``sorted(..., reverse=True)``; a
  mesh's vertices are projected once each, not once a corner); each
  scatter's points by ``np.ma.argsort`` of their depths, reversed; the
  collections by their least depth, farthest first (``computed_zorder``),
  drawn above the lines of ``ax.plot``, which keep zorder 2;
* the colours: faces, points and lines at 8 bits, as Agg converts them.

The projection and the sorts run in numpy with matplotlib's own calls
(so equal depths order alike); the fill is host C++ (csrc/raster.cpp,
built by utils/native.py with g++): each path in turn blended over a white
figure by the fraction of each pixel it covers, exact along x and sampled
on 16 sub-scanlines a row. Primitives: filled triangles (``linewidths=0``),
round scatter markers of ``s`` points^2 (diameter ``sqrt(s) * dpi / 72``
pixels), polylines (projecting caps, round joins) and line collections
(butt caps), widths in points. There is no second route: without g++ a
render raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from isdf_tpu_torch.utils import native

DPI = 100.0
DIST = 10.0                       # Axes3D._dist
FOCAL_LENGTH = 1.0                # proj_type="persp"
VIEW_LO, VIEW_HI = -0.95 / DIST, 0.9 / DIST   # Axes3D.set_top_view
AXIS_ZORDER = 1.5                 # the 3-D axes' own zorder
LINE_ZORDER = 2.0                 # Line2D's default


def box_aspect() -> np.ndarray:
    """Axes3D.set_box_aspect(None): (4, 4, 3) scaled to matplotlib 3.9's
    apparent size."""
    aspect = np.asarray((4, 4, 3), dtype=float)
    aspect *= 1.8294640721620434 * 25 / 24 * 1 / np.linalg.norm(aspect)
    return aspect


def _norm_angle(a):
    a = (a + 360) % 360
    if a > 180:
        a = a - 360
    return a


def _world_transformation(xmin, xmax, ymin, ymax, zmin, zmax, pb_aspect):
    dx, dy, dz = xmax - xmin, ymax - ymin, zmax - zmin
    ax, ay, az = pb_aspect
    dx /= ax
    dy /= ay
    dz /= az
    return np.array([[1 / dx, 0, 0, -xmin / dx],
                     [0, 1 / dy, 0, -ymin / dy],
                     [0, 0, 1 / dz, -zmin / dz],
                     [0, 0, 0, 1]])


def proj_matrix(lims: Sequence[float], elev: float, azim: float
                ) -> np.ndarray:
    """Axes3D.get_proj() for limits (x0, x1, y0, y1, z0, z1)."""
    box = box_aspect()
    worldM = _world_transformation(*[float(v) for v in lims], box)
    R = 0.5 * box
    elev_rad, azim_rad = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(elev_rad) * np.cos(azim_rad),
                   np.cos(elev_rad) * np.sin(azim_rad),
                   np.sin(elev_rad)])
    eye = R + DIST * ps
    # Axes3D._calc_view_axes, roll 0
    V = np.zeros(3)
    V[2] = -1 if abs(np.deg2rad(_norm_angle(elev))) > np.pi / 2 else 1
    w = eye - R
    w = w / np.linalg.norm(w)
    u = np.cross(V, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    eye_focal = R + DIST * ps * FOCAL_LENGTH
    Mr, Mt = np.eye(4), np.eye(4)
    Mr[:3, :3] = [u, v, w]
    Mt[:3, -1] = -eye_focal
    viewM = np.dot(Mr, Mt)
    zf, zb, e = -DIST, DIST, FOCAL_LENGTH
    projM = np.array([[e, 0, 0, 0], [0, e, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)],
                      [0, 0, -1, 0]])
    return np.dot(projM, np.dot(viewM, worldM))


def proj_transform(xs, ys, zs, M):
    """proj3d.proj_transform: (txs, tys, tzs)."""
    vec = np.array([xs, ys, zs, np.ones_like(xs)])
    vecw = np.dot(M, vec)
    w = vecw[3]
    return vecw[0] / w, vecw[1] / w, vecw[2] / w


def _clip(txs, tys, tzs):
    """The points proj3d._proj_transform_vec_clip keeps (perspective)."""
    return (-1 <= txs) & (txs <= 1) & (-1 <= tys) & (tys <= 1) & (tzs <= 0)


def to_pixels(txs, tys, size: int):
    """Projected coordinates -> image (x right, y down) pixel coordinates
    of a size x size figure: the axes' data-to-display transform, then
    the canvas's flip of y."""
    span = VIEW_HI - VIEW_LO
    px = (np.asarray(txs) - VIEW_LO) / span * size
    py = size - (np.asarray(tys) - VIEW_LO) / span * size
    return px, py


def rgb8(colors, n: int) -> np.ndarray:
    """[n, 3] float32 of 8-bit colour levels from RGB(A) floats in [0, 1]
    or '#rrggbb' strings, as Agg converts them (rounded)."""
    if isinstance(colors, str):
        h = colors.lstrip("#")
        c = np.array([[int(h[i:i + 2], 16) for i in (0, 2, 4)]],
                     np.float64)
    else:
        c = np.rint(np.clip(np.asarray(colors, np.float64).reshape(
            -1, np.shape(colors)[-1])[:, :3], 0, 1) * 255)
    if len(c) == 1:
        c = np.repeat(c, max(n, 1), axis=0)
    return np.ascontiguousarray(c, np.float32)


class _Artist:
    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)
        self.zorder = LINE_ZORDER


class View3D:
    """One mplot3d Axes3D at ``size`` pixels square (see the module
    docstring). Add artists in the order isdf_tpu adds them, then
    ``render()``."""

    def __init__(self, size: int):
        self.size = int(size)
        self.lims = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
        self.elev, self.azim = 30.0, -60.0
        self.artists: List[_Artist] = []

    def set_lims(self, x, y, z):
        self.lims = (x[0], x[1], y[0], y[1], z[0], z[1])

    def view_init(self, elev: float, azim: float):
        self.elev, self.azim = elev, azim

    def add_polys(self, tri: np.ndarray, facecolors, verts=None,
                  faces=None):
        """Poly3DCollection(tri [n, 3, 3], facecolors=..., linewidths=0).
        ``verts`` [V, 3] and ``faces`` [n, 3] with tri = verts[faces]
        project each vertex once instead of each corner (a mesh)."""
        tri = np.asarray(tri)
        if verts is None:
            verts = tri.reshape(-1, 3)
            faces = np.arange(len(verts)).reshape(-1, 3)
        faces = np.asarray(faces)
        if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
            raise ValueError("faces index outside the vertices")
        self.artists.append(_Artist(
            "polys", verts=np.asarray(verts),
            faces=np.ascontiguousarray(faces, np.int64), colors=facecolors,
            rgb=rgb8(facecolors, len(faces))))

    def scatter(self, pts: np.ndarray, colors, s: float):
        """ax.scatter(x, y, z, c=colors, s=s, linewidths=0,
        depthshade=False)."""
        pts = np.asarray(pts)
        self.artists.append(_Artist("points", pts=pts, s=float(s),
                                    colors=colors,
                                    rgb=rgb8(colors, len(pts))))

    def plot(self, pts: np.ndarray, color, linewidth: float):
        """ax.plot(x, y, z, color=..., linewidth=...): one Line3D."""
        self.artists.append(_Artist("line", pts=np.asarray(pts),
                                    lw=float(linewidth),
                                    rgb=rgb8(color, 1)[0]))

    def add_segments(self, segs: np.ndarray, color, linewidth: float):
        """Line3DCollection(segs [n, 2, 3], colors=..., linewidths=...)."""
        self.artists.append(_Artist("segments", segs=np.asarray(segs),
                                    lw=float(linewidth),
                                    rgb=rgb8(color, 1)[0]))

    # ---------------- projection and order ----------------
    def proj(self) -> np.ndarray:
        return proj_matrix(self.lims, self.elev, self.azim)

    def project(self, M, xyz: np.ndarray):
        """[n, 3] points -> (px, py, tz): image coordinates and the
        projected depth."""
        xyz = np.asarray(xyz)
        txs, tys, tzs = proj_transform(xyz[:, 0], xyz[:, 1], xyz[:, 2], M)
        px, py = to_pixels(txs, tys, self.size)
        return px, py, tzs

    def _project_artist(self, a: _Artist, M):
        """do_3d_projection of one artist: its primitives in draw order
        (``a.order``, ``a.xy``) and its sort key (None for a line)."""
        if a.kind == "polys":
            n = len(a.faces)
            if n == 0:
                a.order, a.xy = np.zeros(0, np.int64), np.zeros((0, 2))
                return np.nan
            xs, ys, zs = a.verts.T
            txs, tys, tzs = proj_transform(xs, ys, zs, M)
            tz = tzs[a.faces]
            face_z = (tz[:, 0] + tz[:, 1] + tz[:, 2]) / 3
            a.order = np.argsort(-face_z, kind="stable")
            px, py = to_pixels(txs, tys, self.size)
            a.xy = np.stack([px, py], -1)        # per vertex
            return np.min(tz)
        if a.kind == "points":
            if len(a.pts) == 0:
                a.order, a.xy = np.zeros(0, int), np.zeros((0, 2))
                return np.nan
            txs, tys, tzs = proj_transform(
                a.pts[:, 0], a.pts[:, 1], a.pts[:, 2], M)
            keep = _clip(txs, tys, tzs)
            a.order = np.ma.argsort(np.ma.masked_array(tzs, ~keep))[::-1]
            px, py = to_pixels(txs, tys, self.size)
            a.xy = np.stack([np.where(keep, px, np.nan),
                             np.where(keep, py, np.nan)], -1)
            vz = np.ma.masked_array(tzs, ~keep)
            return np.min(vz) if vz.size else np.nan
        if a.kind == "segments":
            xyz = a.segs.reshape(-1, 3)
            txs, tys, tzs = proj_transform(xyz[:, 0], xyz[:, 1],
                                           xyz[:, 2], M)
            px, py = to_pixels(txs, tys, self.size)
            a.order = np.arange(len(a.segs))
            a.xy = np.stack([px, py], -1).reshape(-1, 2, 2)
            minz = 1e9
            for zs in tzs.reshape(-1, 2):
                minz = min(minz, min(zs))
            return minz
        # line (Line3D.draw): masked where it leaves the view
        txs, tys, tzs = proj_transform(a.pts[:, 0], a.pts[:, 1],
                                       a.pts[:, 2], M)
        keep = _clip(txs, tys, tzs)
        px, py = to_pixels(txs, tys, self.size)
        a.order = np.arange(len(a.pts))
        a.xy = np.stack([np.where(keep, px, np.nan),
                         np.where(keep, py, np.nan)], -1)
        return None

    def draw_order(self) -> List[_Artist]:
        """Project every artist and return them in matplotlib's draw
        order: Axes3D.draw's computed zorder of the collections (sorted by
        their key, farthest first), then Axes.draw's stable sort of all
        artists by zorder."""
        M = self.proj()
        keys = [(a, self._project_artist(a, M)) for a in self.artists]
        zo = AXIS_ZORDER + 1
        for a, _ in sorted([k for k in keys if k[0].kind != "line"],
                           key=lambda k: k[1], reverse=True):
            a.zorder = zo
            zo += 1
        return sorted(self.artists, key=lambda a: a.zorder)

    # ---------------- fill ----------------
    def render(self) -> np.ndarray:
        """The figure as uint8 RGB [size, size, 3]."""
        lib = native.load("raster")
        if lib is None:
            raise RuntimeError(
                "vis/raster.py: csrc/raster.cpp did not build (g++ is "
                "needed for the 3-D renders)")
        S = self.size
        img = np.full((S, S, 3), 255.0, np.float32)
        f32 = ctypes.POINTER(ctypes.c_float)
        f64 = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.POINTER(ctypes.c_int64)

        def p32(x):
            return x.ctypes.data_as(f32)

        def p64(x):
            return x.ctypes.data_as(f64)

        for a in self.draw_order():
            if a.kind == "polys":
                xy = np.ascontiguousarray(a.xy, np.float64)
                order = np.ascontiguousarray(a.order, np.int64)
                lib.raster_tris(p32(img), S, S, p64(xy),
                                a.faces.ctypes.data_as(i64),
                                order.ctypes.data_as(i64), p32(a.rgb),
                                len(order))
            elif a.kind == "points":
                xy = np.ascontiguousarray(a.xy[a.order], np.float64)
                rgb = np.ascontiguousarray(a.rgb[a.order])
                radius = 0.5 * np.sqrt(a.s) * DPI / 72.0
                lib.raster_discs(p32(img), S, S, p64(xy), p32(rgb),
                                 len(xy), radius)
            elif a.kind == "segments":
                xy = np.ascontiguousarray(a.xy, np.float64)
                lib.raster_segments(p32(img), S, S, p64(xy), len(xy),
                                    a.lw * DPI / 72.0, p32(a.rgb))
            else:
                xy = np.ascontiguousarray(a.xy, np.float64)
                lib.raster_polyline(p32(img), S, S, p64(xy), len(xy),
                                    a.lw * DPI / 72.0, p32(a.rgb), 1)
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)

