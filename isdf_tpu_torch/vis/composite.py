"""3-D composite scene view: mesh + keyframe frustums + trajectory + live
depth pointcloud in one render (isdf_tpu/vis/composite.py).

The reference GUI composes this content in its widget3d scene
(isdf/visualisation/isdf_window.py: the reconstructed mesh, per-keyframe
camera frustums, the current camera and the latest depth pointcloud) with
the camera geometry of isdf/visualisation/draw3D.py:16-108. Here the
scene is assembled in numpy and drawn by the port's rasteriser
(vis/raster.py), as isdf_tpu draws it with matplotlib.

Every input is host-side numpy (the Trainer's FrameStore mirrors), so a
render never reads the device tensors that the training loop updates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from isdf_tpu_torch.vis import raster as RS
from isdf_tpu_torch.vis.colormaps import turbo
from isdf_tpu_torch.vis.viewer import mesh_shades

MESH_COLOR = np.array([0.72, 0.78, 0.84])
KF_COLOR = "#ffb347"      # keyframe frustums (reference: orange wireframe)
CUR_COLOR = "#ff3b30"     # current camera (reference: red, larger)
TRAJ_COLOR = "#4da3ff"    # camera trajectory polyline
PC_COLOR = "#8fd18f"      # the depth pointcloud without values


def frustum_segments(T_WC: np.ndarray, fx: float, fy: float,
                     cx: float, cy: float, W: int, H: int,
                     depth: float = 0.35) -> np.ndarray:
    """Wireframe camera frustum: 8 segments (4 rays from the optical
    centre to the image corners at ``depth``, 4 closing the far
    rectangle), reference draw3D.py:16-48."""
    T_WC = np.asarray(T_WC, np.float64)
    corners = np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]],
                       np.float64)
    dirs = np.stack([(corners[:, 0] - cx) / fx,
                     (corners[:, 1] - cy) / fy,
                     np.ones(4)], axis=1)
    pts_C = dirs * depth
    R, t = T_WC[:3, :3], T_WC[:3, 3]
    pts_W = pts_C @ R.T + t
    segs = []
    for i in range(4):
        segs.append([t, pts_W[i]])
        segs.append([pts_W[i], pts_W[(i + 1) % 4]])
    return np.asarray(segs, np.float32)


def backproject_depth(depth: np.ndarray, T_WC: np.ndarray,
                      fx: float, fy: float, cx: float, cy: float,
                      stride: int = 8, max_points: int = 20000):
    """Subsampled world pointcloud of one depth image. Returns (pts_W
    [n, 3], depth values [n]) for colouring."""
    d = np.asarray(depth, np.float32)[::stride, ::stride]
    H, W = d.shape
    vs, us = np.mgrid[0:H, 0:W]
    valid = d > 0
    z = d[valid]
    u = us[valid] * stride
    v = vs[valid] * stride
    pts_C = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], axis=1)
    if len(pts_C) > max_points:
        sel = np.random.default_rng(0).choice(len(pts_C), max_points,
                                              replace=False)
        pts_C, z = pts_C[sel], z[sel]
    T_WC = np.asarray(T_WC, np.float64)
    pts_W = pts_C @ T_WC[:3, :3].T + T_WC[:3, 3]
    return pts_W.astype(np.float32), z


def composite_view(
    verts: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    kf_poses: Optional[np.ndarray] = None,
    cur_pose: Optional[np.ndarray] = None,
    traj: Optional[np.ndarray] = None,
    pc_pts: Optional[np.ndarray] = None,
    pc_vals: Optional[np.ndarray] = None,
    cam: Optional[dict] = None,
    azim: float = 45.0,
    elev: float = 25.0,
    zoom: float = 1.0,
    size: int = 560,
    bounds: Optional[np.ndarray] = None,
) -> RS.View3D:
    """The composite figure of render_composite, not yet drawn."""
    view = RS.View3D(size)
    extent_pts = []

    if verts is not None and faces is not None and len(faces):
        tri = verts[faces]
        shade = mesh_shades(tri, ambient=0.25)[:, None]
        view.add_polys(tri, shade * MESH_COLOR, verts=verts, faces=faces)
        extent_pts.append(verts)

    if pc_pts is not None and len(pc_pts):
        if pc_vals is not None and len(pc_vals):
            v = np.asarray(pc_vals, np.float32)
            vn = (v - v.min()) / max(float(v.max() - v.min()), 1e-6)
            cols = turbo(vn)
        else:
            cols = PC_COLOR
        view.scatter(pc_pts, cols, s=1.2)
        extent_pts.append(pc_pts)

    if traj is not None and len(traj) >= 2:
        traj = np.asarray(traj, np.float32)
        view.plot(traj, TRAJ_COLOR, linewidth=1.4)
        extent_pts.append(traj)

    if kf_poses is not None and len(kf_poses) and cam is not None:
        segs = np.concatenate([
            frustum_segments(T, cam["fx"], cam["fy"], cam["cx"],
                             cam["cy"], cam["W"], cam["H"])
            for T in kf_poses])
        view.add_segments(segs, KF_COLOR, linewidth=0.9)
        extent_pts.append(np.asarray(kf_poses)[:, :3, 3])

    if cur_pose is not None and cam is not None:
        segs = frustum_segments(cur_pose, cam["fx"], cam["fy"],
                                cam["cx"], cam["cy"], cam["W"], cam["H"],
                                depth=0.5)
        view.add_segments(segs, CUR_COLOR, linewidth=2.0)
        extent_pts.append(np.asarray(cur_pose)[None, :3, 3])

    ref = (np.concatenate([np.asarray(p).reshape(-1, 3)
                           for p in extent_pts])
           if extent_pts else np.zeros((1, 3), np.float32))
    if bounds is not None and len(bounds):
        ref = np.asarray(bounds).reshape(-1, 3)
    lo, hi = ref.min(0), ref.max(0)
    c = (lo + hi) / 2
    r = max(float((hi - lo).max()) / 2, 1e-3) / max(float(zoom), 1e-2)
    view.set_lims((c[0] - r, c[0] + r), (c[1] - r, c[1] + r),
                  (c[2] - r, c[2] + r))
    view.view_init(elev=elev, azim=azim)
    return view


def render_composite(verts=None, faces=None, kf_poses=None, cur_pose=None,
                     traj=None, pc_pts=None, pc_vals=None, cam=None,
                     azim: float = 45.0, elev: float = 25.0,
                     zoom: float = 1.0, size: int = 560, bounds=None
                     ) -> np.ndarray:
    """Offscreen render of the composite scene, uint8 RGB [size, size, 3].
    Any element may be None. cam: dict(fx, fy, cx, cy, W, H) for the
    frustums; zoom > 1 moves the camera in; bounds: [n, 3] points fixing
    the axes box (defaults to the content)."""
    return composite_view(verts, faces, kf_poses, cur_pose, traj, pc_pts,
                          pc_vals, cam, azim, elev, zoom, size,
                          bounds).render()


def composite_from_trainer(trainer, verts=None, faces=None,
                           azim: float = 45.0, elev: float = 25.0,
                           zoom: float = 1.0, size: int = 560,
                           show_mesh: bool = True,
                           show_frustums: bool = True,
                           show_traj: bool = True,
                           show_pc: bool = False) -> np.ndarray:
    """Build the composite inputs from a Trainer's host state (FrameStore
    numpy mirrors) and render. verts/faces: a cached reconstruction;
    None re-meshes when show_mesh."""
    cam = dict(fx=trainer.fx, fy=trainer.fy, cx=trainer.cx,
               cy=trainer.cy, W=trainer.W, H=trainer.H)
    kf_poses = cur_pose = traj = pc_pts = pc_vals = None
    if len(trainer.frames):
        T = trainer.frames.T_WC_batch_np()
        if show_frustums:
            kf_poses, cur_pose = T[:-1], T[-1]
        if show_traj:
            traj = T[:, :3, 3]
        if show_pc:
            f = trainer.frames[-1]
            pc_pts, pc_vals = backproject_depth(
                f.depth, f.T_WC, cam["fx"], cam["fy"], cam["cx"],
                cam["cy"])
    if show_mesh and verts is None:
        from isdf_tpu_torch.vis.mesh_export import reconstruct_mesh
        verts, faces = reconstruct_mesh(trainer)
    if not show_mesh:
        verts = faces = None
    return render_composite(
        verts=verts, faces=faces, kf_poses=kf_poses, cur_pose=cur_pose,
        traj=traj, pc_pts=pc_pts, pc_vals=pc_vals, cam=cam,
        azim=azim, elev=elev, zoom=zoom, size=size)
