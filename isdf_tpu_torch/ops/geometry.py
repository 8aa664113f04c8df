"""Camera / 3-D geometry ops (isdf_tpu/ops/geometry.py in torch).

Conventions: camera rays use the z-depth convention (z component == 1);
poses are T_WC (camera-to-world) 4x4 row-major matrices; invalid pixels
carry NaN through backprojection and normal estimation and become explicit
masks at the sampling boundary.
"""

from __future__ import annotations

import numpy as np
import torch


def ray_dirs_C(H: int, W: int, fx, fy, cx, cy, device="cpu"):
    """Per-pixel camera-frame ray directions [H, W, 3] (z = 1)."""
    c = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    r = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    x = ((c - cx) / fx).expand(H, W)
    y = ((r - cy) / fy).expand(H, W)
    z = torch.ones((H, W), dtype=torch.float32, device=device)
    return torch.stack((x, y, z), dim=-1)


def origin_dirs_W(T_WC, dirs_C):
    """Rotate camera-frame dirs into the world frame; origins are the
    translations. T_WC [..., 4, 4]; dirs_C [..., 3]."""
    dirs_W = (T_WC[..., :3, :3] @ dirs_C[..., None])[..., 0]
    return T_WC[..., :3, 3], dirs_W


def transform_points(T, points):
    """Apply a rigid transform [4, 4] (or a batch) to points [..., 3]."""
    return (T[..., :3, :3] @ points[..., None])[..., 0] + T[..., :3, 3]


def pointcloud_from_depth(depth, fx, fy, cx, cy):
    """Backproject a depth map [H, W] to a pointcloud [H, W, 3]; NaN depth
    gives NaN points."""
    H, W = depth.shape
    c = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    r = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    return torch.stack((depth * (c - cx) / fx, depth * (r - cy) / fy, depth),
                       dim=-1)


def estimate_pointcloud_normals(points, d: int = 2):
    """Normals of an organised pointcloud [H, W, 3] from the best of the 8
    neighbour pairs (k, k+2 mod 8) at distance ``d``: the pair with the
    least total distance to the anchor, NaN neighbours never chosen, NaN
    where no valid pair exists (reference transform.py:215-270)."""
    H, W = points.shape[:2]
    pad = torch.full((H + 2 * d, W + 2 * d, 3), float("nan"),
                     dtype=points.dtype, device=points.device)
    pad[d:-d, d:-d] = points
    lookups = [(-d, 0), (-d, d), (0, d), (d, d),
               (d, 0), (d, -d), (0, -d), (-d, -d)]

    def shifted(off):
        dy, dx = off
        return pad[d + dy:d + dy + H, d + dx:d + dx + W]

    p1 = points
    p2s = torch.stack([shifted(lookups[k]) for k in range(8)])
    p3s = torch.stack([shifted(lookups[(k + 2) % 8]) for k in range(8)])
    diff = ((p2s - p1[None]).norm(dim=-1) + (p3s - p1[None]).norm(dim=-1))
    diff = torch.where(torch.isnan(diff), torch.inf, diff)
    k_best = diff.argmin(dim=0)[None, ..., None].expand(1, H, W, 3)
    p2 = torch.gather(p2s, 0, k_best)[0]
    p3 = torch.gather(p3s, 0, k_best)[0]
    n = torch.linalg.cross(p2 - p1, p3 - p1)
    return n / n.norm(dim=-1, keepdim=True)


def make_3D_grid(grid_range, dim: int, transform=None, scale=None,
                 device="cpu"):
    """Regular grid [dim, dim, dim, 3] over grid_range^3, scaled, then
    mapped through ``transform`` (reference transform.py:273-304)."""
    t = torch.linspace(grid_range[0], grid_range[1], dim,
                       dtype=torch.float32, device=device)
    grid = torch.stack(torch.meshgrid(t, t, t, indexing="ij"), dim=-1)
    return transform_3D_grid(grid, transform=transform, scale=scale)


def transform_3D_grid(grid_3d, transform=None, scale=None):
    """grid * scale, then R (.) + t of a [4, 4] transform."""
    if scale is not None:
        grid_3d = grid_3d * scale
    if transform is not None:
        grid_3d = grid_3d @ transform[:3, :3].T + transform[:3, 3]
    return grid_3d


def exp_so3(w):
    """SO(3) exponential map (Rodrigues) of [..., 3] -> [..., 3, 3], with
    the Taylor forms below theta^2 = 1e-8."""
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    zeros = torch.zeros_like(w[..., 0])
    K = torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def exp_se3(tw):
    """SE(3) exponential of [..., 6] twists (rotation, translation) ->
    [..., 4, 4], with first-order translation (small pose corrections)."""
    T = torch.zeros(tw.shape[:-1] + (4, 4), dtype=tw.dtype, device=tw.device)
    T[..., :3, :3] = exp_so3(tw[..., :3])
    T[..., :3, 3] = tw[..., 3:]
    T[..., 3, 3] = 1.0
    return T


# ---------------------------------------------------------------------------
# host-side helpers (numpy)
# ---------------------------------------------------------------------------

def look_at(eye, target=None, up=None):
    """Camera pose from eye/target/up, OpenCV-style (camera z points at the
    target). Returns (R [3,3], t [3]) (reference transform.py:49-101)."""
    eye = np.asarray(eye, dtype=float)
    target = np.zeros(3) if target is None else np.asarray(target, float)
    up = np.array([0.0, 0.0, -1.0]) if up is None else np.asarray(up, float)

    def _n(v):
        return v / np.linalg.norm(v)

    z_axis = _n(target - eye)
    x_axis = _n(np.cross(up, z_axis))
    y_axis = _n(np.cross(z_axis, x_axis))
    return np.vstack((x_axis, y_axis, z_axis)).T, eye


def pc_bounds(pc):
    """Axis-aligned extents and centroid of a pointcloud [N, 3] (numpy)."""
    mins = np.min(pc, axis=0)
    maxs = np.max(pc, axis=0)
    return maxs - mins, (maxs + mins) / 2.0


def oriented_bounds(points):
    """PCA oriented bounding box of a pointcloud [N, 3] (numpy, float64).

    Returns (T_scene_to_box [4, 4], extents [3]), the contract of
    trimesh.bounds.oriented_bounds as the reference uses it
    (isdf/modules/trainer.py:121-122): the transform maps scene
    coordinates into the box frame centred at the origin, ``extents`` is
    the box size in that frame. A PCA box is within a few percent of the
    minimal-volume box for room-scale scans; it sets only the training
    domain's normalisation."""
    pts = np.asarray(points, dtype=np.float64)
    centroid = pts.mean(axis=0)
    centred = pts - centroid
    _, R = np.linalg.eigh(np.cov(centred.T))  # columns are the box axes
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    local = centred @ R
    mins = local.min(axis=0)
    maxs = local.max(axis=0)
    center_world = centroid + R @ ((maxs + mins) / 2.0)
    T_scene_to_box = np.eye(4)
    T_scene_to_box[:3, :3] = R.T
    T_scene_to_box[:3, 3] = -R.T @ center_world
    return T_scene_to_box, maxs - mins
