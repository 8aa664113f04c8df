"""Frustum and visibility tests (isdf_tpu/ops/frustum.py; reference
isdf/geometry/frustum.py), batched over frames."""

from __future__ import annotations

import numpy as np
import torch


def frustum_normals(R_WC, H, W, fx, fy, cx, cy):
    """Inward normals [4, 3] of the 4 frustum side planes (reference
    frustum.py:15-31)."""
    dev = R_WC.device
    c = torch.tensor([0.0, W, W, 0.0], device=dev)
    r = torch.tensor([0.0, 0.0, H, H], device=dev)
    x = (c - cx) / fx
    y = (r - cy) / fy
    corners_C = torch.stack([x, y, torch.ones(4, device=dev)], dim=-1)
    corners_W = corners_C @ R_WC.T
    n = torch.linalg.cross(corners_W, torch.roll(corners_W, -1, dims=0))
    return n / n.norm(dim=-1, keepdim=True)


def inside_frustum(points, cam_center, normals):
    """points [N, 3] on the positive side of every plane -> [N] bool."""
    d = (points - cam_center) @ normals.T
    return (d >= 0).all(dim=-1)


def is_visible(points, T_WC, depth, fx, fy, cx, cy, trunc: float = 0.2):
    """Visibility of points [N, 3] in each frame of T_WC [F, 4, 4] with
    depth [F, H, W]: the point projects inside the image and its z lies in
    (0, observed depth + trunc). Returns [F, N] bool (reference
    frustum.py:44-133, projection branch)."""
    F, H, W = depth.shape
    R = T_WC[:, :3, :3]
    t = T_WC[:, :3, 3]
    # T_CW = [R^T | -R^T t]
    pts_C = (torch.einsum("fji,nj->fni", R, points)
             - torch.einsum("fji,fj->fi", R, t)[:, None, :])
    z = pts_C[..., 2]
    u = fx * pts_C[..., 0] / z + cx
    v = fy * pts_C[..., 1] / z + cy
    xy_valid = (u > 0) & (u < W) & (v > 0) & (v < H)
    ui = u.to(torch.int32).clamp(0, W - 1).long()
    vi = v.to(torch.int32).clamp(0, H - 1).long()
    f = torch.arange(F, device=depth.device)[:, None]
    depth_at = depth[f, vi, ui]
    max_depth = torch.where(xy_valid, depth_at + trunc, -torch.inf)
    z_valid = (z > 0) & (z < max_depth)
    return xy_valid & z_valid


def is_visible_np(points, T_WC, depth, fx, fy, cx, cy, trunc=0.2):
    """Single-frame variant, numpy in and out, for host-side eval tools."""
    out = is_visible(torch.as_tensor(np.asarray(points, np.float32)),
                     torch.as_tensor(np.asarray(T_WC, np.float32))[None],
                     torch.as_tensor(np.asarray(depth, np.float32))[None],
                     fx, fy, cx, cy, trunc)
    return out[0].numpy()
