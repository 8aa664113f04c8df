"""Depth and normal rendering from the SDF along sampled rays
(isdf_tpu/ops/render.py in torch; reference isdf/modules/render.py): depth
at the first sign crossing, z + sdf there; normals from the spatial
gradient at rendered depths."""

from __future__ import annotations

import torch

from isdf_tpu_torch.ops.geometry import origin_dirs_W


def sdf_render_depth(z_vals, sdf):
    """Depth at the first negative-SDF sample of each ray; z_vals [R, S]
    ascending. Rays with no crossing, or whose first crossing is the last
    sample, render 0."""
    S = sdf.shape[1]
    inside = sdf < 0
    ixs = torch.arange(S, 0, -1, dtype=sdf.dtype, device=sdf.device)
    first = (inside * ixs).argmax(dim=1)
    r = torch.arange(sdf.shape[0], device=sdf.device)
    depth = z_vals[r, first] + sdf[r, first]
    no_crossing = ~inside.any(dim=1)
    return torch.where(no_crossing | (first == S - 1), 0.0, depth)


def sort_by_z(z_vals, *mats):
    """Ascending sort of z_vals, reordering companion [R, S] tensors."""
    order = torch.argsort(z_vals, dim=-1)
    return (torch.gather(z_vals, -1, order),
            *(torch.gather(m, -1, order) for m in mats))


def render_normals_C(T_WC, render_depth, sdf_grad_fn, dirs_C):
    """Camera-frame surface normals at rendered depths (reference
    render.py:39-57). sdf_grad_fn: pc [N, 3] -> grad [N, 3]."""
    origins, dirs_W = origin_dirs_W(T_WC, dirs_C)
    pc = origins + dirs_W * render_depth[..., None]
    grad = sdf_grad_fn(pc)
    normals_W = -grad / (grad.norm(dim=-1, keepdim=True) + 1e-4)
    R_CW = T_WC[..., :3, :3].transpose(-1, -2)
    return (R_CW @ normals_W[..., None])[..., 0]


def render_weighted(weights, vals, axis=-1, normalise: bool = False):
    """Weighted-sum render (reference render.py:60-70)."""
    out = (weights * vals).sum(dim=axis)
    if normalise:
        out = out / weights.shape[axis]
    return out
