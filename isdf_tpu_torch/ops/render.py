"""Depth rendering from the SDF along sampled rays (isdf_tpu/ops/render.py
in torch; reference isdf/modules/render.py): depth at the first sign
crossing, z + sdf there."""

from __future__ import annotations

import torch


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
