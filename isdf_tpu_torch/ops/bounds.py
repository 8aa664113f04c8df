"""Self-supervised SDF bound targets (isdf_tpu/ops/bounds.py in torch).

  * ray    — b = (depth - z) * ||dir_C|| along each ray;
  * normal — the ray bound corrected by the cosine of the angle between the
             ray and the surface normal inside the truncation region;
  * pc     — "batch distance": signed distance from each sample to the
             nearest valid surface point of the whole ray batch.

The pc search is scores = -2 x.s + |s|^2 in IEEE float32 (TF32 is off in
the port) with a first-index argmin, then the exact distance at the argmin.
With ``use_kernel`` (the step's tpu.use_pallas) the search goes to the
nearest-surface kernel of ops/cuda_bounds.py (K4) instead: the kernel on
CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from isdf_tpu_torch.ops.cuda_bounds import closest_surface_ix


class Bounds(NamedTuple):
    bounds: torch.Tensor                 # [R, S]
    grad: Optional[torch.Tensor]         # [R, S-1, 3]
    grad_valid: Optional[torch.Tensor]   # [R, S-1] bool (pc degeneracy)


def bounds_ray(depth, z_vals, dirs_C, dirs_W=None, do_grad: bool = True):
    """Ray bound (reference loss.py:13-22); grad is the negated world
    viewing direction on samples 1..S-1 (loss.py:48-53)."""
    z2e = dirs_C.norm(dim=-1)
    b = (depth[:, None] - z_vals) * z2e[:, None]
    grad = None
    if do_grad:
        S = z_vals.shape[1]
        grad = (-dirs_W[:, None, :]).expand(dirs_W.shape[0], S - 1, 3)
    return Bounds(b, grad, None)


def cos_sim(a, b, eps: float = 1e-6):
    """Cosine similarity along the last axis with clamped norms."""
    na = a.norm(dim=-1).clamp(min=eps)
    nb = b.norm(dim=-1).clamp(min=eps)
    return (a * b).sum(-1) / (na * nb)


def bounds_normal(depth, z_vals, dirs_C, normals, normal_trunc_dist,
                  dirs_W=None, do_grad: bool = True):
    """Normal-corrected bound (reference loss.py:25-45)."""
    ray_b = bounds_ray(depth, z_vals, dirs_C, dirs_W, do_grad=False).bounds
    costheta = cos_sim(-dirs_C, normals).abs()
    sub = normal_trunc_dist * (1.0 - costheta)
    normal_b = ray_b - sub[:, None]
    trunc = ray_b < normal_trunc_dist
    normal_b = torch.where(trunc, ray_b * costheta[:, None], normal_b)
    grad = None
    if do_grad:
        S = z_vals.shape[1]
        grad = (-dirs_W[:, None, :]).expand(dirs_W.shape[0], S - 1, 3)
    return Bounds(normal_b, grad, None)


def bounds_pc(pc, z_vals, depth, valid, do_grad: bool = True, surf=None,
              surf_valid=None, use_kernel: bool = False):
    """Batch-distance bound (reference loss.py:56-89), masked and static.
    pc [R, S, 3] with index 0 the exact surface sample; invalid rays'
    surface points never win the argmin; negative behind the surface."""
    R, S, _ = pc.shape
    if surf is None:
        surf, surf_valid = pc[:, 0], valid
    flat = pc.reshape(R * S, 3)
    if use_kernel:
        closest = closest_surface_ix(flat, surf, surf_valid)
    else:
        scores = -2.0 * (flat @ surf.T) + (surf * surf).sum(-1)[None, :]
        scores = torch.where(surf_valid[None, :], scores, torch.inf)
        closest = scores.argmin(dim=-1)
    diff = flat - surf[closest]
    dists = diff.norm(dim=-1).reshape(R, S)
    behind = z_vals > depth[:, None]
    b = torch.where(behind, -dists, dists)
    grad = grad_valid = None
    if do_grad:
        d3 = diff.reshape(R, S, 3)[:, 1:]
        norm = d3.norm(dim=-1, keepdim=True)
        grad_valid = norm[..., 0] > 0
        grad = d3 / norm.clamp(min=1e-12)
        grad = torch.where(behind[:, 1:, None], -grad, grad)
    return Bounds(b, grad, grad_valid)


def compute_bounds(method: str, dirs_C, depth, dirs_W, z_vals, pc,
                   normal_trunc_dist, normals, valid, do_grad: bool = True,
                   surf=None, surf_valid=None,
                   use_kernel: bool = False) -> Bounds:
    """Dispatch matching reference loss.bounds (loss.py:92-119);
    ``use_kernel`` sends the pc search to K4 (isdf_tpu's pallas_mode)."""
    if method == "ray":
        return bounds_ray(depth, z_vals, dirs_C, dirs_W, do_grad)
    if method == "normal":
        return bounds_normal(depth, z_vals, dirs_C, normals,
                             normal_trunc_dist, dirs_W, do_grad)
    if method == "pc":
        return bounds_pc(pc, z_vals, depth, valid, do_grad, surf=surf,
                         surf_valid=surf_valid, use_kernel=use_kernel)
    raise ValueError(f"unknown bounds method {method!r}")
