"""Nearest valid surface point for the batch-distance (pc) bounds.

Port of isdf_tpu/ops/pallas/bounds_pc.py::closest_surface_ix (the TPU
kernel ``_kernel``). For every sample point p the index of the surface
point s minimising

    score = bias_s - 2 (p . s),   bias_s = |s|^2 (valid) or +inf (invalid),

first index on equal scores; index 0 when no surface point is valid (every
score +inf), as jnp.argmin gives. The dot is summed in a fixed order,
((x sx + y sy) + z sz), in IEEE float32 with no fused multiply-add.

Two executors of the same function:

  * ``closest_surface_ix_plain`` — eager torch, the same products and sums
    spelled out elementwise (not a matrix product), so it rounds as the
    kernel does and takes the same argmin;
  * the CUDA kernel csrc/bounds_pc.cu (sm_90a), built at first use.

``closest_surface_ix`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back. ``LAUNCHES["K4"]`` counts
the kernel's launches.
"""

from __future__ import annotations

import torch

from isdf_tpu_torch.utils import nvcc

# kernel launches; only the wrapper below adds to it
LAUNCHES = {"K4": 0}


def surface_bias(surf, surf_valid):
    """bias [R]: |s|^2 where the surface point is valid, +inf elsewhere."""
    return torch.where(surf_valid.bool(), (surf * surf).sum(-1), torch.inf)


def closest_surface_ix_plain(points, surf, bias):
    """points [M, 3], surf [R, 3], bias [R] -> [M] int64."""
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    dot = (x * surf[:, 0] + y * surf[:, 1]) + z * surf[:, 2]
    return (bias - 2.0 * dot).argmin(dim=1)


def closest_surface_ix_cuda(points, surf, bias):
    """Launch the kernel on the current stream; same result as the plain
    version."""
    M, R = points.shape[0], surf.shape[0]
    for name, t, shape in (("points", points, (M, 3)), ("surf", surf, (R, 3)),
                           ("bias", bias, (R,))):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    out = torch.empty(M, dtype=torch.int64, device=points.device)
    if M == 0:
        return out
    if R == 0:
        raise ValueError("surf: the surface set is empty")
    nvcc.call(nvcc.load("bounds_pc"), "isdf_closest_surface",
              [points, surf, bias, out], [], [M, R], points.device)
    LAUNCHES["K4"] += 1
    return out


def closest_surface_ix(points, surf, surf_valid):
    """Index [M] (int64) of the nearest valid surface point of each point.
    points [M, 3], surf [R, 3], surf_valid [R] bool."""
    bias = surface_bias(surf, surf_valid)
    if points.device.type == "cuda":
        return closest_surface_ix_cuda(points.contiguous(), surf.contiguous(),
                                       bias.contiguous())
    return closest_surface_ix_plain(points, surf, bias)
