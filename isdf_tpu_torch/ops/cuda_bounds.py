"""Nearest valid surface point for the batch-distance (pc) bounds.

Port of isdf_tpu/ops/pallas/bounds_pc.py::closest_surface_ix (the TPU
kernel ``_kernel``), with that function's inputs (points, surf, valid). For
every point p the index of the surface point s minimising

    score = bias_s + ((x (-2 sx) + y (-2 sy)) + z (-2 sz)),
    bias_s = (sx sx + sy sy) + sz sz (valid) or +inf (invalid),

first index on equal scores; index 0 when no surface point is valid (every
score +inf), as jnp.argmin gives. Every product and sum is rounded on its
own in IEEE float32, in this order, with no fused multiply-add; the factor
-2 is exact, so this is bias - 2 (p . s) bit for bit.

Two executors of the same function:

  * ``closest_surface_ix_plain`` — eager torch, the same products and sums
    spelled out elementwise (not a matrix product), so it rounds as the
    kernel does and takes the same argmin;
  * the CUDA kernel csrc/bounds_pc.cu (sm_90a), built at first use: one
    launch a call, the bias built inside, launch geometry from
    ``k4_geometry``.

``closest_surface_ix`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back. ``LAUNCHES["K4"]`` counts
the kernel's launches.
"""

from __future__ import annotations

import torch

from isdf_tpu_torch.utils import nvcc

# kernel launches; only the wrapper below adds to it
LAUNCHES = {"K4": 0}

SMS = 132          # streaming multiprocessors of an H100 SXM
K4_THREADS = 256   # threads a block
K4_SPLITS = 8      # groups of a block, each scanning its share of surf
K4_CHUNK = 1024    # surface points staged in shared memory per pass
K4_RUN = 8         # rows a thread scans between two records of its minimum
PPTS = (1, 2, 3, 4, 5, 6, 7, 8)  # points a thread the kernel is built for


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k4_geometry(M: int, R: int, threads: int = K4_THREADS,
                splits: int = K4_SPLITS, ppt: int = None) -> dict:
    """Launch geometry of the kernel for M points and R surface points.

    A block has ``threads`` threads in ``splits`` groups of ``lanes``; it
    takes ``points`` = lanes * ppt sample points, ppt a thread. Without a
    given ppt, the largest whose grid fills the SMs within 2% of the best
    fill (blocks over whole waves of SMS blocks). The surface set is
    staged ``chunk`` points at a time; ``rows[g]`` lists the ranges of
    surface indices group g scans, in its order (the kernel's rule: each
    chunk cut into ``splits`` shares of ceil(n / splits) rows)."""
    if threads % 32 or threads > 512 or threads % splits:
        raise ValueError(f"K4: {threads} threads in {splits} groups")
    lanes = threads // splits

    def fill(p):
        blocks = max(_cdiv(M, lanes * p), 1)
        return blocks / (SMS * _cdiv(blocks, SMS))

    if ppt is None:
        top = max(fill(p) for p in PPTS)
        ppt = max(p for p in PPTS if fill(p) >= 0.98 * top)
    if ppt not in PPTS:
        raise ValueError(f"K4: {ppt} points a thread")
    points = lanes * ppt
    chunk = max(min(R, K4_CHUNK), 1)
    rows = [[] for _ in range(splits)]
    for c0 in range(0, R, chunk):
        n = min(chunk, R - c0)
        rps = _cdiv(n, splits)
        for g in range(splits):
            kb = min(g * rps, n)
            ke = min(kb + rps, n)
            if ke > kb:
                rows[g].append((c0 + kb, c0 + ke))
    return dict(threads=threads, splits=splits, lanes=lanes, ppt=ppt,
                points=points, blocks=max(_cdiv(M, points), 1), chunk=chunk,
                smem=chunk * 16 + splits * points * 8, fill=fill(ppt),
                run=K4_RUN, rows=rows)


def _surface_bias(surf, surf_valid):
    """bias [R]: (sx sx + sy sy) + sz sz where valid, +inf elsewhere."""
    sx, sy, sz = surf[:, 0], surf[:, 1], surf[:, 2]
    return torch.where(surf_valid.bool(), (sx * sx + sy * sy) + sz * sz,
                       torch.inf)


def closest_surface_ix_plain(points, surf, surf_valid):
    """points [M, 3], surf [R, 3], surf_valid [R] -> [M] int64."""
    bias = _surface_bias(surf, surf_valid)
    a = -2.0 * surf
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    return (bias + ((x * a[:, 0] + y * a[:, 1]) + z * a[:, 2])).argmin(dim=1)


def _check_rows(name, t, shape, dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or (
            t.dim() == 2 and t.stride(1) != 1):
        raise ValueError(f"{name}: expected a {dtype} tensor of shape "
                         f"{shape} with unit column stride, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def closest_surface_ix_cuda(points, surf, surf_valid, geometry=None):
    """Launch the kernel on the current stream: one launch, same result as
    the plain version. Rows of points and surf, and surf_valid, may be
    strided (pc[:, 0] is taken as it is); ``geometry`` defaults to
    k4_geometry(M, R)."""
    M, R = points.shape[0], surf.shape[0]
    _check_rows("points", points, (M, 3), torch.float32)
    _check_rows("surf", surf, (R, 3), torch.float32)
    _check_rows("surf_valid", surf_valid, (R,), torch.bool)
    out = torch.empty(M, dtype=torch.int64, device=points.device)
    if M == 0:
        return out
    if R == 0:
        raise ValueError("surf: the surface set is empty")
    g = geometry or k4_geometry(M, R)
    nvcc.call(nvcc.load("bounds_pc"), "isdf_closest_surface",
              [points, surf, surf_valid, out], [],
              [M, R, points.stride(0), surf.stride(0), surf_valid.stride(0),
               g["threads"], g["splits"], g["ppt"], g["points"], g["chunk"],
               g["blocks"], g["smem"]], points.device)
    nvcc.count_launch(LAUNCHES, "K4")
    return out


def closest_surface_ix(points, surf, surf_valid):
    """Index [M] (int64) of the nearest valid surface point of each point.
    points [M, 3], surf [R, 3], surf_valid [R] bool."""
    if points.device.type == "cuda":
        return closest_surface_ix_cuda(points, surf, surf_valid)
    return closest_surface_ix_plain(points, surf, surf_valid)
