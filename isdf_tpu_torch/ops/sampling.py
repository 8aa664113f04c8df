"""Ray / pixel / depth sampling with static shapes and validity masks
(isdf_tpu/ops/sampling.py in torch).

Every step carries n_frames * n_rays rays plus a boolean ``valid`` mask;
invalid rays flow through the MLP and contribute exactly zero loss.

Each sampler takes its random draws from a ``torch.Generator``, or from
tensors passed as ``draws`` (the tests hand both packages the same draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from isdf_tpu_torch.ops.geometry import origin_dirs_W


class RaySamples(NamedTuple):
    """Everything the loss needs about one batch of rays (isdf_tpu's
    RaySamples). R = n_frames * n_rays rays, S = n_surf + n_strat samples."""
    pc: torch.Tensor            # [R, S, 3] world-space sample points
    z_vals: torch.Tensor        # [R, S] z depth of each sample
    dirs_C: torch.Tensor        # [R, 3] camera-frame ray directions
    dirs_W: torch.Tensor        # [R, 3] world-frame ray directions
    origins: torch.Tensor       # [R, 3] ray origins
    depth: torch.Tensor         # [R] depth at the pixel (1 where invalid)
    T_WC: torch.Tensor          # [R, 4, 4] pose of the ray's frame
    normals: torch.Tensor       # [R, 3] surface normal (zeros if unused)
    valid: torch.Tensor         # [R] bool: depth (and normal) valid
    indices_b: torch.Tensor     # [R] frame index of each ray
    indices_h: torch.Tensor     # [R]
    indices_w: torch.Tensor     # [R]


def gumbel(gen, shape, device):
    """Standard Gumbel draws -log(-log(u)), u uniform in (0, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_pixels(gen, n_rays: int, n_frames: int, H: int, W: int,
                  device="cpu"):
    """Uniform pixel draw: n_rays per frame."""
    total = n_rays * n_frames
    ih = torch.randint(0, H, (total,), generator=gen, device=device)
    iw = torch.randint(0, W, (total,), generator=gen, device=device)
    ib = torch.arange(n_frames, device=device).repeat_interleave(n_rays)
    return ib, ih, iw


def sample_pixels_active(gen, n_rays: int, n_frames: int, H: int, W: int,
                         loss_grids, active_frac: float = 0.5, draws=None):
    """Loss-guided pixel draw: the first ``active_frac`` of each frame's
    rays pick an image block with probability proportional to the frame's
    block-pooled loss (categorical by Gumbel argmax), then a uniform pixel
    in it; the rest are uniform. Frames with an all-zero grid degrade to
    uniform. draws = (ih_u [T], iw_u [T], g [n_frames, n_rays, fh*fw],
    off [2, T]) with T = n_frames * n_rays."""
    fh, fw = loss_grids.shape[-2:]
    total = n_rays * n_frames
    dev = loss_grids.device
    h_blk, w_blk = H // fh, W // fw
    if draws is None:
        draws = (torch.randint(0, H, (total,), generator=gen, device=dev),
                 torch.randint(0, W, (total,), generator=gen, device=dev),
                 gumbel(gen, (n_frames, n_rays, fh * fw), dev),
                 torch.randint(0, max(h_blk, w_blk), (2, total),
                               generator=gen, device=dev))
    ih_u, iw_u, g, off = draws
    ib = torch.arange(n_frames, device=dev).repeat_interleave(n_rays)
    logw = torch.log(loss_grids.reshape(n_frames, fh * fw).clamp(min=1e-12))
    blocks = (logw[:, None, :] + g).argmax(dim=-1).reshape(total)
    bh, bw = blocks // fw, blocks % fw
    ih_a = torch.clamp(bh * h_blk + off[0] % h_blk, max=H - 1)
    iw_a = torch.clamp(bw * w_blk + off[1] % w_blk, max=W - 1)
    n_active = int(round(n_rays * active_frac))
    is_active = (torch.arange(total, device=dev) % n_rays) < n_active
    return (ib, torch.where(is_active, ih_a, ih_u),
            torch.where(is_active, iw_a, iw_u))


def stratified_sample(u, min_depth, max_depth):
    """One sample per bin between min_depth and per-ray max_depth [R], at
    the uniform draws u [R, n_bins]. Returns [R, n_bins]."""
    R, n_bins = u.shape
    if isinstance(min_depth, torch.Tensor):
        min_d = min_depth.to(max_depth).expand(R)
    else:   # filled on the device: no copy from the host
        min_d = torch.full((R,), float(min_depth), dtype=max_depth.dtype,
                           device=max_depth.device)
    sample_range = (max_depth - min_d)[:, None]
    lims = torch.linspace(0.0, 1.0, n_bins + 1, dtype=max_depth.dtype,
                          device=max_depth.device)[None, :]
    lower = lims[:, :-1] * sample_range + min_d[:, None]
    return lower + u * (sample_range / n_bins)


def sample_along_rays(gen, T_WC, dirs_C, gt_depth, min_depth: float,
                      dist_behind_surf: float, n_strat_samples: int,
                      n_surf_samples: int, surf_std: float = 0.1,
                      draws=None):
    """S = n_surf + n_strat z-values and 3-D points along each ray: index 0
    is the exact surface depth, 1..n_surf-1 Gaussian (sigma 0.1)
    perturbations of it clamped to [min_depth, depth + dist_behind_surf],
    the rest stratified in [min_depth, depth + dist_behind_surf]
    (reference sample.py:131-178). draws = (u [R, n_strat],
    normal [R, n_surf - 1]). Returns (pc [R,S,3], z_vals [R,S],
    origins [R,3], dirs_W [R,3])."""
    R = gt_depth.shape[0]
    if draws is None:
        u = torch.rand((R, n_strat_samples), generator=gen,
                       device=gt_depth.device)
        nrm = torch.randn((R, max(n_surf_samples - 1, 0)), generator=gen,
                          device=gt_depth.device)
    else:
        u, nrm = draws
    origins, dirs_W = origin_dirs_W(T_WC, dirs_C)
    max_depth = gt_depth + dist_behind_surf
    z_vals = stratified_sample(u, min_depth, max_depth)
    if n_surf_samples > 0:
        near = torch.minimum(
            torch.clamp(gt_depth[:, None] + surf_std * nrm, min=min_depth),
            max_depth[:, None])
        z_vals = torch.cat([gt_depth[:, None], near, z_vals], dim=1)
    pc = origins[:, None, :] + dirs_W[:, None, :] * z_vals[:, :, None]
    return pc, z_vals, origins, dirs_W


def sample_rays_from_frames(gen, depth_batch, T_WC_batch, dirs_C_img,
                            normal_batch: Optional[torch.Tensor],
                            frame_valid, n_rays: int, min_depth: float,
                            dist_behind_surf: float, n_strat_samples: int,
                            n_surf_samples: int, draws=None) -> RaySamples:
    """Pixels -> gathers -> ray samples, on the frames' device (isdf_tpu
    sampling.py:150-200, the reference's sample_points). depth_batch
    [F, H, W], T_WC_batch [F, 4, 4], dirs_C_img [H, W, 3], normal_batch
    [F, H, W, 3] or None, frame_valid [F] bool. A ray with zero depth, a
    NaN normal or an invalid frame is masked, not dropped, and its depth
    replaced by 1 so no NaN enters the samples. draws = (ih [T], iw [T],
    u [T, n_strat], normal [T, n_surf - 1]) with T = F * n_rays."""
    F, H, W = depth_batch.shape
    dev = depth_batch.device
    if draws is None:
        ib, ih, iw = sample_pixels(gen, n_rays, F, H, W, device=dev)
        ray_draws = None
    else:
        ih, iw = draws[0].to(dev), draws[1].to(dev)
        ib = torch.arange(F, device=dev).repeat_interleave(n_rays)
        ray_draws = (draws[2].to(dev), draws[3].to(dev))
    depth = depth_batch[ib, ih, iw]
    valid = (depth != 0.0) & frame_valid.to(dev)[ib]
    if normal_batch is not None:
        normals = normal_batch[ib, ih, iw]
        valid &= ~torch.isnan(normals[..., 0])
        normals = torch.nan_to_num(normals, nan=0.0)
    else:
        normals = torch.zeros((depth.shape[0], 3), dtype=depth.dtype,
                              device=dev)
    depth_safe = torch.where(valid, depth, torch.ones_like(depth))
    dirs_C = dirs_C_img[ih, iw]
    T_WC = T_WC_batch[ib]
    pc, z_vals, origins, dirs_W = sample_along_rays(
        gen, T_WC, dirs_C, depth_safe, min_depth, dist_behind_surf,
        n_strat_samples, n_surf_samples, draws=ray_draws)
    return RaySamples(pc=pc, z_vals=z_vals, dirs_C=dirs_C, dirs_W=dirs_W,
                      origins=origins, depth=depth_safe, T_WC=T_WC,
                      normals=normals, valid=valid, indices_b=ib,
                      indices_h=ih, indices_w=iw)
