"""SDF losses as masked-static means (isdf_tpu/ops/losses.py in torch;
reference isdf/modules/loss.py:122-240 and trainer.py:768-868)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from isdf_tpu_torch.ops.bounds import cos_sim


def full_sdf_loss(sdf, target_sdf, free_space_factor: float = 5.0):
    """free space: max(relu(sdf - b), exp(-5 sdf) - 1); truncation: sdf - b
    (reference loss.py:148-164)."""
    free = torch.maximum(torch.relu(sdf - target_sdf),
                         torch.exp(-free_space_factor * sdf) - 1.0)
    return free, sdf - target_sdf


def sdf_loss(sdf, bounds, trunc_distance: float, loss_type: str = "L1"):
    """Split by bound > trunc distance, L1 or L2 (loss.py:122-145).
    Returns (loss_mat [R,S], free_space_mask [R,S])."""
    free, trunc = full_sdf_loss(sdf, bounds)
    free_space = bounds > trunc_distance
    mat = torch.where(free_space, free, trunc)
    if loss_type == "L1":
        mat = mat.abs()
    elif loss_type == "L2":
        mat = mat.square()
    else:
        raise ValueError("loss_type must be L1 or L2")
    return mat, free_space


def masked_mean(x, mask):
    mask = mask.to(x.dtype)
    n = mask.sum()
    return torch.where(n > 0, (x * mask).sum() / n.clamp(min=1.0), 0.0)


class TotalLoss(NamedTuple):
    total: torch.Tensor
    mat: torch.Tensor                  # [R, S] per-sample total loss
    scalars: Dict[str, torch.Tensor]


def tot_loss(sdf_loss_mat, grad_loss_mat, eik_loss_mat, free_space_mask,
             bounds, ray_valid, eik_apply_dist: float, trunc_weight: float,
             grad_weight: float, eik_weight: float) -> TotalLoss:
    """Weighted combination with ray masking (reference loss.py:178-205):
    sdf/grad terms logged before weighting, the eikonal term after."""
    vmask = ray_valid[:, None].expand_as(sdf_loss_mat)
    sdf_mat = torch.where(free_space_mask, sdf_loss_mat,
                          sdf_loss_mat * trunc_weight)
    scalars = {"sdf_loss": masked_mean(sdf_mat, vmask)}
    total_mat = sdf_mat
    if grad_loss_mat is not None:
        total_mat = total_mat + grad_weight * grad_loss_mat
        scalars["grad_loss"] = masked_mean(grad_loss_mat, vmask)
    if eik_loss_mat is not None:
        eik = torch.where(bounds < eik_apply_dist, 0.0, eik_loss_mat)
        eik = eik * eik_weight
        total_mat = total_mat + eik
        scalars["eikonal_loss"] = masked_mean(eik, vmask)
    total_mat = total_mat * ray_valid[:, None].to(total_mat.dtype)
    total = masked_mean(total_mat, vmask)
    scalars["total_loss"] = total
    return TotalLoss(total, total_mat, scalars)


def grad_cosine_loss(sdf_grad, grad_vec, grad_vec_valid, normals,
                     orien_loss: bool = False):
    """Sample 0 against the surface normal, samples 1..S-1 against the
    bounds' gradient targets (invalid ones replaced by the normal)
    (reference trainer.py:818-830)."""
    surf_loss = 1.0 - cos_sim(sdf_grad[:, 0], normals)
    if grad_vec_valid is not None:
        grad_vec = torch.where(grad_vec_valid[..., None], grad_vec,
                               normals[:, None, :])
    ray_loss = 1.0 - cos_sim(grad_vec, sdf_grad[:, 1:])
    mat = torch.cat([surf_loss[:, None], ray_loss], dim=1)
    if orien_loss:
        mat = (mat > 1.0).to(mat.dtype)
    return mat


def frame_avg_loss(ray_loss, ray_valid, indices_b, indices_h, indices_w,
                   n_frames: int, H: int, W: int,
                   factor: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame average loss via 8x8 block pooling (reference
    loss.py:208-240), by a summing scatter of per-ray losses and counts
    into the [F, factor, factor] block grid: repeated pixels add up.
    Returns (loss_approx [F, factor, factor], frame_avg [F])."""
    h_block, w_block = H // factor, W // factor
    block = (indices_b * (factor * factor)
             + (indices_h // h_block).clamp(0, factor - 1) * factor
             + (indices_w // w_block).clamp(0, factor - 1))
    n_seg = n_frames * factor * factor
    w = ray_valid.to(ray_loss.dtype)
    sums = torch.zeros(n_seg, dtype=ray_loss.dtype, device=ray_loss.device)
    sums.index_add_(0, block, ray_loss * w)
    counts = torch.zeros_like(sums).index_add_(0, block, w)
    loss_approx = (sums / counts.clamp(min=1.0)).reshape(
        n_frames, factor, factor)
    frame_avg = loss_approx.sum(dim=(1, 2)) / (factor * factor)
    return loss_approx, frame_avg
