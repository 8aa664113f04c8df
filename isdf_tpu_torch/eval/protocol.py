"""Online SDF evaluation protocol (isdf_tpu/eval/protocol.py; reference
trainer.py:1819-1953): host-side sampling with a numpy generator, SDF
queries through the trainer's chunked ``sdf_fn`` / ``grad_fn`` on its
device. The mesh protocol (eval_mesh) is not ported yet."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from isdf_tpu_torch.eval import metrics as MET

CHOMP_EPSILONS = [1.0, 1.5, 2.0]


def _visible_region_pts(trainer, samples: int, rng: np.random.Generator):
    """Random points along rays of the frames seen so far (reference
    eval_sdf_visible, trainer.py:1868-1905): one uniform sample per ray in
    [min_depth, depth + dist_behind_surf]."""
    cfg = trainer.cfg
    cache = getattr(trainer, "_scene_cache", None)
    if cache is None:
        from isdf_tpu_torch.data.datasets import SceneCache
        cache = SceneCache(trainer.dataset, skip=5)
        trainer._scene_cache = cache

    if trainer.incremental:
        n_seen = max(int(trainer.tot_step_time * cfg.fps), 1)
        frame_ixs = np.arange(min(n_seen, len(trainer.dataset)))
    else:
        frame_ixs = np.arange(0, len(trainer.dataset), 5)
    sample = cache[frame_ixs]
    depth_batch, T_batch = sample["depth"], sample["T"]
    F = depth_batch.shape[0]
    rays_per_frame = max(samples // F, 1)

    H, W = depth_batch.shape[1:]
    ib = np.repeat(np.arange(F), rays_per_frame)
    ih = rng.integers(0, H, ib.shape[0])
    iw = rng.integers(0, W, ib.shape[0])
    depth = depth_batch[ib, ih, iw]
    valid = depth > 0
    ib, ih, iw, depth = ib[valid], ih[valid], iw[valid], depth[valid]

    dirs_C = trainer.dirs_C.cpu().numpy()[ih, iw]
    R = T_batch[ib, :3, :3]
    origins = T_batch[ib, :3, 3]
    dirs_W = np.einsum("nij,nj->ni", R, dirs_C)

    z = rng.uniform(cfg.min_depth, depth + cfg.dist_behind_surf)
    return origins + dirs_W * z[:, None]


def _volume_pts(trainer, samples: int, rng: np.random.Generator):
    """Uniform points in the scene volume (reference eval_sdf_volume,
    trainer.py:1907-1953)."""
    T = trainer.bounds_transform_np
    half = trainer.scene_extents_np / 2.0
    local = rng.uniform(-half, half, size=(samples, 3)).astype(np.float32)
    return local @ T[:3, :3].T + T[:3, 3]


def eval_sdf(trainer, samples: int = 200000, visible_region: bool = True,
             seed: Optional[int] = None) -> Dict:
    """L1, binned L1 and CHOMP-cost differences against the GT SDF
    (reference trainer.py:1819-1866). Needs trainer.gt_sdf_fn."""
    if trainer.gt_sdf_fn is None:
        raise ValueError("no GT SDF available for evaluation")
    rng = np.random.default_rng(seed)

    pts = (_visible_region_pts(trainer, samples, rng) if visible_region
           else _volume_pts(trainer, samples, rng))
    gt = np.asarray(trainer.gt_sdf_fn(pts)).reshape(-1)
    # the reference masks gt == 0 (inside walls, out-of-grid fill)
    valid = np.isfinite(gt) & (gt != 0.0)
    pts, gt = pts[valid], gt[valid]

    sdf = trainer.sdf_fn(pts)
    diff = np.abs(sdf - gt)

    return {
        "av_l1": float(diff.mean()) if diff.size else float("nan"),
        "binned_l1": MET.binned_losses(diff, gt),
        "l1_chomp_costs": [
            float(np.abs(MET.chomp_cost(sdf, eps)
                         - MET.chomp_cost(gt, eps)).mean())
            for eps in CHOMP_EPSILONS],
    }


def eval_grad_cossim(trainer, samples: int = 20000,
                     seed: Optional[int] = None) -> float:
    """Mean cosine distance between the predicted gradients and the GT
    SDF's central finite differences (reference eval_pts.py:68-93)."""
    rng = np.random.default_rng(seed)
    pts = _visible_region_pts(trainer, samples, rng)
    g_pred = trainer.grad_fn(pts)

    eps = 1e-2
    g_gt = np.empty_like(g_pred)
    for d in range(3):
        dx = np.zeros(3, np.float32)
        dx[d] = eps
        g_gt[:, d] = (np.asarray(trainer.gt_sdf_fn(pts + dx))
                      - np.asarray(trainer.gt_sdf_fn(pts - dx))) / (2 * eps)

    def _n(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)

    cos = (_n(g_pred) * _n(g_gt)).sum(-1)
    return float(1.0 - cos.mean())
