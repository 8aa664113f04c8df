"""Object-centric and trajectory evaluation (isdf_tpu/eval/objects.py;
reference trainer.py:1955-2052).

* eval_object_sdf — per-object L1 inside an expanded bbox, gated on the
  object being >=50% visible in the frames seen so far;
* eval_traj_cost — CHOMP collision cost along the next t_ahead seconds of
  the ground-truth trajectory (both predicted and GT SDF).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from isdf_tpu_torch.eval import metrics as MET
from isdf_tpu_torch.ops import frustum as FR


def load_obj_bounds(obj_bounds_file: str, up_ix: int = 1,
                    expand_m: float = 0.08,
                    expand_down: bool = False) -> np.ndarray:
    """[N, 2, 3] per-object (min, max) eval boxes, expanded like the
    reference (metrics.py:116-130)."""
    b = np.loadtxt(obj_bounds_file).reshape(-1, 2, 3)
    b[:, 1] += expand_m
    b[:, 0, :up_ix] -= expand_m
    b[:, 0, up_ix + 1:] -= expand_m
    if expand_down:
        b[:, 0, up_ix] -= expand_m
    return b


def eval_object_sdf(trainer, obj_bounds: np.ndarray,
                    samples: int = 10000,
                    seed: Optional[int] = None) -> List[float]:
    """Per-object SDF L1, NaN for objects not yet visible
    (reference trainer.py:1955-2008)."""
    from isdf_tpu_torch.data.datasets import SceneCache

    rng = np.random.default_rng(seed)
    cache = getattr(trainer, "_scene_cache", None)
    if cache is None:
        cache = SceneCache(trainer.dataset, skip=5)
        trainer._scene_cache = cache
    n_seen = min(max(int(trainer.tot_step_time * trainer.cfg.fps), 1),
                 len(trainer.dataset))
    sample = cache[np.arange(n_seen)]
    depth_b, T_b = sample["depth"], sample["T"]

    # visibility check: 100 random points per object box, on the host
    offs = rng.random((100, 3)).astype(np.float32)
    extents = obj_bounds[:, 1] - obj_bounds[:, 0]
    pts = obj_bounds[:, 0] + offs[:, None] * extents   # [100, n_obj, 3]
    vis = FR.is_visible(
        torch.as_tensor(pts.reshape(-1, 3), dtype=torch.float32),
        torch.as_tensor(np.asarray(T_b, np.float32)),
        torch.as_tensor(np.asarray(depth_b, np.float32)), trainer.fx,
        trainer.fy, trainer.cx, trainer.cy, trunc=0.05).numpy()
    vis_any = vis.sum(axis=0) > 0
    vis_prop = vis_any.reshape(100, len(obj_bounds)).mean(axis=0)

    errors = []
    for i, bounds in enumerate(obj_bounds):
        if vis_prop[i] <= 0.5:
            errors.append(float("nan"))
            continue
        o = rng.random((samples, 3)).astype(np.float32)
        p = bounds[0] + o * (bounds[1] - bounds[0])
        gt = np.asarray(trainer.gt_sdf_fn(p)).reshape(-1)
        ok = np.isfinite(gt)
        sdf = trainer.sdf_fn(p[ok])
        errors.append(float(np.abs(gt[ok] - sdf).mean()))
    return errors


def eval_traj_cost(trainer, traj: np.ndarray,
                   t_ahead: float = 5.0) -> Tuple[list, list]:
    """CHOMP cost along the upcoming GT trajectory section
    (reference trainer.py:2010-2052). traj: [N, 16] flat poses or
    [N, 4, 4]. Returns (pred_costs, gt_costs) for eps 1/1.5/2, or
    (nan, nan) when insufficient coverage."""
    if traj.ndim == 2 and traj.shape[1] == 16:
        eval_pts = traj[:, [3, 7, 11]]
    else:
        eval_pts = traj.reshape(-1, 4, 4)[:, :3, 3]

    start = int(trainer.tot_step_time * trainer.cfg.fps)
    end = int(min(len(eval_pts) - 1,
                  (trainer.tot_step_time + t_ahead) * trainer.cfg.fps))
    section = eval_pts[start:end]

    gt = np.asarray(trainer.gt_sdf_fn(section)).reshape(-1)
    valid = np.isfinite(gt) & (gt != 0.0)
    if valid.sum() < 0.9 * max(len(section), 1) or len(section) < 30:
        return float("nan"), float("nan")

    sdf = trainer.sdf_fn(section[valid])
    gt = gt[valid]
    eps = [1.0, 1.5, 2.0]
    pred = [float(MET.chomp_cost(sdf, e).sum()) for e in eps]
    gtc = [float(MET.chomp_cost(gt, e).sum()) for e in eps]
    return pred, gtc
