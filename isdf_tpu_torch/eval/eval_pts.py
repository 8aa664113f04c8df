"""Fixed-point (voxblox-comparable) evaluation protocol
(isdf_tpu/eval/eval_pts.py; reference isdf/eval/eval_pts.py:96-299).

At pre-baked timestamps, points are re-sampled deterministically along the
rays of every frame seen so far, from torch's CPU generator seeded with
t * 1e3 as the reference seeds it; precomputed validity masks from the
eval_pts data directory select the points where the GT SDF (and the
voxblox baseline grid) are defined, so that every method is scored on the
same points. The output has the reference's vox_res.json schema (regions:
rays {vis, vox}, visible_surf {vis, vox}, vol, objects). Without eval_pts
masks (the synthetic scenes) the protocol samples mask-free with the same
seeding, so runs stay comparable with each other.

The draws come from a CPU ``torch.Generator``, never the global one and
never the card, so the points are bit for bit isdf_tpu's (which seeds
torch's global generator) and the SDF queries then run on the trainer's
device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from isdf_tpu_torch.eval import metrics as MET

CHOMP_EPSILONS = [1.0, 1.5, 2.0]


def _torch_sample_rays(t_str: str, depth_batch, T_WC_batch, dirs_C,
                       dist_behind_surf: float, surface: bool,
                       samples: int = 200000, min_depth: float = 0.1):
    """The reference's deterministic ray sampling (eval_pts.py:327-400):
    a CPU generator seeded with int(t * 1e3) (what torch.manual_seed makes
    of the float), uniform pixels, invalid depth dropped, one stratified z
    per ray (or the surface depth). Returns numpy [N, 3] float32."""
    gen = torch.Generator().manual_seed(int(float(t_str) * 1e3))
    depth_batch = torch.as_tensor(np.array(depth_batch))
    T_WC_batch = torch.as_tensor(np.array(T_WC_batch))
    dirs_C = torch.as_tensor(np.array(dirs_C))
    F, H, W = depth_batch.shape

    rays_per_frame = samples // F
    total = rays_per_frame * F
    ih = torch.randint(0, H, (total,), generator=gen)
    iw = torch.randint(0, W, (total,), generator=gen)
    ib = torch.arange(F).repeat_interleave(rays_per_frame)

    depth = depth_batch[ib, ih, iw].view(-1)
    ok = depth != 0
    depth, ib, ih, iw = depth[ok], ib[ok], ih[ok], iw[ok]

    T = T_WC_batch[ib]
    d_C = dirs_C[ih, iw]
    R = T[:, :3, :3]
    dirs_W = (R * d_C[:, None, :]).sum(-1)
    origins = T[:, :3, 3]

    if surface:
        z = depth[:, None]
    else:
        max_depth = depth + dist_behind_surf
        rng_range = (max_depth - min_depth)[:, None]
        lims = torch.linspace(0, 1, 2)[None, :] * rng_range + min_depth
        incr = torch.rand(depth.shape[0], 1, generator=gen) * rng_range
        z = lims[:, :1] + incr
    pts = origins[:, None, :] + dirs_W[:, None, :] * z[:, :, None]
    return pts.squeeze(1).numpy().astype(np.float32)


def _sub_eval(sdf_fn, pts_and_vox, pts_not_vox, gt_and_vox, gt_not_vox):
    """Per-region metrics (reference eval_pts.py:18-64 sub_eval): the
    vis region is ALL points (vox-covered first, then the rest, exactly
    the reference's concatenation order) and the vox region is the
    leading vox-covered split of the same single sdf_fn evaluation."""
    pts = np.concatenate([pts_and_vox, pts_not_vox])
    gt = np.concatenate([gt_and_vox, gt_not_vox])
    n_vox = len(pts_and_vox)
    sdf_all = (np.asarray(sdf_fn(pts)).reshape(-1) if len(pts)
               else np.zeros(0, np.float32))
    out = {}
    for name, sdf, g in [("vis", sdf_all, gt),
                         ("vox", sdf_all[:n_vox], gt[:n_vox])]:
        if len(g) == 0:
            out[name] = {"av_l1": float("nan"), "binned_l1": [],
                         "l1_chomp_costs": []}
            continue
        diff = np.abs(sdf - g)
        out[name] = {
            "av_l1": float(diff.mean()),
            "binned_l1": MET.binned_losses(diff, g),
            "l1_chomp_costs": [
                float(np.abs(MET.chomp_cost(sdf, e)
                             - MET.chomp_cost(g, e)).mean())
                for e in CHOMP_EPSILONS],
        }
    return out


def eval_grad_fd(sdf_fn, pts, delta: float):
    """Central-difference gradients (reference eval_grad,
    eval_pts.py:68-93, used for grid baselines)."""
    g = np.empty((len(pts), 3), np.float32)
    for d in range(3):
        off = np.zeros(3, np.float32)
        off[d] = delta
        g[:, d] = (np.asarray(sdf_fn(pts + off))
                   - np.asarray(sdf_fn(pts - off))) / (2 * delta)
    return g


def fixed_pts_eval(
    sdf_fn: Callable,
    t: float,
    eval_pts_dir: Optional[str],
    depth_batch,
    T_WC_batch,
    dirs_C,
    gt_sdf_fn: Callable,
    dataset_format: str = "replicaCAD",
    grad_fn: Optional[Callable] = None,
    gt_grad_fn: Optional[Callable] = None,
    samples: int = 200000,
    vol_pts=None,
    vol_gt=None,
    eval_pts_root: Optional[str] = None,
    seq_dir: Optional[str] = None,
    obj_bounds=None,
) -> Dict:
    """One timed evaluation entry (vox_res.json schema).

    eval_pts_dir: the reference's per-sequence eval_pts root; when None or
    missing, all sampled points with finite GT are scored (vox split
    empty).

    Full-volume region: the reference scores every method on PRE-BAKED
    volume points (isdf/eval/eval_pts.py:260-297 — replicaCAD shares
    ``full_vol/replicaCAD.npy``, ScanNet uses ``full_vol/{seq}.npy``, GT
    values from ``full_vol/gt_{seq}.npy``). Pass them via
    (vol_pts, vol_gt), or give eval_pts_root + seq_dir and they are
    loaded from the same layout; only when neither exists does the
    protocol degrade to seeded uniform sampling in the observed volume
    (self-comparable, NOT baseline-comparable)."""
    t_str = f"{t:.3f}"
    dist_behind = 0.0 if dataset_format == "ScanNet" else 0.1
    res: Dict = {"time": t}

    masks = None
    masks_dir = os.path.join(eval_pts_dir, t_str) if eval_pts_dir else None
    if masks_dir and os.path.isdir(masks_dir):
        masks = {n: np.load(os.path.join(masks_dir, n + ".npy"))
                 for n in ["surf_valid_gt_sdf", "surf_valid_vox_sdf",
                           "vis_valid_gt_sdf", "vis_valid_vox_sdf",
                           "vis_valid_gt_grad", "vis_valid_vox_grad"]}

    def _region(pts, gt_key, vox_key):
        gt = np.asarray(gt_sdf_fn(pts)).reshape(-1)
        if masks is not None:
            pts = pts[masks[gt_key]]
            gt = gt[masks[gt_key]]
            vox = masks[vox_key]
            return _sub_eval(sdf_fn, pts[vox], pts[~vox], gt[vox], gt[~vox])
        ok = np.isfinite(gt) & (gt != 0.0)
        # mask-free degradation: every scored point is the vis region,
        # the vox split is empty
        return _sub_eval(sdf_fn, pts[ok][:0], pts[ok], gt[ok][:0], gt[ok])

    # visible region
    pts = _torch_sample_rays(t_str, depth_batch, T_WC_batch, dirs_C,
                             dist_behind, surface=False, samples=samples)
    res["rays"] = _region(pts, "vis_valid_gt_sdf", "vis_valid_vox_sdf")

    # gradient cosine distance in the visible region
    if grad_fn is not None:
        pts_all = _torch_sample_rays(t_str, depth_batch, T_WC_batch, dirs_C,
                                     dist_behind, surface=False,
                                     samples=samples)
        if gt_grad_fn is not None:
            gt_grad = np.asarray(gt_grad_fn(pts_all))
            gvalid = np.isfinite(gt_grad).all(-1)
        else:
            gt_grad = eval_grad_fd(gt_sdf_fn, pts_all, 0.01)
            gvalid = np.isfinite(gt_grad).all(-1)
        def _n(v):
            return v / np.maximum(
                np.linalg.norm(v, axis=-1, keepdims=True), 1e-6)

        def _cosd(p, gg):
            if len(p) == 0:
                return float("nan")
            g_pred = np.asarray(grad_fn(p))
            return float((1 - (_n(g_pred) * _n(gg)).sum(-1)).mean())

        if masks is not None:
            gvalid &= masks["vis_valid_gt_grad"]
            cosd_vis = _cosd(pts_all[gvalid], gt_grad[gvalid])
            # the vox split is the NESTED subset of the grad-valid points:
            # the reference chains the masks pts_all -> [vis_valid_gt_sdf]
            # -> [vis_valid_vox_sdf] -> [grad-valid restricted to that
            # chain] (isdf/eval/eval_pts.py:148-159) — the vox-region
            # cossim is computed on ITS OWN subset, not copied from vis
            chain = masks["vis_valid_gt_grad"][masks["vis_valid_gt_sdf"]][
                masks["vis_valid_vox_sdf"]]
            vox_pts = pts_all[masks["vis_valid_gt_sdf"]][
                masks["vis_valid_vox_sdf"]][chain]
            gt_grad_vox = gt_grad[masks["vis_valid_gt_sdf"]][
                masks["vis_valid_vox_sdf"]][chain]
            # also respect finite-GT validity on the nested subset
            vfin = np.isfinite(gt_grad_vox).all(-1)
            cosd_vox = _cosd(vox_pts[vfin], gt_grad_vox[vfin])
            # reference stores [vox_1, vox_1] (eval_pts.py:190) and
            # [vis_1, vis_2]; with an analytic grad_fn grad_2 == grad_1
            res["rays"]["vis"]["av_cossim"] = [cosd_vis, cosd_vis]
            res["rays"]["vox"]["av_cossim"] = [cosd_vox, cosd_vox]
        else:
            # mask-free degradation: everything scored is the vis split
            # (the vox split is empty — mirror _region's behaviour)
            cosd = _cosd(pts_all[gvalid], gt_grad[gvalid])
            res["rays"]["vis"]["av_cossim"] = [cosd, cosd]
            res["rays"]["vox"]["av_cossim"] = [cosd, cosd]

    # surface region
    pts = _torch_sample_rays(t_str, depth_batch, T_WC_batch, dirs_C,
                             0.0, surface=True, samples=samples)
    res["visible_surf"] = _region(pts, "surf_valid_gt_sdf",
                                  "surf_valid_vox_sdf")

    # full-volume region: pre-baked points + GT (baseline-comparable)
    if vol_pts is None and eval_pts_root and seq_dir:
        seq = [x for x in seq_dir.split("/") if x][-1]
        name = ("replicaCAD" if dataset_format == "replicaCAD" else seq)
        vol_file = os.path.join(eval_pts_root, "full_vol", name + ".npy")
        gt_file = os.path.join(eval_pts_root, "full_vol",
                               f"gt_{seq}.npy")
        if os.path.exists(vol_file) and os.path.exists(gt_file):
            vol_pts = np.load(vol_file)
            vol_gt = np.load(gt_file)

    if vol_pts is not None:
        pts = np.asarray(vol_pts, np.float32)
        if vol_gt is not None:
            # reference semantics: gt values come from the baked file,
            # no validity filtering (eval_pts.py:273-297)
            gt = np.asarray(vol_gt).reshape(-1)
            ok = np.ones(len(pts), bool)
        else:
            gt = np.asarray(gt_sdf_fn(pts)).reshape(-1)
            ok = np.isfinite(gt) & (gt != 0.0)
    else:
        rng = np.random.default_rng(int(float(t_str) * 1e3))
        depth_np = np.asarray(depth_batch)
        # bound the volume by the frames' positions +/- max observed depth
        cams = np.asarray(T_WC_batch)[:, :3, 3]
        r = float(depth_np.max()) if depth_np.size else 5.0
        lo, hi = cams.min(0) - r, cams.max(0) + r
        pts = rng.uniform(lo, hi, size=(samples // 4, 3)).astype(np.float32)
        gt = np.asarray(gt_sdf_fn(pts)).reshape(-1)
        ok = np.isfinite(gt) & (gt != 0.0)
    if ok.any():
        sdf = np.asarray(sdf_fn(pts[ok])).reshape(-1)
        diff = np.abs(sdf - gt[ok])
        res["vol"] = {
            "av_l1": float(diff.mean()),
            "binned_l1": MET.binned_losses(diff, gt[ok]),
            "l1_chomp_costs": [
                float(np.abs(MET.chomp_cost(sdf, e)
                             - MET.chomp_cost(gt[ok], e)).mean())
                for e in CHOMP_EPSILONS],
        }

    # per-object region (reference eval_pts.py object_eval_pts: seeded
    # uniform samples in each expanded bbox)
    if obj_bounds is not None:
        rng = np.random.default_rng(0)
        errs = []
        for bounds in obj_bounds:
            o = rng.random((10000, 3)).astype(np.float32)
            p = bounds[0] + o * (bounds[1] - bounds[0])
            gt = np.asarray(gt_sdf_fn(p)).reshape(-1)
            ok = np.isfinite(gt) & (gt != 0.0)
            if not ok.any():
                errs.append(float("nan"))
                continue
            sdf = np.asarray(sdf_fn(p[ok])).reshape(-1)
            errs.append(float(np.abs(sdf - gt[ok]).mean()))
        res["objects"] = {"l1": errs}
    return res
