"""Baseline result and grid loaders: Voxblox and KinectFusion+ (gpu_fusion)
(isdf_tpu/eval/baselines.py).

Matched to the reference's figure tooling (isdf/eval/plot_utils.py:107-192
and the per-method result readers of isdf/eval/figs/all_seq.py:289-428), so
the baselines' published results can be set beside the port's runs and
queried as SDF grids for slice comparisons.

On-disk contracts (the baselines' own output formats):
  * KinectFusion+: ``{root}/{seq}/vox_res.json`` — flat {t: entry} with
    the standard rays.{vis,vox} metric schema; dense SDF as
    ``final_sdf.txt``/``{t:.3f}.txt`` + ``transform.txt`` (gpufusion
    format: dims / voxel size / offset header lines).
  * Voxblox: ``{root}/{seq}/res.json`` with an ``sdf_eval`` section whose
    per-timestamp entries carry rays.{nn,vox,fill} regions (nn = nearest-
    neighbour filled visible region, fill = default-value fill); dense
    SDF as scattered ``out/{t}.npy`` text files of [x y z sdf] rows plus
    ``params.json`` (voxel_size).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


def load_gpu_fusion_res(root: str, seq: str,
                        chomp_ix: int = 0, cossim_ix: int = 0) -> Dict:
    """KinectFusion+ result curves (reference all_seq.py:289-341)."""
    with open(os.path.join(root, seq, "vox_res.json")) as f:
        res = json.load(f)
    out = {k: [] for k in ("times", "sdf_vis", "sdf_vox", "chomp_vis",
                           "chomp_vox", "grad_vis", "grad_vox")}
    for t in res:
        e = res[t]
        out["times"].append(e["time"])
        out["sdf_vis"].append(e["rays"]["vis"]["av_l1"])
        out["sdf_vox"].append(e["rays"]["vox"]["av_l1"])
        out["chomp_vis"].append(e["rays"]["vis"]["l1_chomp_costs"][chomp_ix])
        out["chomp_vox"].append(e["rays"]["vox"]["l1_chomp_costs"][chomp_ix])
        out["grad_vis"].append(e["rays"]["vis"]["av_cossim"][cossim_ix])
        out["grad_vox"].append(e["rays"]["vox"]["av_cossim"][cossim_ix])
    return {k: np.asarray(v) for k, v in out.items()}


def load_voxblox_res(root: str, seq: str,
                     chomp_ix: int = 0, cossim_ix: int = 0) -> Dict:
    """Voxblox result curves (reference all_seq.py:346-428): the visible
    curve uses the ``nn`` region for sdf/grad and ``fill`` for chomp;
    also returns the mapped-region proportion."""
    with open(os.path.join(root, seq, "res.json")) as f:
        res = json.load(f)["sdf_eval"]
    res.pop("bins_lb", None)
    res.pop("bins_ub", None)
    out = {k: [] for k in ("times", "sdf_vis", "sdf_vox", "chomp_vis",
                           "chomp_vox", "grad_vis", "grad_vox",
                           "prop_vox")}
    for t in res:
        e = res[t]
        out["times"].append(e["time"])
        out["prop_vox"].append(e["rays"]["vox"]["prop_vox"])
        out["sdf_vis"].append(e["rays"]["nn"]["av_l1"])
        out["sdf_vox"].append(e["rays"]["vox"]["av_l1"])
        out["chomp_vis"].append(e["rays"]["fill"]["l1_chomp_costs"][chomp_ix])
        out["chomp_vox"].append(e["rays"]["vox"]["l1_chomp_costs"][chomp_ix])
        out["grad_vis"].append(e["rays"]["nn"]["av_cossim"][cossim_ix])
        out["grad_vox"].append(e["rays"]["vox"]["av_cossim"][cossim_ix])
    return {k: np.asarray(v) for k, v in out.items()}


def gpuf_sdf_interp(exp_dir: str, eval_t: Optional[float] = None):
    """KinectFusion+ dense-grid interpolator
    (reference plot_utils.py:107-117)."""
    from isdf_tpu_torch.data import sdf_util as SU
    sdf_file = ("final_sdf.txt" if eval_t is None else f"{eval_t:.3f}.txt")
    sdf, transform = SU.read_sdf_gpufusion(
        os.path.join(exp_dir, sdf_file),
        os.path.join(exp_dir, "transform.txt"))
    return SU.sdf_interpolator(sdf, transform)


def voxblox_sdf_interp(exp_dir: str, bounds_lo, bounds_hi,
                       eval_t: Optional[float] = None):
    """Voxblox interpolator from scattered [x y z sdf] samples snapped to
    an axis-aligned grid (reference plot_utils.py:132-192). ``bounds_*``
    replace the reference's trimesh gt-mesh bounds (domain only);
    unmapped cells are NaN so OOB handling can mask them.
    """
    from scipy.interpolate import RegularGridInterpolator

    with open(os.path.join(exp_dir, "params.json")) as f:
        vsm = json.load(f)["voxel_size"]
    lo = np.asarray(bounds_lo, np.float64)
    hi = np.asarray(bounds_hi, np.float64)
    start = lo - lo % vsm + vsm / 2 - 20 * vsm
    end = hi + 20 * vsm
    ax = [np.arange(start[d], end[d], step=vsm) for d in range(3)]
    dims = [len(a) for a in ax]

    with open(os.path.join(exp_dir, "res.json")) as f:
        res = json.load(f)["sdf_eval"]
    res.pop("bins_lb", None)
    res.pop("bins_ub", None)
    if eval_t is None:
        key = list(res.keys())[-1]
    else:
        times = [res[k]["time"] for k in res]
        key = list(res.keys())[times.index(eval_t)]

    sdf = np.loadtxt(os.path.join(exp_dir, "out", key + ".npy"))
    sdf[:, :3] = np.round(sdf[:, :3] * 2 / vsm) * vsm / 2

    grid = np.full(dims, np.nan)
    ixs = np.rint((sdf[:, :3] - start) / vsm).astype(int)
    ok = ((ixs >= 0) & (ixs < np.asarray(dims)[None, :])).all(-1)
    ixs, vals = ixs[ok], sdf[ok, 3]
    grid[ixs[:, 0], ixs[:, 1], ixs[:, 2]] = vals
    return RegularGridInterpolator(tuple(ax), grid, bounds_error=False,
                                   fill_value=np.nan)
