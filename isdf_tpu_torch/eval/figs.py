"""Result aggregation and slice figures (isdf_tpu/eval/figs.py).

Reference: isdf/eval/figs/{all_seq.py,per_seq.py,slices.py}. Reads the
per-run vox_res.json / res.json files (the port's runs, isdf_tpu's and the
reference's shipped exp0 runs share the schema), aggregates mean +/- std
over the seeded repeats of a sequence, and writes slice comparisons as
PNGs (utils/image_io.py). The three matplotlib figures, ``plot_fig8``,
``plot_all_seq`` and ``plot_per_seq``, wait for the port's viewer slice
(a rasteriser with text): the card machine has no matplotlib.
"""

import glob
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_run(run_dir: str, fname: str = "vox_res.json") -> Optional[Dict]:
    p = os.path.join(run_dir, fname)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f, parse_constant=lambda c: float("nan"))


def runs_by_sequence(root: str, fname: str = "vox_res.json"
                     ) -> Dict[str, List[Dict]]:
    """Group <root>/<seq>_<i>/ run dirs by sequence name
    (reference all_seq.py:184-231 over results/iSDF/exp0)."""
    out: Dict[str, List[Dict]] = {}
    for d in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(d):
            continue
        m = re.match(r"(.+)_(\d+)$", os.path.basename(d))
        if not m:
            continue
        r = load_run(d, fname)
        if r is not None:
            out.setdefault(m.group(1), []).append(r)
    return out


def _get_path(d: Dict, path: Sequence[str]):
    for k in path:
        d = d[k]
    return d


def curve(run: Dict, metric=("rays", "vis", "av_l1")
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(times, values) of one run's timed entries. Keys of vox_res.json
    are the eval wall-times (stringified floats)."""
    run = run.get("sdf_eval", run)  # res.json nests entries
    ts, vs = [], []
    for k, entry in run.items():
        if not isinstance(entry, dict):
            continue
        try:
            v = _get_path(entry, metric)
        except (KeyError, TypeError):
            continue
        ts.append(entry.get("time", float(k)))
        vs.append(v)
    order = np.argsort(ts)
    return np.asarray(ts)[order], np.asarray(vs, float)[order]


def mean_std_curve(runs: List[Dict], metric=("rays", "vis", "av_l1"),
                   n_grid: int = 50):
    """Interpolate each run's curve onto a common time grid, return
    (t, mean, std) (reference all_seq.py:233-271)."""
    curves = [curve(r, metric) for r in runs]
    curves = [(t, v) for t, v in curves if len(t) >= 2]
    if not curves:
        return None
    t0 = max(t[0] for t, _ in curves)
    t1 = min(t[-1] for t, _ in curves)
    grid = np.linspace(t0, t1, n_grid)
    interp = np.stack([np.interp(grid, t, v) for t, v in curves])
    return grid, np.nanmean(interp, axis=0), np.nanstd(interp, axis=0)


def final_values(runs: List[Dict], metric=("rays", "vis", "av_l1")):
    """Mean +/- std of each run's final eval (the BASELINE.md numbers)."""
    vals = []
    for r in runs:
        t, v = curve(r, metric)
        if len(v):
            vals.append(v[-1])
    if not vals:
        return float("nan"), float("nan")
    return float(np.nanmean(vals)), float(np.nanstd(vals))


# paper metric picks (reference all_seq.py:17-18)
CHOMP_IX = 2    # epsilon = 2 m
COSSIM_IX = 1   # delta = two voxels


def aggregate_exp0(root: str, seq: str, metric: str = "sdf",
                   split: str = "vis"):
    """Reference-exact aggregation over <root>/<seq>_<i>/vox_res.json
    (all_seq.py:184-258): runs that did not reach the final eval
    timestamp are dropped; the remaining runs' values are stacked
    [n_runs, n_times] and reduced to mean/std per timestamp. SDF errors
    are converted to cm (×100) exactly like the paper plots.

    metric: "sdf" | "chomp" | "grad"; split: "vis" | "vox".
    Returns (times, mean, std, n_runs)."""
    run_dirs = sorted(d for d in glob.glob(os.path.join(root, seq + "_*"))
                      if os.path.isdir(d))
    runs = [r for r in (load_run(d) for d in run_dirs) if r]
    if not runs:
        raise FileNotFoundError(f"no {seq}_* runs under {root}")
    # the reference reads last_t from the eval_pts tree
    # (plot_utils.py:81-110); equivalently it is the largest timestamp
    # any run reached — runs missing it are unfinished and dropped
    last_t = max(max(e["time"] for e in r.values()) for r in runs)
    complete = [r for r in runs
                if any(e["time"] == last_t for e in r.values())]

    def _vals(entry):
        r = entry["rays"][split]
        if metric == "sdf":
            return 100.0 * r["av_l1"]
        if metric == "chomp":
            return r["l1_chomp_costs"][CHOMP_IX]
        if metric == "grad":
            return r["av_cossim"][COSSIM_IX]
        raise ValueError(metric)

    times = [e["time"] for e in complete[0].values()]
    stack = np.array([[_vals(e) for e in r.values()] for r in complete])
    return (np.asarray(times), stack.mean(axis=0), stack.std(axis=0),
            len(complete))


_PLOTS_LATER = ("{} draws with matplotlib, which the port does not use; it "
                "is ported with the viewer slice (vis/*), which brings a "
                "rasteriser with text")


def plot_fig8(isdf_root: str, out_file: str, **kw):
    """The paper's all-sequence figure (isdf_tpu figs.py:146): not ported
    yet."""
    raise NotImplementedError(_PLOTS_LATER.format("plot_fig8"))


def plot_all_seq(root: str, out_file: str, **kw):
    """The fig-8-style grid per sequence (isdf_tpu figs.py:196): not
    ported yet."""
    raise NotImplementedError(_PLOTS_LATER.format("plot_all_seq"))


def plot_per_seq(run_dir: str, out_file: str, **kw):
    """The single-run dashboard (isdf_tpu figs.py:265): not ported yet."""
    raise NotImplementedError(_PLOTS_LATER.format("plot_per_seq"))


def slice_comparison_with_baselines(trainer, out_file: str, seq: str,
                                    voxblox_root: Optional[str] = None,
                                    gpuf_root: Optional[str] = None,
                                    n_slices: int = 3):
    """One-call multi-method slice comparison against the published grid
    baselines (reference eval/figs/slices.py drives iSDF + voxblox +
    KinectFusion+ on the same planes): loads each baseline's SDF grid
    for ``seq`` via eval/baselines.py, wraps it as an interpolating
    callable, and renders all methods on the trainer's slice planes.
    Baselines whose artifacts are absent are skipped."""
    from isdf_tpu_torch.eval import baselines as B

    methods, labels = [trainer], ["isdf_tpu"]
    if voxblox_root is not None:
        try:
            pc = trainer.grid_pc.cpu().numpy()
            interp = B.voxblox_sdf_interp(
                os.path.join(voxblox_root, seq),
                pc.min(axis=0), pc.max(axis=0))
            methods.append(lambda p, _f=interp: _f(np.asarray(p)))
            labels.append("Voxblox")
        except (FileNotFoundError, OSError, KeyError, IndexError):
            pass
    if gpuf_root is not None:
        try:
            from isdf_tpu_torch.data.sdf_util import eval_sdf_interp
            interp = B.gpuf_sdf_interp(os.path.join(gpuf_root, seq))
            methods.append(
                lambda p, _f=interp: eval_sdf_interp(
                    _f, np.asarray(p), handle_oob="fill",
                    oob_val=float("nan")))
            labels.append("KinectFusion+")
        except (FileNotFoundError, OSError, KeyError):
            pass
    return slice_comparison(methods, out_file, n_slices=n_slices,
                            labels=labels, ref_trainer=trainer)


def slice_comparison(methods, out_file: str, n_slices: int = 3,
                     labels=None, ref_trainer=None):
    """Side-by-side SDF slice images per method
    (reference eval/figs/slices.py): one row per method, one column per
    slice. Each method is a Trainer, a slice-PNG directory, or a callable
    ``pts [N,3] -> sdf [N]`` (e.g. a grid-baseline interpolator from
    eval/baselines.py — all callables are rendered on the SAME slice
    planes as the (first) trainer, matching the reference's multi-method
    comparison which queries every baseline on iSDF's planes)."""
    from isdf_tpu_torch.utils import image_io as IO
    from isdf_tpu_torch.vis.slices import (compute_slices, sdf_colormap,
                                           slice_planes)

    trainer = ref_trainer or next(
        (m for m in methods if not isinstance(m, str) and not callable(m)),
        None)

    def _callable_slices(fn):
        if trainer is None:
            raise ValueError("a Trainer is required to define the slice "
                             "planes for callable methods")
        up_ix = getattr(trainer, "up_ix", 1)
        pc = slice_planes(trainer, n_slices).cpu().numpy()
        sdf = np.nan_to_num(
            np.asarray(fn(pc.reshape(-1, 3))).reshape(pc.shape[:-1]))
        img = sdf_colormap(sdf)
        return [np.take(img, i, axis=up_ix) for i in range(n_slices)]

    rows = []
    for i, item in enumerate(methods):
        if isinstance(item, str):
            imgs = [IO.imread(os.path.join(item, f"pred_{s}.png"))[..., ::-1]
                    for s in range(n_slices)]
        elif callable(item) and not hasattr(item, "sdf_fn"):
            imgs = _callable_slices(item)
        else:
            imgs = compute_slices(item, n_slices=n_slices)["pred_sdf"]
        h = min(im.shape[0] for im in imgs)
        rows.append(np.concatenate([im[:h] for im in imgs], axis=1))
    w = min(r.shape[1] for r in rows)
    grid = np.concatenate([r[:, :w] for r in rows], axis=0)
    IO.imwrite(out_file, grid[..., ::-1])
    return out_file
