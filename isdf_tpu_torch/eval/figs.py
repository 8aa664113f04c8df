"""Result aggregation and slice figures (isdf_tpu/eval/figs.py).

Reference: isdf/eval/figs/{all_seq.py,per_seq.py,slices.py}. Reads the
per-run vox_res.json / res.json files (the port's runs, isdf_tpu's and the
reference's shipped exp0 runs share the schema), aggregates mean +/- std
over the seeded repeats of a sequence, and writes slice comparisons as
PNGs (utils/image_io.py). The three figures, ``plot_fig8``,
``plot_all_seq`` and ``plot_per_seq``, make isdf_tpu's matplotlib calls on
the port's own plot kit (vis/plot.py; the card machine has no matplotlib).
"""

import glob
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from isdf_tpu_torch.train.batch import REPLICACAD_SEQS, SCANNET_SEQS
from isdf_tpu_torch.vis import plot as plt


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
# the paper's sequence grid (reference all_seq.py:29-37) is train/batch.py's
# REPLICACAD_SEQS and SCANNET_SEQS
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


def plot_fig8(isdf_root: str, out_file: str, split: str = "vis",
              seq_rows: Optional[List[List[str]]] = None,
              label: str = "iSDF"):
    """The paper's all-sequence figure (reference all_seq.py:430-470
    fig_vis/fig_vox): rows = [sdf, chomp, grad] × sequence-rows, cols =
    sequences; each panel mean ± std over the seeded repeats. Returns
    {seq: {metric: (times, mean, std, n)}} so callers/tests can check
    the aggregated numbers."""
    if seq_rows is None:
        seq_rows = [REPLICACAD_SEQS, SCANNET_SEQS]
    ncols = len(seq_rows[0])
    metrics = ["sdf", "chomp", "grad"]
    ylabels = {"sdf": "SDF error [cm]", "chomp": "Collision cost error",
               "grad": "Gradient cosine distance"}
    nrows = len(seq_rows) * len(metrics)
    fig, ax = plt.subplots(nrows=nrows, ncols=ncols,
                           figsize=(4.3 * ncols, 3.2 * nrows),
                           squeeze=False)
    stats: Dict[str, Dict[str, tuple]] = {}
    for sr, row_seqs in enumerate(seq_rows):
        for c, seq in enumerate(row_seqs):
            for mi, metric in enumerate(metrics):
                a = ax[sr * len(metrics) + mi][c]
                try:
                    t, m, s, n = aggregate_exp0(isdf_root, seq,
                                                metric, split)
                except FileNotFoundError:
                    a.set_visible(False)
                    continue
                stats.setdefault(seq, {})[metric] = (t, m, s, n)
                a.plot(t, m, color="C0",
                       label=f"{label} (n={n})" if mi == 0 else None)
                a.fill_between(t, m - s, m + s, alpha=0.4, color="C0")
                if mi == 0:
                    a.set_title(seq, style="italic")
                    a.legend(fontsize=8)
                a.set_ylabel(ylabels[metric], fontsize=8)
                if mi == len(metrics) - 1:
                    a.set_xlabel("Sequence time [s]")
    fig.suptitle(f"{split} region", y=1.0)
    fig.tight_layout()
    fig.savefig(out_file, dpi=110)
    plt.close(fig)
    return stats


def plot_all_seq(root: str, out_file: str,
                 metric=("rays", "vis", "av_l1"),
                 ylabel: str = "SDF error [m]",
                 baselines: Optional[Dict[str, str]] = None,
                 voxblox_root: Optional[str] = None,
                 gpuf_root: Optional[str] = None,
                 fname: str = "vox_res.json"):
    """Fig-8-style grid: one panel per sequence, mean +/- std band per
    method (reference all_seq.py:289-428). ``baselines`` maps label ->
    results root in the same (isdf) layout; ``voxblox_root`` /
    ``gpuf_root`` overlay the published grid baselines from their OWN
    result formats (eval/baselines.py: voxblox res.json nn/vox regions,
    KinectFusion+ vox_res.json)."""
    methods = {"isdf_tpu": root}
    if baselines:
        methods.update(baselines)

    all_groups = {label: runs_by_sequence(r, fname)
                  for label, r in methods.items()}
    seqs = sorted({s for g in all_groups.values() for s in g})
    if not seqs:
        raise ValueError(f"no runs found under {root}")

    ncol = min(3, len(seqs))
    nrow = int(np.ceil(len(seqs) / ncol))
    fig, axes = plt.subplots(nrow, ncol, figsize=(5 * ncol, 3.5 * nrow),
                             squeeze=False)
    for i, seq in enumerate(seqs):
        ax = axes[i // ncol][i % ncol]
        for label, groups in all_groups.items():
            if seq not in groups:
                continue
            ms = mean_std_curve(groups[seq], metric)
            if ms is None:
                continue
            t, m, s = ms
            ax.plot(t, m, label=f"{label} (n={len(groups[seq])})")
            ax.fill_between(t, m - s, m + s, alpha=0.25)
        which = ("sdf_vox" if len(metric) > 1 and metric[1] == "vox"
                 else "sdf_vis")
        if voxblox_root is not None:
            from isdf_tpu_torch.eval.baselines import load_voxblox_res
            try:
                c = load_voxblox_res(voxblox_root, seq)
                ax.plot(c["times"], c[which], label="Voxblox", color="C1")
            except FileNotFoundError:
                pass
        if gpuf_root is not None:
            from isdf_tpu_torch.eval.baselines import load_gpu_fusion_res
            try:
                c = load_gpu_fusion_res(gpuf_root, seq)
                ax.plot(c["times"], c[which], label="KinectFusion+",
                        color="C2")
            except FileNotFoundError:
                pass
        ax.set_title(seq)
        ax.set_xlabel("simulated time [s]")
        ax.set_ylabel(ylabel)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_file, dpi=120)
    plt.close(fig)
    return out_file


def plot_per_seq(run_dir: str, out_file: str,
                 fname: str = "vox_res.json", dataset=None,
                 fps: float = 30.0):
    """Single-run dashboard (reference eval/figs/per_seq.py save_plots):
    average + surface L1, binned-L1 panel, CHOMP costs, gradient-cossim
    panel, and the keyframe timeline strip (draw_keyframes,
    per_seq.py:113-178 — depth thumbnails at each keyframe's sim time
    when a ``dataset`` is passed, event markers otherwise).

    Handles both artifact schemas: vox_res.json (vis/vox nesting +
    av_cossim + visible_surf) and the flat online res.json (av_l1 /
    binned_l1 / l1_chomp_costs only) — panels whose fields are absent
    from the artifact are annotated rather than left broken."""
    full = load_run(run_dir, fname) or load_run(run_dir, "res.json")
    if not full:
        raise ValueError(f"no results in {run_dir}")
    run = full.get("sdf_eval", full)
    kf_ids = full.get("kf_indices", [])

    def _series(field, idx=None, region="vis", top="rays"):
        ts, vals = [], []
        for k, entry in run.items():
            if not (isinstance(entry, dict) and top in entry):
                continue
            r = entry[top]
            if isinstance(r, dict) and ("vis" in r or "vox" in r):
                r = r.get(region)
            elif region != "vis":
                r = None          # flat (online) schema is vis-only
            if not isinstance(r, dict) or field not in r:
                continue
            ts.append(entry.get("time", float(k)))
            v = r[field]
            vals.append(v[idx] if idx is not None else v)
        order = np.argsort(ts)
        return (np.asarray(ts)[order],
                np.asarray(vals, float)[order])

    fig = plt.figure(figsize=(16, 9))
    gs = fig.add_gridspec(3, 4, height_ratios=[1, 1, 0.6])
    axes = [fig.add_subplot(gs[r, c]) for r in range(2) for c in range(4)]
    ax_kf = fig.add_subplot(gs[2, :])

    # row 1: average L1 (vis + vox), surface L1, binned, chomp
    for region, style in (("vis", "-"), ("vox", "--")):
        t, l1 = _series("av_l1", region=region)
        if len(t):
            axes[0].plot(t, l1, style, label=region)
    axes[0].set_title("SDF L1 [m] (Average)")
    axes[0].legend(fontsize=7)

    ts, sv = _series("av_l1", region="vis", top="visible_surf")
    if len(ts):
        axes[1].plot(ts, sv)
    else:
        axes[1].annotate("no surface region\n(online res.json)",
                         (0.5, 0.5), xycoords="axes fraction",
                         ha="center", fontsize=9, color="gray")
    axes[1].set_title("Surface (s = 0 cm) L1 [m]")

    bin_labels = ["<0", "0-0.1", "0.1-0.2", "0.2-0.5", "0.5-1", ">1"]
    for b, lab in enumerate(bin_labels):
        ts, vals = _series("binned_l1", b)
        if len(ts):
            axes[2].plot(ts, vals, label=lab)
    axes[2].set_title("binned L1 by GT distance [m]")
    axes[2].legend(fontsize=7)

    for i, eps in enumerate([1.0, 1.5, 2.0]):
        ts, vals = _series("l1_chomp_costs", i)
        if len(ts):
            axes[3].plot(ts, vals, label=f"eps={eps}")
    axes[3].set_title("CHOMP-cost |error|")
    axes[3].legend(fontsize=7)

    # row 2: gradient cossim (vis + vox), vol-region L1, eval cadence
    any_cos = False
    for region, style in (("vis", "-"), ("vox", "--")):
        ts, vals = _series("av_cossim", 0, region=region)
        if len(ts):
            axes[4].plot(ts, vals, style, label=region)
            any_cos = True
    if not any_cos:
        axes[4].annotate("no cossim in artifact\n(online res.json)",
                         (0.5, 0.5), xycoords="axes fraction",
                         ha="center", fontsize=9, color="gray")
    axes[4].set_title("gradient cosine distance")
    if any_cos:
        axes[4].legend(fontsize=7)

    ts, vals = _series("av_l1", top="vol", region="vis")
    if len(ts):
        axes[5].plot(ts, vals, label="vol")
    # per-object region (reference per_seq objects column): mean L1 over
    # the obj_bounds boxes at each eval mark
    ts_o, vals_o = [], []
    for k, entry in run.items():
        if isinstance(entry, dict) and isinstance(entry.get("objects"),
                                                  dict):
            arr = [v for v in entry["objects"].get("l1", [])
                   if v is not None and np.isfinite(v)]
            if arr:
                ts_o.append(entry.get("time", float(k)))
                vals_o.append(float(np.mean(arr)))
    if ts_o:
        order = np.argsort(ts_o)
        axes[5].plot(np.asarray(ts_o)[order],
                     np.asarray(vals_o)[order], "--", label="objects")
    if len(ts) or ts_o:
        axes[5].legend(fontsize=7)
    else:
        axes[5].annotate("no full-volume region", (0.5, 0.5),
                         xycoords="axes fraction", ha="center",
                         fontsize=9, color="gray")
    axes[5].set_title("full-volume / objects L1 [m]")

    t_all, l1_all = _series("av_l1")
    if len(t_all) >= 2:
        axes[6].plot(t_all[1:], np.diff(t_all), ".-")
    axes[6].set_title("eval cadence [s]")

    # first/last binned profile (convergence fingerprint)
    if len(t_all):
        series = [_series("binned_l1", b)[1] for b in range(6)]
        for which, style in ((0, ":"), (-1, "-")):
            prof = [p[which] for p in series if len(p)]
            if prof:
                axes[7].plot(range(len(prof)), prof, style,
                             label=f"t={t_all[which]:.0f}s")
        axes[7].set_xticks(range(6), bin_labels, fontsize=7)
        axes[7].legend(fontsize=7)
    axes[7].set_title("binned profile first vs last")

    for ax in axes[:7]:
        ax.set_xlabel("simulated time [s]", fontsize=8)

    # bottom strip: keyframe timeline (reference draw_keyframes)
    t_end = float(t_all[-1]) if len(t_all) else (
        max(kf_ids) / fps if kf_ids else 1.0)
    kf_times = [i / fps for i in kf_ids]
    ax_kf.vlines(kf_times, 0, 1, color="C3", lw=1)
    ax_kf.set_xlim(0, max(t_end, 1e-3))
    ax_kf.set_yticks([])
    ax_kf.set_xlabel("simulated time [s]")
    ax_kf.set_title(f"keyframe timeline ({len(kf_ids)} keyframes)")
    if dataset is not None and kf_ids:
        # depth thumbnails at keyframe sim times
        for fid, kt in zip(kf_ids, kf_times):
            try:
                s = dataset[int(fid)]
            except Exception:
                continue
            dep = np.asarray(s["depth"], float)
            dep = dep / max(np.nanmax(dep), 1e-6)
            w = t_end * 0.055
            ax_kf.imshow(dep, extent=(kt, kt + w, 0.15, 0.95),
                         aspect="auto", cmap="viridis", zorder=2)
        ax_kf.set_ylim(0, 1)

    fig.tight_layout()
    fig.savefig(out_file, dpi=120)
    plt.close(fig)
    return out_file


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
