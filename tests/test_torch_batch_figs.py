"""The port's batch runner (train/batch.py), baseline readers
(eval/baselines.py) and figure tooling (eval/figs.py) against isdf_tpu's
on the CPU.

* The config generators give isdf_tpu's jobs.
* ``run_jobs`` retries a failed job, records a job that keeps failing as
  None, and ``run`` removes a stale res.json / vox_res.json first.
* The baseline loaders and interpolators equal isdf_tpu's on files the
  test writes.
* The aggregation (``runs_by_sequence``, ``curve``, ``mean_std_curve``,
  ``final_values``, ``aggregate_exp0``) equals isdf_tpu's on run
  directories written by both packages' loops.
* ``slice_comparison`` equals isdf_tpu's on the same weights, but for at
  most 0.1% of pixels, each by one colormap bin.
* ``plot_fig8``, ``plot_all_seq`` and ``plot_per_seq`` (drawn by the
  port's plot kit, vis/plot.py) on run directories in both artifact
  schemas: ``plot_fig8``'s stats equal isdf_tpu's exactly; each figure
  has matplotlib's canvas size and axes boxes (within 1 px) and lies
  within tests/test_torch_plot.py's image bound of isdf_tpu's PNG, with
  and without dataset thumbnails.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.eval import baselines as JB
from isdf_tpu.eval import figs as JF
from isdf_tpu.train import batch as JBATCH
from isdf_tpu_torch.data.sdf_util import _rdbu_lut
from isdf_tpu_torch.eval import baselines as B
from isdf_tpu_torch.eval import figs as F
from isdf_tpu_torch.train import batch as BATCH
from isdf_tpu_torch.utils import image_io as IO
from tests.test_torch_plot import (Captured, assert_same_boxes,
                                   assert_within_bound, read_rgb,
                                   write_runs)

BASE = {"dataset": {"format": "replicaCAD", "fps": 30},
        "model": {"hidden_feature_size": 256}, "seed": 5}
SEQS = ["/data/seqs/apt_2_nav/", "/data/seqs/scene0010_00"]


def test_config_generators_equal_isdf_tpus():
    over = {"model.hidden_feature_size": 64, "loss.eik_weight": 0.1,
            "new.section.key": [1, 2]}
    assert BATCH.set_params(BASE, over) == JBATCH.set_params(BASE, over)
    assert BASE["model"]["hidden_feature_size"] == 256   # a copy
    gts = ["/gt/a", "/gt/b"]
    jobs = BATCH.nruns_per_seq(BASE, SEQS, 3, gt_sdf_dirs=gts)
    assert jobs == JBATCH.nruns_per_seq(BASE, SEQS, 3, gt_sdf_dirs=gts)
    assert [n for _, n in jobs] == ["apt_2_nav_0", "apt_2_nav_1",
                                    "apt_2_nav_2", "scene0010_00_0",
                                    "scene0010_00_1", "scene0010_00_2"]
    assert [c["seed"] for c, _ in jobs] == [0, 1, 2, 0, 1, 2]
    sweep = BATCH.vary_param(BASE, "loss.eik_weight", [0.1, 0.3], SEQS, 2)
    assert sweep == JBATCH.vary_param(BASE, "loss.eik_weight", [0.1, 0.3],
                                      SEQS, 2)
    assert sweep[0][1] == "eik_weight_0.1_apt_2_nav_0"
    assert BATCH.REPLICACAD_SEQS == JBATCH.REPLICACAD_SEQS
    assert BATCH.SCANNET_SEQS == JBATCH.SCANNET_SEQS


def test_run_jobs_retries_and_records_failures(tmp_path, monkeypatch,
                                               capsys):
    attempts = {}

    def flaky(cfg, out_dir, max_steps=None, device=None):
        name = os.path.basename(out_dir)
        attempts[name] = attempts.get(name, 0) + 1
        if cfg.get("fail") == "always" or (cfg.get("fail") == "once"
                                           and attempts[name] == 1):
            raise RuntimeError("transient")
        return (name, max_steps, device)

    monkeypatch.setattr(BATCH, "run", flaky)
    jobs = [({"fail": "once"}, "a_0"), ({"fail": "always"}, "b_0"),
            ({}, "c_0")]
    out = BATCH.run_jobs(jobs, str(tmp_path), max_steps=7, retries=1,
                         device="cpu")
    assert out == {"a_0": ("a_0", 7, "cpu"), "b_0": None,
                   "c_0": ("c_0", 7, "cpu")}
    assert attempts == {"a_0": 2, "b_0": 2, "c_0": 1}
    log = capsys.readouterr().out
    assert "=== batch job a_0 (retry 1) ===" in log
    assert "job b_0 failed: RuntimeError('transient')" in log
    # no retries: one attempt each
    attempts.clear()
    out = BATCH.run_jobs(jobs[:2], str(tmp_path), retries=0)
    assert out == {"a_0": None, "b_0": None}
    assert attempts == {"a_0": 1, "b_0": 1}


def _tiny_raw_cfg(**eval_kw):
    return {
        "tpu": {"kf_buffer_size": 8, "mm_precision": "highest"},
        "sample": {"n_rays": 8, "n_strat_samples": 9, "n_surf_samples": 4},
        "model": {"hidden_feature_size": 32, "hidden_layers_block": 1,
                  "iters_per_frame": 10, "iters_per_kf": 20,
                  "embedding": {"n_embed_funcs": 4}},
        "eval": {"do_eval": 0, **eval_kw},
        "dataset": {"format": "synthetic", "seq_dir": "/synthetic/room_a",
                    "fps": 30,
                    "camera": {"w": 32, "h": 24, "fx": 20.0, "fy": 20.0,
                               "cx": 15.5, "cy": 11.5}},
    }


def test_run_removes_stale_results(tmp_path):
    out = tmp_path / "room_a_0"
    out.mkdir()
    for f in ("res.json", "vox_res.json"):
        (out / f).write_text('{"stale": 1}')
    cfg = _tiny_raw_cfg()
    res = BATCH.run(cfg, str(out), max_steps=12, grid_dim=8, device="cpu")
    assert res.steps == 12
    # eval is off, so nothing replaces the stale files: both are gone
    assert sorted(os.listdir(out)) == ["config.json"]
    with open(out / "config.json") as f:
        assert json.load(f) == cfg
    # a failing job inside run_jobs: an unknown format raises, recorded
    bad = BATCH.set_params(cfg, {"dataset.format": "nope"})
    got = BATCH.run_jobs([(bad, "bad_0"), (cfg, "room_a_1")],
                         str(tmp_path), max_steps=6, retries=1,
                         device="cpu")
    assert got["bad_0"] is None and got["room_a_1"].steps == 6


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def _rays_entry(rng, regions):
    return {r: {"av_l1": float(rng.random()),
                "l1_chomp_costs": rng.random(3).tolist(),
                "av_cossim": rng.random(3).tolist(),
                **({"prop_vox": float(rng.random())} if r == "vox" else {})}
            for r in regions}


@pytest.fixture(scope="module")
def baseline_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines")
    rng = np.random.default_rng(0)
    seq = "apt_2_nav"
    # KinectFusion+: vox_res.json, a text grid and its header transform
    g = root / "gpuf" / seq
    g.mkdir(parents=True)
    with open(g / "vox_res.json", "w") as f:
        json.dump({f"{t:.3f}": {"time": t, "rays": _rays_entry(
            rng, ("vis", "vox"))} for t in (0.5, 1.0, 2.0)}, f)
    dims = (7, 6, 5)
    np.savetxt(g / "final_sdf.txt", rng.normal(size=int(np.prod(dims))))
    np.savetxt(g / "1.000.txt", rng.normal(size=int(np.prod(dims))))
    with open(g / "transform.txt", "w") as f:
        f.write("dims 7 6 5\nvsm 0.1 0.1 0.1\noffset -0.3 -0.2 -0.25\n")
    # Voxblox: res.json (nn / vox / fill regions), scattered samples
    v = root / "vox" / seq
    (v / "out").mkdir(parents=True)
    ev = {f"{t:.1f}": {"time": t, "rays": _rays_entry(
        rng, ("nn", "vox", "fill"))} for t in (0.5, 1.0)}
    with open(v / "res.json", "w") as f:
        json.dump({"sdf_eval": {**ev, "bins_lb": [0], "bins_ub": [1]}}, f)
    with open(v / "params.json", "w") as f:
        json.dump({"voxel_size": 0.1}, f)
    # samples at the voxel centres of a 12^3 block, the rest unmapped
    ax = np.arange(12) * 0.1 - 0.55
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    for key in ev:
        np.savetxt(v / "out" / f"{key}.npy", np.concatenate(
            [pts, rng.normal(size=(len(pts), 1))], 1))
    return root, seq


def test_baseline_readers_equal_isdf_tpus(baseline_files):
    root, seq = baseline_files
    for kw in ({}, {"chomp_ix": 2, "cossim_ix": 1}):
        for name in ("load_gpu_fusion_res", "load_voxblox_res"):
            sub = "gpuf" if "gpu" in name else "vox"
            mine = getattr(B, name)(str(root / sub), seq, **kw)
            theirs = getattr(JB, name)(str(root / sub), seq, **kw)
            assert set(mine) == set(theirs)
            for k in mine:
                np.testing.assert_array_equal(mine[k], theirs[k])
    # inside the KinectFusion+ grid: 7 x 6 x 5 voxels of 0.1 from the offset
    pts = np.random.default_rng(1).uniform([-0.3, -0.2, -0.25],
                                           [0.3, 0.3, 0.15], (500, 3))
    for t in (None, 1.0):
        a = B.gpuf_sdf_interp(str(root / "gpuf" / seq), eval_t=t)
        b = JB.gpuf_sdf_interp(str(root / "gpuf" / seq), eval_t=t)
        np.testing.assert_array_equal(a(pts), b(pts))
    pts = np.random.default_rng(2).uniform(-0.9, 0.9, (500, 3))
    for t in (None, 0.5):
        a = B.voxblox_sdf_interp(str(root / "vox" / seq), [-0.5] * 3,
                                 [0.5] * 3, eval_t=t)
        b = JB.voxblox_sdf_interp(str(root / "vox" / seq), [-0.5] * 3,
                                  [0.5] * 3, eval_t=t)
        va, vb = a(pts), b(pts)
        np.testing.assert_array_equal(va, vb)
        assert np.isfinite(va).any() and np.isnan(va).any()


# ---------------------------------------------------------------------------
# figures, on runs of both packages' loops
# ---------------------------------------------------------------------------

CAM = (32, 24, 20.0, 20.0, 15.5, 11.5)


def _cfg(cls):
    cam = cls().camera.__class__(*CAM)
    return cls().replace(
        dataset_format="synthetic", n_rays=8, n_strat_samples=9,
        n_surf_samples=4, hidden_feature_size=32, hidden_layers_block=1,
        n_embed_funcs=4, kf_buffer_size=8, iters_per_frame=10,
        iters_per_kf=20, bounds_method="pc", do_eval=True, eval_freq_s=0.1,
        steps_per_bundle=10, mm_precision="highest", camera=cam)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """``room_0`` written by isdf_tpu's loop, ``room_1`` by the port's
    (res.json with the protocol's entries); then the isdf_tpu trainer gets
    the port trainer's weights."""
    from isdf_tpu.data.synthetic import SyntheticDataset as JDS
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.loop import train_loop as j_loop
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.utils.config import Config as JConfig
    from isdf_tpu_torch.data.synthetic import (SyntheticDataset,
                                               SyntheticScene)
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import sdf_mlp as TM
    from isdf_tpu_torch.utils.config import Config

    root = tmp_path_factory.mktemp("runs")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        jt = JTrainer(_cfg(JConfig), dataset=JDS(JScene(), n_frames=40,
                                                 H=24, W=32),
                      seed=1, grid_dim=64)
        tt = Trainer(_cfg(Config), dataset=SyntheticDataset(
            SyntheticScene(), n_frames=40, H=24, W=32), seed=1,
            device="cpu", grid_dim=64)
        # isdf_tpu's pinned clock caps at the measured time unless told
        # not to; the port's always bills the pin exactly
        jt._bill_exact = True
        for i, (tr, loop) in enumerate(((jt, j_loop), (tt, train_loop))):
            tr._per_step_device_s = 0.01
            os.makedirs(root / f"room_{i}")
            loop(tr, max_steps=40, save_path=str(root / f"room_{i}"))
        jt.params = jax.tree_util.tree_map(
            jnp.asarray, TM.params_to_jax(tt.params, tt.model))
        yield root, jt, tt
    finally:
        torch.set_num_threads(threads)


def test_figs_aggregation_equals_isdf_tpus(loop_runs):
    root, _, _ = loop_runs
    metric = ("rays", "av_l1")
    mine = F.runs_by_sequence(str(root), "res.json")
    theirs = JF.runs_by_sequence(str(root), "res.json")
    assert mine == theirs and list(mine) == ["room"]
    runs = mine["room"]
    assert len(runs) == 2
    for r in runs:
        t, v = F.curve(r, metric)
        tj, vj = JF.curve(r, metric)
        np.testing.assert_array_equal(t, tj)
        np.testing.assert_array_equal(v, vj)
        assert len(t) >= 3 and np.isfinite(v).all()
    for a, b in zip(F.mean_std_curve(runs, metric, n_grid=20),
                    JF.mean_std_curve(runs, metric, n_grid=20)):
        np.testing.assert_array_equal(a, b)
    assert F.final_values(runs, metric) == JF.final_values(runs, metric)
    assert F.load_run(str(root / "room_1"), "nope.json") is None


def test_aggregate_exp0_equals_isdf_tpus(tmp_path):
    rng = np.random.default_rng(3)
    for i, last in enumerate((2.0, 2.0, 1.0)):   # run 2 did not finish
        d = tmp_path / f"apt_2_nav_{i}"
        d.mkdir()
        times = [t for t in (0.5, 1.0, 2.0) if t <= last]
        with open(d / "vox_res.json", "w") as f:
            json.dump({f"{t:.3f}": {"time": t, "rays": _rays_entry(
                rng, ("vis", "vox"))} for t in times}, f)
    for metric in ("sdf", "chomp", "grad"):
        for split in ("vis", "vox"):
            a = F.aggregate_exp0(str(tmp_path), "apt_2_nav", metric, split)
            b = JF.aggregate_exp0(str(tmp_path), "apt_2_nav", metric, split)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert a[3] == 2
    with pytest.raises(FileNotFoundError):
        F.aggregate_exp0(str(tmp_path), "scene0010_00")
    # the three plots draw these runs (held to isdf_tpu's figures below)
    out = str(tmp_path / "x.png")
    stats = F.plot_fig8(str(tmp_path), out)
    assert list(stats) == ["apt_2_nav"] and stats["apt_2_nav"]["sdf"][3] == 2
    assert F.plot_all_seq(str(tmp_path), out) == out
    assert F.plot_per_seq(str(tmp_path / "apt_2_nav_0"), out) == out
    assert IO.imread(out).shape == (1080, 1920, 3)


def test_slice_comparison_equals_isdf_tpus(loop_runs, tmp_path):
    _, jt, tt = loop_runs
    # a slice-PNG directory of the port's as a third method
    from isdf_tpu_torch.vis.slices import write_slices
    write_slices(tt, str(tmp_path / "dir"), n_slices=3)
    gt = tt.dataset.scene.sdf_np
    F.slice_comparison([tt, gt, str(tmp_path / "dir")],
                       str(tmp_path / "mine.png"))
    JF.slice_comparison([jt, gt, str(tmp_path / "dir")],
                        str(tmp_path / "theirs.png"))
    mine = cv2.imread(str(tmp_path / "mine.png"))
    theirs = cv2.imread(str(tmp_path / "theirs.png"))
    assert mine.shape == (3 * 64, 3 * 64, 3)
    bins = {tuple(c[::-1]): i for i, c in enumerate(
        (_rdbu_lut()[:, :3] * 255).astype(np.uint8))}
    diff = (mine != theirs).any(-1)
    assert diff.mean() <= 1e-3
    for a, b in zip(mine[diff], theirs[diff]):
        assert abs(bins[tuple(a)] - bins[tuple(b)]) <= 1
    # the GT row equals the colormap of the analytic SDF on the planes
    np.testing.assert_array_equal(mine[64:128], theirs[64:128])


def test_slice_comparison_with_baselines(loop_runs, tmp_path,
                                         baseline_files):
    root, seq = baseline_files
    _, _, tt = loop_runs
    out = F.slice_comparison_with_baselines(
        tt, str(tmp_path / "cmp.png"), seq, voxblox_root=str(root / "vox"),
        gpuf_root=str(root / "gpuf"))
    img = cv2.imread(out)
    assert img.shape == (3 * 64, 3 * 64, 3)   # port, Voxblox, KinectFusion+
    F.slice_comparison_with_baselines(
        tt, str(tmp_path / "solo.png"), seq,
        voxblox_root=str(tmp_path / "absent"))
    assert cv2.imread(str(tmp_path / "solo.png")).shape == (64, 3 * 64, 3)


# ---------------------------------------------------------------------------
# the plots, against isdf_tpu's matplotlib figures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exp0_runs(tmp_path_factory):
    """Three of the paper's sequences in the exp0 layout and a single run
    in the vox_res.json schema (tests/test_torch_plot.py::write_runs)."""
    root = tmp_path_factory.mktemp("exp0")
    write_runs(root)
    return root


@pytest.mark.parametrize("split", ["vis", "vox"])
def test_plot_fig8_equals_isdf_tpus(exp0_runs, tmp_path, monkeypatch,
                                    split):
    cap = Captured(monkeypatch)
    rows = [["apt_2_nav", "apt_3_obj"], ["scene0010_00", "scene0031_00"]]
    want = JF.plot_fig8(str(exp0_runs), str(tmp_path / "j.png"), split,
                        seq_rows=rows)
    got = F.plot_fig8(str(exp0_runs), str(tmp_path / "t.png"), split,
                      seq_rows=rows)
    assert list(got) == list(want) == ["apt_2_nav", "apt_3_obj",
                                       "scene0010_00"]
    for seq in want:
        assert list(got[seq]) == list(want[seq]) == ["sdf", "chomp", "grad"]
        for m in want[seq]:
            for a, b in zip(got[seq][m], want[seq][m]):
                np.testing.assert_array_equal(a, b)
    assert got["apt_3_obj"]["sdf"][3] == 2       # the unfinished repeat
    assert_same_boxes(cap.mpl[0], cap.kit[0])
    assert_within_bound(read_rgb(tmp_path / "j.png"),
                        read_rgb(tmp_path / "t.png"), "fig8")


def test_plot_all_seq_equals_isdf_tpus(exp0_runs, baseline_files, tmp_path,
                                       monkeypatch):
    cap = Captured(monkeypatch)
    broot, seq = baseline_files
    # the baselines' sequence beside the exp0 runs, as another method
    kw = dict(baselines={"repeat": str(exp0_runs)},
              voxblox_root=str(broot / "vox"), gpuf_root=str(broot / "gpuf"))
    assert JF.plot_all_seq(str(exp0_runs), str(tmp_path / "j.png"),
                           **kw) == str(tmp_path / "j.png")
    assert F.plot_all_seq(str(exp0_runs), str(tmp_path / "t.png"),
                          **kw) == str(tmp_path / "t.png")
    assert_same_boxes(cap.mpl[0], cap.kit[0])
    assert_within_bound(read_rgb(tmp_path / "j.png"),
                        read_rgb(tmp_path / "t.png"), "all_seq")
    metric = ("rays", "vox", "av_l1")
    JF.plot_all_seq(str(exp0_runs), str(tmp_path / "j2.png"), metric=metric)
    F.plot_all_seq(str(exp0_runs), str(tmp_path / "t2.png"), metric=metric)
    assert_within_bound(read_rgb(tmp_path / "j2.png"),
                        read_rgb(tmp_path / "t2.png"), "all_seq vox")
    with pytest.raises(ValueError, match="no runs"):
        F.plot_all_seq(str(tmp_path), str(tmp_path / "x.png"))


class _Frames:
    """A dataset of depth frames: dataset[i]["depth"], the last frames
    missing (isdf_tpu's thumbnails skip a frame that raises)."""

    def __init__(self, n):
        yy, xx = np.mgrid[0:48, 0:64]
        self.n, self.yy, self.xx = n, yy, xx

    def __getitem__(self, i):
        if i >= self.n:
            raise IndexError(i)
        return {"depth": 1.0 + 0.5 * np.sin(self.xx / 7.0 + i)
                + 0.3 * self.yy / 48}


@pytest.mark.parametrize("schema,thumbs", [("vox_res", False),
                                           ("online", False),
                                           ("online", True)])
def test_plot_per_seq_equals_isdf_tpus(exp0_runs, loop_runs, tmp_path,
                                       monkeypatch, schema, thumbs):
    cap = Captured(monkeypatch)
    if schema == "vox_res":
        run = str(exp0_runs / "single")
    else:                   # the port loop's res.json (sdf_eval, kf_indices)
        run = str(loop_runs[0] / "room_1")
    ds = _Frames(30) if thumbs else None
    JF.plot_per_seq(run, str(tmp_path / "j.png"), dataset=ds)
    assert F.plot_per_seq(run, str(tmp_path / "t.png"),
                          dataset=ds) == str(tmp_path / "t.png")
    assert_same_boxes(cap.mpl[0], cap.kit[0])
    assert_within_bound(read_rgb(tmp_path / "j.png"),
                        read_rgb(tmp_path / "t.png"), f"per_seq {schema}")
    with pytest.raises(ValueError, match="no results"):
        F.plot_per_seq(str(tmp_path), str(tmp_path / "x.png"))
