"""The port's fixed-point (voxblox-comparable), object and trajectory evals
against isdf_tpu's on the CPU.

* _torch_sample_rays: the port draws from a CPU torch.Generator where
  isdf_tpu seeds torch's global one with the float t * 1e3; the points
  are bit-equal, and the global generator is left alone.
* fixed_pts_eval with a masks directory this test writes, and without one:
  the same weights and frames give the same scores (two MLPs' float32
  round-off: rtol 1e-5, atol 1e-7).
* eval_object_sdf and eval_traj_cost: the same (rtol 1e-5).
* The loop's fixed-point eval writes vox_res.json at the pre-baked
  timestamps.
"""

import json
import os

import numpy as np
import pytest
import torch

from isdf_tpu.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu.eval import eval_pts as JE
from isdf_tpu.eval import objects as JO
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.eval import eval_pts as TE
from isdf_tpu_torch.eval import objects as TO
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils.config import Config as TConfig

from test_torch_slice import _small

MASKS = ["surf_valid_gt_sdf", "surf_valid_vox_sdf", "vis_valid_gt_sdf",
         "vis_valid_vox_sdf", "vis_valid_gt_grad", "vis_valid_vox_grad"]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _frames(n=6, H=24, W=32, seed=0):
    ds = SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                          n_frames=n, H=H, W=W)
    depth = np.stack([ds[i]["depth"] for i in range(n)])
    T = np.stack([ds[i]["T"] for i in range(n)])
    depth[0, :3] = 0.0   # invalid pixels are dropped
    return ds, depth, T, np.asarray(ds._dirs_C)


@pytest.mark.parametrize("t,surface,behind", [
    (0.7, False, 0.1), (1.234, True, 0.0), (0.1, False, 0.0),
    (2.0, False, 0.1)])
def test_sample_rays_bit_equal(t, surface, behind):
    _, depth, T, dirs = _frames()
    t_str = f"{t:.3f}"
    state = torch.random.get_rng_state()
    got = TE._torch_sample_rays(t_str, depth, T, dirs, behind, surface,
                                samples=3000)
    # the port leaves torch's global generator alone
    assert torch.equal(torch.random.get_rng_state(), state)
    want = JE._torch_sample_rays(t_str, depth, T, dirs, behind, surface,
                                 samples=3000)
    assert got.dtype == np.float32 and got.shape[0] > 2000
    np.testing.assert_array_equal(got, want)


_PAIR = {}


def _paired():
    """An isdf_tpu and a port Trainer with the same weights (the port's,
    after 40 steps), frames and clock."""
    if not _PAIR:
        from isdf_tpu.engine.trainer import Trainer as JTrainer
        from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
        ds = SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                              n_frames=40, H=24, W=32)
        jt = JTrainer(_small(JConfig), dataset=ds, seed=1, grid_dim=8)
        tt = TTrainer(_small(TConfig), dataset=ds, seed=1, device="cpu",
                      grid_dim=8)
        for tr in (jt, tt):
            for fid in (0, 6, 12):
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
        tt.run_steps(40)
        jt.params = TM.params_to_jax(tt.params, tt.model)
        jt.tot_step_time = tt.tot_step_time = 0.5
        _PAIR.update(jt=jt, tt=tt, ds=ds)
    return _PAIR["jt"], _PAIR["tt"], _PAIR["ds"]


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   equal_nan=True, err_msg=path)


def _write_masks(root, t, depth, T, dirs, samples, rng):
    """A masks directory for timestamp t whose masks fit the points the
    protocol draws there."""
    t_str = f"{t:.3f}"
    d = os.path.join(root, t_str)
    os.makedirs(d)
    n_vis = len(JE._torch_sample_rays(t_str, depth, T, dirs, 0.1, False,
                                      samples))
    n_surf = len(JE._torch_sample_rays(t_str, depth, T, dirs, 0.0, True,
                                       samples))
    gt_vis = rng.random(n_vis) < 0.8
    gt_surf = rng.random(n_surf) < 0.8
    masks = {"vis_valid_gt_sdf": gt_vis,
             "vis_valid_vox_sdf": rng.random(gt_vis.sum()) < 0.6,
             "vis_valid_gt_grad": rng.random(n_vis) < 0.9,
             "vis_valid_vox_grad": rng.random(n_vis) < 0.9,
             "surf_valid_gt_sdf": gt_surf,
             "surf_valid_vox_sdf": rng.random(gt_surf.sum()) < 0.6}
    for k in MASKS:
        np.save(os.path.join(d, k + ".npy"), masks[k])
    return d


@pytest.mark.parametrize("with_masks", [True, False])
def test_fixed_pts_eval_matches_jax(tmp_path, with_masks):
    jt, tt, ds = _paired()
    t = 0.5
    n_seen = int(t * 30)
    depth = np.stack([ds[i]["depth"] for i in range(0, n_seen, 5)])
    T = np.stack([ds[i]["T"] for i in range(0, n_seen, 5)])
    dirs = tt.dirs_C.numpy()
    samples = 4000
    root = None
    if with_masks:
        root = str(tmp_path)
        _write_masks(root, t, depth, T, dirs, samples,
                     np.random.default_rng(1))
    obj = np.array([[[-1.0, -1.0, -1.0], [0.0, 0.0, 0.0]],
                    [[0.2, -0.5, 0.1], [1.2, 0.5, 1.0]]], np.float32)
    kw = dict(grad_fn=None, samples=samples, obj_bounds=obj)
    got = TE.fixed_pts_eval(tt.sdf_fn, t, root, depth, T, dirs,
                            ds.scene.sdf_np, "replicaCAD",
                            **dict(kw, grad_fn=tt.grad_fn))
    want = JE.fixed_pts_eval(jt.sdf_fn, t, root, depth, T, dirs,
                             ds.scene.sdf_np, "replicaCAD",
                             **dict(kw, grad_fn=jt.grad_fn))
    assert set(got) == {"time", "rays", "visible_surf", "vol", "objects"}
    if with_masks:
        assert len(got["rays"]["vox"]["binned_l1"]) == 6
    _assert_close(got, want)
    # the trainer's entry point at its own frames and clock
    _assert_close(tt.eval_fixed(0.4), jt.eval_fixed(0.4))


def test_eval_grad_fd_matches_jax():
    pts = np.random.default_rng(2).uniform(-1, 1, (200, 3)).astype(
        np.float32)

    def f(p):
        return np.sin(p).sum(-1)

    np.testing.assert_array_equal(TE.eval_grad_fd(f, pts, 0.01),
                                  JE.eval_grad_fd(f, pts, 0.01))


def test_object_and_traj_evals_match_jax(tmp_path):
    jt, tt, ds = _paired()
    seq = tmp_path / "seq"
    seq.mkdir()
    # boxes in front of the surface seen at the image centres of frames 0
    # and 5, so that both are visible at the trainers' clock
    boxes = []
    for i in (0, 5):
        s = ds[i]
        d = float(s["depth"][12, 16])
        T = s["T"]
        ray = T[:3, :3] @ tt.dirs_C[12, 16].numpy()
        c = T[:3, 3] + ray * (d - 0.4 / np.linalg.norm(ray))
        boxes.append([c - 0.1, c + 0.1])
    boxes = np.asarray(boxes)
    np.savetxt(seq / "obj_bounds.txt", boxes.reshape(-1, 3))
    # the first 60 poses of a longer orbit as the GT trajectory
    traj = np.stack([SyntheticDataset(ds.scene, n_frames=80, H=4,
                                      W=6).poses[i].reshape(16)
                     for i in range(80)])
    np.savetxt(seq / "traj.txt", traj)
    jt.cfg = jt.cfg.replace(seq_dir=str(seq))
    tt.cfg = tt.cfg.replace(seq_dir=str(seq))
    try:
        ob = TO.load_obj_bounds(str(seq / "obj_bounds.txt"))
        np.testing.assert_array_equal(
            ob, JO.load_obj_bounds(str(seq / "obj_bounds.txt")))
        # the trainers' entry points draw unseeded; the module's, seeded
        assert len(tt.eval_object_sdf(samples=500)) == 2
        got = TO.eval_object_sdf(tt, ob, samples=2000, seed=3)
        want = JO.eval_object_sdf(jt, ob, samples=2000, seed=3)
        assert len(got) == 2 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
        got = tt.eval_traj_cost(t_ahead=3.0)
        want = jt.eval_traj_cost(t_ahead=3.0)
        assert len(got[0]) == len(got[1]) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
    finally:
        jt.cfg = jt.cfg.replace(seq_dir=None)
        tt.cfg = tt.cfg.replace(seq_dir=None)
    assert tt.eval_object_sdf() is None and tt.eval_traj_cost() is None


def test_loop_writes_vox_res(tmp_path):
    """eval.do_vox_comparison with masks under eval_pts_root/vox/0.055/
    <seq>/eval_pts/<t>: one entry per timestamp the clock passes, in
    vox_res.json."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    root = tmp_path / "eval_pts"
    d = root / "vox" / "0.055" / "seqA" / "eval_pts"
    ds = SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                          n_frames=30, H=24, W=32)
    dirs = np.asarray(ds._dirs_C)
    rng = np.random.default_rng(4)
    for t in (0.3, 0.6, 5.0):
        fr = range(0, min(int(t * 30), 30), 5)
        _write_masks(str(d), t, np.stack([ds[i]["depth"] for i in fr]),
                     np.stack([ds[i]["T"] for i in fr]), dirs, 3000, rng)
    cfg = _small(TConfig).replace(do_vox_comparison=True,
                                  eval_pts_root=str(root),
                                  seq_dir=str(tmp_path / "seqA"),
                                  eval_samples=3000)
    tr = Trainer(cfg, dataset=ds, seed=1, device="cpu", grid_dim=8)
    assert tr.eval_times == [0.3, 0.6, 5.0]
    tr._per_step_device_s, tr._bill_exact = 0.01, True
    train_loop(tr, max_steps=80, save_path=str(tmp_path))
    with open(tmp_path / "vox_res.json") as f:
        vox = json.load(f)
    assert sorted(vox) == ["0.3", "0.6"]
    for e in vox.values():
        assert {"rays", "visible_surf", "vol"} <= set(e)
        assert np.isfinite(e["rays"]["vis"]["av_l1"])
        assert np.isfinite(e["rays"]["vox"]["av_l1"])
        assert len(e["rays"]["vis"]["av_cossim"]) == 2
    assert tr.eval_times == [5.0]
