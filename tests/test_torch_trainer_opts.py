"""The port's trainer, loop and CLI options against isdf_tpu's on the CPU.

* An arena smaller than the window (kf_buffer_size 4, window 5): the step
  runs, its write-back drops the slots past the arena as isdf_tpu's
  scatters do (same numbers, rtol 1e-6), and a paired run learns the scene
  as isdf_tpu's does.
* Batch mode (incremental=False): the same views become the same
  keyframes.
* The scene frame: from the dataset's bounds, a user workspace, the
  bootstrap box; grid_pc and its SDF grid; the chunked sdf_fn and
  grad_fn (float32 round-off of two MLPs: 1e-5 absolute).
* The loop with bundle=False and the CLI's -ni, --per_step, --save and
  --trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu.ops import losses as JL
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.engine import buffer as TB
from isdf_tpu_torch.engine.step import StepFunctions
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils.config import Config as TConfig

from test_torch_slice import _small, run_paired_trainers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ds(n=20):
    return SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                            n_frames=n, H=24, W=32)


# ------------------------------------------------------------ small arena

def test_small_arena_runs():
    from isdf_tpu_torch.engine.trainer import Trainer
    cfg = _small(TConfig).replace(kf_buffer_size=4)
    assert cfg.window_size == 5
    tr = Trainer(cfg, dataset=_ds(), device="cpu", grid_dim=4)
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    out = tr.run_steps(5)
    assert np.isfinite(out["total_loss"]).all()
    for i in (3, 6, 9):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([i])[0])
    assert tr.buffer.count == 4
    out = tr.run_steps(5)
    assert np.isfinite(out["total_loss"]).all()


@pytest.mark.parametrize("count", [1, 3, 4])
def test_small_arena_write_back_matches_jax(count):
    """StepFunctions.update with C = 4 < window 5 against isdf_tpu's _core
    write-back (step.py:446-461): sums and counts by .at[].add, the
    priority grids by .at[].set, both dropping row 4."""
    C, Wn, H, W, n_rays, S = 4, 5, 16, 24, 6, 4
    rng = np.random.default_rng(count)
    cfg = TConfig().replace(window_size=Wn, n_rays=n_rays,
                            kf_buffer_size=C, hidden_feature_size=16,
                            hidden_layers_block=1)
    fns = StepFunctions(cfg, TM.SDFModel(hidden_size=16,
                                         hidden_layers_block=1),
                        H, W, torch.zeros(H, W, 3), "cpu")
    buf = TB.make_buffer(C, H, W, with_normals=False)
    buf.count = count
    prio = rng.random(C).astype(np.float32)
    la = rng.random((C, 8, 8)).astype(np.float32)
    buf.frame_avg_loss.copy_(torch.as_tensor(prio))
    buf.loss_approx.copy_(torch.as_tensor(la))
    idxs = torch.arange(Wn)
    slot_valid = idxs < count
    R = Wn * n_rays
    ib = np.repeat(np.arange(Wn), n_rays)
    ih, iw = rng.integers(0, H, R), rng.integers(0, W, R)
    valid = (rng.random(R) > 0.2) & slot_valid.numpy()[ib]
    ploss = rng.random((R, S)).astype(np.float32)
    params = {"Wp": torch.zeros(2, 2), "bp": torch.zeros(2)}
    from isdf_tpu_torch.models.fused_adamw import init_state
    fns.update(params, init_state(params), buf,
               (torch.zeros(2, 2), torch.zeros(2)), torch.as_tensor(ploss),
               idxs, slot_valid, *(torch.as_tensor(a) for a in (ib, ih, iw)),
               torch.as_tensor(valid), 1.0)

    loss_approx, frame_avg = JL.frame_avg_loss(
        jnp.asarray(ploss.sum(-1)), jnp.asarray(valid), jnp.asarray(ib),
        jnp.asarray(ih), jnp.asarray(iw), Wn, H, W, factor=8)
    ji, jv = jnp.arange(Wn), jnp.asarray(slot_valid.numpy())
    sums = jnp.zeros((C,)).at[ji].add(jnp.where(jv, frame_avg, 0.0))
    cnts = jnp.zeros((C,)).at[ji].add(jv.astype(jnp.float32))
    want_prio = jnp.where(cnts > 0, sums / jnp.maximum(cnts, 1.0), prio)
    la_new = jnp.where(jv[:, None, None], loss_approx, jnp.asarray(la)[ji])
    want_la = jnp.asarray(la).at[ji].set(la_new)
    np.testing.assert_allclose(buf.frame_avg_loss.numpy(),
                               np.asarray(want_prio), rtol=1e-6)
    np.testing.assert_allclose(buf.loss_approx.numpy(), np.asarray(want_la),
                               rtol=1e-6, atol=1e-8)


def test_paired_trainers_small_arena():
    run_paired_trainers(dict(kf_buffer_size=4, kf_eviction="lowest"),
                        steps=160)


# ------------------------------------------------------------ batch mode

@pytest.mark.parametrize("views", [
    dict(n_views=4), dict(n_views=3, random_views=True),
    dict(im_indices=(2, 11, 5))], ids=["linspace", "random", "indices"])
def test_batch_mode_frames_match_jax(views):
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
    ds = _ds()
    jt = JTrainer(_small(JConfig).replace(**views), dataset=ds, seed=4,
                  incremental=False, grid_dim=4)
    tt = TTrainer(_small(TConfig).replace(**views), dataset=ds, seed=4,
                  incremental=False, grid_dim=4, device="cpu")
    assert not tt.incremental and tt.last_is_keyframe
    assert list(tt.frames.frame_ids) == list(jt.frames.frame_ids)
    assert tt.buffer.count == int(jt.buffer.count) == len(jt.frames)
    n = tt.buffer.count
    np.testing.assert_array_equal(tt.buffer.T_WC[:n].numpy(),
                                  np.asarray(jt.buffer.T_WC[:n]))
    np.testing.assert_array_equal(tt.buffer.depth[:n].numpy(),
                                  np.asarray(jt.buffer.depth[:n]))


# ------------------------------------------------------------ scene frame

class _NoBounds:
    """A dataset without scene bounds (the workspace and bootstrap
    branches of the scene frame)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def camera(self):
        return self.ds.camera()


@pytest.mark.parametrize("frame", ["dataset", "workspace", "bootstrap"])
def test_scene_frame_and_grid_match_jax(frame):
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
    ds = _ds(6)
    kw = {}
    if frame != "dataset":
        ds = _NoBounds(ds)
    if frame == "workspace":
        kw = dict(workspace_extents=(2.0, 1.5, 3.0), workspace_rotate_z=30.0,
                  workspace_offset=(0.2, -0.1, 0.4),
                  workspace_center=(0.1, 0.0, 0.2))
    jt = JTrainer(_small(JConfig).replace(**kw), dataset=ds, seed=1,
                  grid_dim=6)
    tt = TTrainer(_small(TConfig).replace(**kw), dataset=ds, seed=1,
                  grid_dim=6, device="cpu")
    for k in ("bounds_transform_np", "inv_bounds_transform_np",
              "scene_scale_np", "scene_extents_np"):
        np.testing.assert_allclose(getattr(tt, k), getattr(jt, k),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tt.transform_dev.numpy(),
                               np.asarray(jt.transform_dev), atol=1e-6)
    assert tt.grid_pc.shape == (216, 3)
    np.testing.assert_allclose(tt.grid_pc.numpy(), np.asarray(jt.grid_pc),
                               atol=1e-5)
    if frame == "workspace":
        np.testing.assert_array_equal(tt.scene_center, jt.scene_center)
    tt.params = TM.params_from_jax(jt.params, tt.model)
    np.testing.assert_allclose(tt.get_sdf_grid(), np.asarray(
        jt.get_sdf_grid()), atol=1e-5)


def test_chunked_queries_match_jax():
    """sdf_fn and grad_fn over several chunks (chunk_size cut to 100) and
    an empty query."""
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
    ds = _ds(4)
    jt = JTrainer(_small(JConfig), dataset=ds, seed=2, grid_dim=4)
    tt = TTrainer(_small(TConfig), dataset=ds, seed=2, grid_dim=4,
                  device="cpu")
    tt.params = TM.params_from_jax(jt.params, tt.model)
    tt.chunk_size = 100
    pts = np.random.default_rng(0).uniform(-2, 2, (333, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tt.sdf_fn(pts), jt.sdf_fn(pts), atol=1e-5)
    g = tt.grad_fn(pts)
    assert g.shape == (333, 3)
    np.testing.assert_allclose(g, jt.grad_fn(pts), atol=1e-5)
    assert tt.sdf_fn(np.zeros((0, 3), np.float32)).shape == (0,)
    assert tt.grad_fn(np.zeros((0, 3), np.float32)).shape == (0, 3)


# ------------------------------------------------------------ loop and CLI

def test_loop_per_step_matches_jax_schedule():
    """bundle=False: one step a round. With every frame a keyframe
    (kf_pixel_ratio above 1) and the clock pinned, both packages ingest
    the same frames at the same steps."""
    from isdf_tpu.engine.loop import train_loop as j_loop
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.engine.loop import train_loop as t_loop
    from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
    ds = _ds(30)
    knobs = dict(kf_pixel_ratio=1.1, hidden_feature_size=32, n_rays=8)
    out = {}
    for name, cls, loop, kw in (
            ("jax", JTrainer, j_loop, {}),
            ("torch", TTrainer, t_loop, dict(device="cpu"))):
        cfg = _small(JConfig if name == "jax" else TConfig).replace(**knobs)
        tr = cls(cfg, dataset=ds, seed=1, grid_dim=4, **kw)
        tr._per_step_device_s = 0.001
        if name == "jax":   # isdf_tpu caps its pin otherwise
            tr._bill_exact = True
        res = loop(tr, max_steps=215, bundle=False)
        out[name] = (res.steps, res.rounds, list(tr.frames.frame_ids))
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (215, 215) and len(out["torch"][2]) >= 2


def _cli_args(tmp_path, *extra):
    cfg = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                       "synthetic.json")
    return ["--config", cfg, "--device", "cpu", "--sim_dt", "0.02",
            "--set", "dataset.camera.w=32", "--set", "dataset.camera.h=24",
            "--set", "dataset.camera.fx=20", "--set", "dataset.camera.fy=20",
            "--set", "dataset.camera.cx=15.5", "--set",
            "dataset.camera.cy=11.5", "--set", "sample.n_rays=8",
            "--set", "model.hidden_feature_size=32",
            "--set", "tpu.kf_buffer_size=8", *extra]


def test_cli_batch_mode_per_step_and_trace(tmp_path):
    from isdf_tpu_torch.train.train import main
    trace = tmp_path / "trace"
    res = main(_cli_args(tmp_path, "-ni", "-hd", "--per_step", "--max_steps",
                         "12", "--grid_dim", "8", "--save_path",
                         str(tmp_path / "out"), "--trace", str(trace),
                         "--set", "dataset.n_views=3"))
    assert res.steps == res.rounds == 12
    assert len(res.kf_indices) + 1 == 3
    with open(trace / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "out" / "res.json") as f:
        saved = json.load(f)
    assert all("rays" in e for e in saved["sdf_eval"].values())


def test_cli_save_and_unported_flags(tmp_path, monkeypatch):
    from isdf_tpu_torch.train.train import main
    monkeypatch.chdir(tmp_path)
    res = main(_cli_args(tmp_path, "--save", "--max_steps", "4"))
    assert res.steps == 4
    (run,) = os.listdir(tmp_path / "results" / "isdf_tpu_torch")
    assert os.path.exists(tmp_path / "results" / "isdf_tpu_torch" / run /
                          "res.json")
    # save.save_slices writes six pred PNGs per save mark into slices/
    res = main(_cli_args(tmp_path, "--save_path", str(tmp_path / "sl"),
                         "--max_steps", "10", "--grid_dim", "8", "--set",
                         "save.save_slices=1", "--set",
                         "save.save_period=0.1"))
    assert res.tot_step_time > 0.1
    names = sorted(os.listdir(tmp_path / "sl" / "slices"))
    assert names and len(names) % 6 == 0
    assert names[:6] == [f"0.100_pred_{s}.png" for s in range(6)]
