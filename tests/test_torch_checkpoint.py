"""The port's checkpoints against isdf_tpu's on the CPU (both write and read
one .npz format, utils/checkpoint.py).

* An archive written by isdf_tpu loads in the port: parameters, frozen
  parameters, optimiser moments and the arena bit-equal, and the same
  sdf_fn (float32 round-off of two MLPs: rtol 1e-6, atol 1e-6).
* An archive written by the port loads in isdf_tpu's load_checkpoint and
  its SDFQueryEngine.from_checkpoint with equal SDF values (rtol 1e-5,
  atol 1e-6).
* The reference state-dict loader and saver give isdf_tpu's arrays
  exactly.
* A run resumed from the port's archive continues as the run that wrote
  it (the same parameters after the same steps, exactly), and the CLI's
  --load_checkpoint resumes from one the loop wrote.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from isdf_tpu.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu.utils import checkpoint as JCK
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils import checkpoint as TCK
from isdf_tpu_torch.utils.config import Config as TConfig

from test_torch_slice import _small

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


def _ds():
    return SyntheticDataset(SyntheticScene(extents=(5.0, 3.0, 4.0)),
                            n_frames=20, H=24, W=32)


def _fill(tr):
    for fid in (0, 5, 10):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([fid])[0])


_PAIR = {}


def _trained():
    """An isdf_tpu Trainer and a port Trainer on one dataset and config,
    each with three keyframes and 30 steps of its own training (built once
    per test process)."""
    if not _PAIR:
        from isdf_tpu.engine.trainer import Trainer as JTrainer
        from isdf_tpu_torch.engine.trainer import Trainer as TTrainer
        ds = _ds()
        jt = JTrainer(_small(JConfig), dataset=ds, seed=3, grid_dim=8)
        tt = TTrainer(_small(TConfig), dataset=ds, seed=3, device="cpu",
                      grid_dim=8)
        for tr in (jt, tt):
            _fill(tr)
            tr.run_steps(30)
        _PAIR.update(jt=jt, tt=tt, ds=ds)
    return _PAIR["jt"], _PAIR["tt"], _PAIR["ds"]


def _pts(n=300, seed=0):
    return np.random.default_rng(seed).uniform(
        -2.0, 2.0, (n, 3)).astype(np.float32)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _fresh_port(ds, seed=99):
    from isdf_tpu_torch.engine.trainer import Trainer
    return Trainer(_small(TConfig), dataset=ds, seed=seed, device="cpu",
                   grid_dim=8)


def test_tree_order_is_jax_flatten_order():
    tree = {"out": {"w": 1, "b": 2}, "in": {"w": 3, "b": 4},
            "mid1": [{"w": 5, "b": 6}, {"w": 7, "b": 8}], "B": 9,
            "cat": (10, 11)}
    assert TCK.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    back = TCK.tree_unflatten(tree, TCK.tree_leaves(tree))
    assert back == tree


def test_jax_archive_loads_in_port(tmp_path):
    jt, _, ds = _trained()
    path = str(tmp_path / "jax.ckpt")
    JCK.save_checkpoint(path, jt, step=30)
    tt = _fresh_port(ds)
    meta = tt.load_checkpoint(path)
    assert meta["step"] == 30 and "opt_state_reinitialised" not in meta
    m = tt.model
    for got, want in ((tt.params, jt.params),
                      (tt.frozen_params, jt.frozen_params),
                      (tt.opt_state["mu"], jt.opt_state[0].mu),
                      (tt.opt_state["nu"], jt.opt_state[0].nu)):
        for a, b in zip(TCK.tree_leaves(TM.params_to_jax(got, m)),
                        _leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert tt.opt_state["count"] == int(jt.opt_state[0].count) == 30
    buf = tt.buffer
    jb = jt.buffer
    assert buf.count == int(jb.count) == 3
    for name in ("depth", "T_WC", "normals", "frame_avg_loss", "loss_approx",
                 "frame_id"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    assert tt.tot_step_time == jt.tot_step_time
    assert tt.steps_taken == jt.steps_taken == 30
    assert [f.frame_id for f in tt.frames.frames] == [0, 5, 10]
    pts = _pts()
    np.testing.assert_allclose(tt.sdf_fn(pts), jt.sdf_fn(pts), rtol=1e-6,
                               atol=1e-6)
    # the restored port trainer trains on
    tt.run_steps(2)


def test_port_archive_loads_in_jax(tmp_path):
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.serve import SDFQueryEngine as JEngine
    jt, tt, ds = _trained()
    path = str(tmp_path / "port.ckpt")
    tt.save_checkpoint(path, step=30)
    assert os.path.exists(path)
    jt2 = JTrainer(_small(JConfig), dataset=ds, seed=77, grid_dim=8)
    meta = JCK.load_checkpoint(path, jt2)
    assert meta["step"] == 30 and "opt_state_reinitialised" not in meta
    assert int(jt2.buffer.count) == tt.buffer.count
    assert jt2.steps_taken == tt.steps_taken
    pts = _pts(seed=1)
    want = tt.sdf_fn(pts)
    np.testing.assert_allclose(jt2.sdf_fn(pts), want, rtol=1e-5, atol=1e-6)
    eng = JEngine.from_checkpoint(path)
    np.testing.assert_allclose(eng.sdf(pts), want, rtol=1e-5, atol=1e-6)
    # isdf_tpu restores the moments the port wrote
    for a, b in zip(TCK.tree_leaves(TM.params_to_jax(tt.opt_state["nu"],
                                                     tt.model)),
                    _leaves(jt2.opt_state[0].nu)):
        np.testing.assert_array_equal(a, b)
    # and trains on from them
    jt2.run_steps(2)


@pytest.mark.parametrize("layout", ["packed", "odd"])
def test_other_opt_layout_reinitialises(tmp_path, layout):
    """Moments in another layout (isdf_tpu's fused op on a TPU keeps them
    on packed planes: count + (Wp [L, 2K, H], bpt [8, L*H]) twice) restore
    the weights exactly and re-initialise the moments, as isdf_tpu does;
    the trainer trains on."""
    _, tt, ds = _trained()
    path = str(tmp_path / "port.ckpt")
    tt.save_checkpoint(path, step=30)
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files if not k.startswith("opt/")}
    L, K2, H = tt.params["Wp"].shape
    if layout == "packed":
        opt = [np.zeros((L, K2, H), np.float32),
               np.zeros((8, L * H), np.float32)] * 2
    else:
        opt = [np.zeros(5, np.float32)]
    arrs["opt/0"] = np.asarray(7, np.int32)
    arrs.update({f"opt/{i + 1}": a for i, a in enumerate(opt)})
    p2 = str(tmp_path / "other.ckpt")
    with open(p2, "wb") as f:
        np.savez_compressed(f, **arrs)
    tr = _fresh_port(ds)
    meta = tr.load_checkpoint(p2)
    assert meta["opt_state_reinitialised"] is True
    assert tr.opt_state["count"] == 0
    pts = _pts(seed=2)
    np.testing.assert_array_equal(tr.sdf_fn(pts), tt.sdf_fn(pts))
    tr.run_steps(2)


def _state_dict(model_cfg, rng):
    E, H = model_cfg["E"], model_cfg["H"]
    shapes = {"in_layer.0": (H, E), "cat_layer.0": (H, H + E),
              "out_alpha": (1, H)}
    for k in range(model_cfg["B"]):
        shapes[f"mid1.{k}.0"] = (H, H)
        shapes[f"mid2.{k}.0"] = (H, H)
    sd = {}
    for name, (o, i) in shapes.items():
        sd[name + ".weight"] = torch.from_numpy(
            rng.normal(size=(o, i)).astype(np.float32))
        sd[name + ".bias"] = torch.from_numpy(
            rng.normal(size=o).astype(np.float32))
    return sd


def test_reference_state_dict_matches_jax(tmp_path):
    jt, tt, _ = _trained()
    m = tt.model
    sd = _state_dict(dict(E=m.embedding_size, H=m.hidden_size,
                          B=m.hidden_layers_block),
                     np.random.default_rng(5))
    want = JCK.load_reference_state_dict(sd, jt.params)
    got = TCK.load_reference_state_dict(sd, tt.params, m)
    for a, b in zip(TCK.tree_leaves(TM.params_to_jax(got, m)),
                    _leaves(want)):
        np.testing.assert_array_equal(a, b)

    ck_j = JCK.save_reference_checkpoint(None, want, step=4, loss=0.5)
    ck_t = TCK.save_reference_checkpoint(None, got, m, step=4, loss=0.5)
    assert sorted(ck_t) == sorted(ck_j)
    assert (ck_t["step"], ck_t["loss"]) == (ck_j["step"], ck_j["loss"])
    assert sorted(ck_t["model_state_dict"]) == sorted(ck_j["model_state_dict"])
    for k, v in ck_j["model_state_dict"].items():
        np.testing.assert_array_equal(ck_t["model_state_dict"][k].numpy(),
                                      v.numpy())
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())

    # through a file, into a trainer (weights only, frozen copy too)
    path = str(tmp_path / "ref.pth")
    TCK.save_reference_checkpoint(path, got, m, step=4)
    tr = _fresh_port(_PAIR["ds"])
    assert tr.load_checkpoint(path) is None
    for k in ("Wp", "bp"):
        np.testing.assert_array_equal(tr.params[k].numpy(),
                                      got[k].numpy())
        np.testing.assert_array_equal(tr.frozen_params[k].numpy(),
                                      got[k].numpy())


def test_resumed_run_continues(tmp_path):
    """Save after 20 steps and run 15 more; a fresh trainer loaded from the
    archive and run 15 steps ends with the same parameters, arena
    priorities and clock: the step draws are indexed by the restored
    global step."""
    from isdf_tpu_torch.engine.trainer import Trainer
    ds = _ds()
    tr = Trainer(_small(TConfig), dataset=ds, seed=4, device="cpu",
                 grid_dim=8)
    _fill(tr)
    tr.run_steps(20)
    path = str(tmp_path / "mid.ckpt")
    tr.save_checkpoint(path, step=20)
    tr.run_steps(15)
    tr2 = _fresh_port(ds, seed=123)
    tr2.load_checkpoint(path)
    assert tr2.steps_taken == 20
    tr2.run_steps(15)
    for k in ("Wp", "bp"):
        np.testing.assert_array_equal(tr2.params[k].numpy(),
                                      tr.params[k].numpy())
        np.testing.assert_array_equal(tr2.opt_state["nu"][k].numpy(),
                                      tr.opt_state["nu"][k].numpy())
    np.testing.assert_array_equal(tr2.buffer.frame_avg_loss.numpy(),
                                  tr.buffer.frame_avg_loss.numpy())
    assert tr2.steps_taken == tr.steps_taken == 35


def _cli_args(*extra):
    cfg = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                       "synthetic.json")
    return ["--config", cfg, "--device", "cpu", "--sim_dt", "0.02",
            "--grid_dim", "8",
            "--set", "dataset.camera.w=32", "--set", "dataset.camera.h=24",
            "--set", "dataset.camera.fx=20", "--set", "dataset.camera.fy=20",
            "--set", "dataset.camera.cx=15.5", "--set",
            "dataset.camera.cy=11.5", "--set", "sample.n_rays=8",
            "--set", "model.hidden_feature_size=32",
            "--set", "tpu.kf_buffer_size=8", "--set", "eval.do_eval=0",
            *extra]


def test_cli_load_checkpoint(tmp_path):
    """The loop writes a checkpoint at every save mark; --load_checkpoint
    resumes from the last one (its clock, steps and arena), and the
    resumed run writes later marks."""
    from isdf_tpu_torch.train.train import main
    out = tmp_path / "a"
    res = main(_cli_args("--max_steps", "40", "--save_path", str(out),
                         "--set", "save.save_checkpoints=1",
                         "--set", "save.save_period=0.25"))
    cks = sorted(os.listdir(out / "checkpoints"))
    assert len(cks) == 3, cks   # marks 0.25, 0.5, 0.75 in 0.8 s
    last = str(out / "checkpoints" / cks[-1])
    with np.load(last) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
    assert 0.75 < meta["tot_step_time"] <= res.tot_step_time
    out2 = tmp_path / "b"
    res2 = main(_cli_args("--max_steps", "20", "--save_path", str(out2),
                          "--load_checkpoint", last,
                          "--set", "save.save_checkpoints=1",
                          "--set", "save.save_period=0.25"))
    assert res2.steps == 20
    assert res2.tot_step_time > meta["tot_step_time"] + 0.39
    # the resumed run writes marks past the restored clock
    marks = [float(c[len("step_"):-len(".ckpt")])
             for c in os.listdir(out2 / "checkpoints")]
    assert meta["tot_step_time"] < max(marks) < res2.tot_step_time
