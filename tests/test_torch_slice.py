"""The port's training slice against isdf_tpu's on the CPU.

* One step on an identical sampled batch: train op + AdamW + the
  replay-priority write-back, against the same composition of isdf_tpu
  functions (its Pallas train op in interpret mode, float32).
* A short paired run of both Trainers on the same synthetic frames, the
  same initial weights and a pinned simulated clock: both losses fall and
  the final SDF errors agree within a factor of 1.5 (the two packages draw
  different random numbers, so the runs agree statistically, not bit for
  bit).
* The package imports neither jax nor isdf_tpu, and its entry points refuse
  to run without a GPU unless asked for the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.models.fused_adamw import make_fused_adamw
from isdf_tpu.models.pallas_mlp import make_pallas_train_op, pack_params_train
from isdf_tpu.ops import losses as JL
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.engine import buffer as TB
from isdf_tpu_torch.engine.step import StepFunctions
from isdf_tpu_torch.models import fused_adamw as TA
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils.config import Config as TConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_batch(Wn=5, n_rays=8, S=7, H=48, W=64, seed=3):
    rng = np.random.default_rng(seed)
    R = Wn * n_rays
    depth = rng.uniform(1.0, 3.0, R).astype(np.float32)
    z = np.sort(rng.uniform(0.07, 3.1, (R, S)).astype(np.float32), 1)
    z[:, 0] = depth
    dirs_C = np.concatenate([rng.uniform(-0.5, 0.5, (R, 2)),
                             np.ones((R, 1))], 1).astype(np.float32)
    dirs_W = dirs_C * np.float32(0.9)
    o = rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    pc = o[:, None] + dirs_W[:, None] * z[..., None]
    normals = rng.normal(size=(R, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return dict(
        pc=pc.astype(np.float32), z=z, depth=depth, dirs_C=dirs_C,
        dirs_W=dirs_W, normals=normals, valid=rng.random(R) > 0.15,
        noise=(rng.normal(size=R * S) * 0.03).astype(np.float32),
        ib=np.repeat(np.arange(Wn), n_rays), ih=rng.integers(0, H, R),
        iw=rng.integers(0, W, R))


def test_one_step_matches_jax_composition():
    """Tolerances: loss scalars rtol 2e-5; updated parameters atol 1e-6
    where |grad| > 1e-5 (AdamW's first step moves each weight by
    lr * g / (|g| + 1e-8), so weights whose gradient is near the 1e-8
    epsilon, where round-off decides the step, are excluded); arena
    priorities rtol 1e-5."""
    Wn, H, W, C = 5, 48, 64, 8
    cfg = TConfig().replace(
        bounds_method="pc", hidden_layers_block=1, window_size=Wn,
        mm_precision="highest", kf_buffer_size=C)
    jm = JM.SDFModel(hidden_layers_block=1)
    tm = TM.SDFModel(hidden_layers_block=1, mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(11), jm)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.3, 0.2]
    b = _step_batch(Wn=Wn, H=H, W=W)
    R, S = b["z"].shape
    N = R * S
    idxs = np.array([3, 0, 6, 4, 5])
    slot_valid = np.array([True, True, True, False, True])
    prio0 = np.random.default_rng(1).random(C).astype(np.float32)
    la0 = np.random.default_rng(2).random((C, 8, 8)).astype(np.float32)
    lr_scale = 0.7

    # ---- isdf_tpu ----
    op = make_pallas_train_op(
        jm, 1, loss_type=cfg.loss_type, trunc_distance=cfg.trunc_distance,
        trunc_weight=cfg.trunc_weight, eik_apply_dist=cfg.eik_apply_dist,
        eik_weight=cfg.eik_weight, grad_weight=cfg.grad_weight,
        orien_loss=cfg.orien_loss, interpret=True, force_f32=True,
        pe_in_kernel=True, pc_bounds=True, packed_io=True)
    packed = pack_params_train(pj)
    valid = jnp.asarray(b["valid"])
    vflat = jnp.repeat(valid, S).astype(jnp.float32)
    invC = 1.0 / float(S * b["valid"].sum())
    is_surf = jnp.zeros((R, S)).at[:, 0].set(1.0).reshape(-1)
    sums, ploss, grads = op(
        packed, jnp.asarray(T), jnp.asarray(b["pc"].reshape(N, 3)),
        jnp.asarray(b["pc"][:, 0]), valid.astype(jnp.float32),
        jnp.asarray((b["z"] - b["depth"][:, None]).reshape(N)),
        jnp.asarray(np.repeat(b["normals"], S, 0)), is_surf, vflat,
        jnp.asarray(b["noise"]), jnp.float32(invC))
    opt = optax.adamw(cfg.lr, weight_decay=cfg.weight_decay).init(packed)
    (Wp_j, bpt_j), _ = make_fused_adamw(cfg.lr, cfg.weight_decay)(
        packed, grads, opt, lr_scale)
    la, fa = JL.frame_avg_loss(ploss.reshape(R, S).sum(-1), valid,
                               jnp.asarray(b["ib"]), jnp.asarray(b["ih"]),
                               jnp.asarray(b["iw"]), Wn, H, W, factor=8)
    sv = jnp.asarray(slot_valid)
    ix = jnp.asarray(idxs)
    s_ = jnp.zeros((C,)).at[ix].add(jnp.where(sv, fa, 0.0))
    c_ = jnp.zeros((C,)).at[ix].add(sv.astype(jnp.float32))
    prio_j = jnp.where(c_ > 0, s_ / jnp.maximum(c_, 1.0), prio0)
    la_j = jnp.asarray(la0).at[ix].set(
        jnp.where(sv[:, None, None], la, jnp.asarray(la0)[ix]))

    # ---- isdf_tpu_torch ----
    fns = StepFunctions(cfg, tm, H, W, torch.zeros(H, W, 3), "cpu")
    pt = TM.params_from_jax(pj, tm)
    opt_t = TA.init_state(pt)
    buf = TB.make_buffer(C, H, W, with_normals=False)
    buf.count = C
    buf.frame_avg_loss.copy_(torch.as_tensor(prio0))
    buf.loss_approx.copy_(torch.as_tensor(la0))
    tt = {k: torch.as_tensor(v) for k, v in b.items()}
    scalars, ploss_t, grads_t = fns.loss_and_grad(
        pt, torch.as_tensor(T), tt["pc"], tt["z"], tt["dirs_C"],
        tt["dirs_W"], tt["depth"], tt["normals"], tt["valid"], tt["noise"],
        surf=tt["pc"][:, 0], sv=tt["valid"])
    g_plane = grads_t[0].clone()
    fns.update(pt, opt_t, buf, grads_t, ploss_t, torch.as_tensor(idxs),
               torch.as_tensor(slot_valid), tt["ib"], tt["ih"], tt["iw"],
               tt["valid"], lr_scale)

    np.testing.assert_allclose(float(scalars["total_loss"]),
                               float(sums[0]) * invC, rtol=2e-5)
    np.testing.assert_allclose(float(scalars["eikonal_loss"]),
                               float(sums[3]) * invC, rtol=2e-5)
    sure = np.abs(np.asarray(grads[0])) > 1e-5
    np.testing.assert_allclose(pt["Wp"].numpy()[sure],
                               np.asarray(Wp_j)[sure], atol=1e-6)
    np.testing.assert_allclose(g_plane.numpy(), np.asarray(grads[0]),
                               atol=5e-5, rtol=2e-3)
    np.testing.assert_allclose(pt["bp"].numpy().reshape(-1),
                               np.asarray(bpt_j)[0], atol=1e-6)
    np.testing.assert_allclose(buf.frame_avg_loss.numpy(),
                               np.asarray(prio_j), rtol=1e-5)
    np.testing.assert_allclose(buf.loss_approx.numpy(), np.asarray(la_j),
                               rtol=1e-5, atol=1e-7)


def _small(cfg_cls):
    cam = cfg_cls().camera.__class__(64, 48, 40.0, 40.0, 31.5, 23.5)
    return cfg_cls().replace(
        dataset_format="synthetic", n_rays=20, n_strat_samples=9,
        n_surf_samples=4, hidden_feature_size=64, hidden_layers_block=1,
        n_embed_funcs=4, kf_buffer_size=16, iters_per_frame=10,
        iters_per_kf=30, bounds_method="pc", do_eval=False,
        steps_per_bundle=10, mm_precision="highest", do_active=True,
        camera=cam)


def run_paired_trainers(knobs, steps=200, dt=0.005):
    """Both Trainers on the same synthetic frames from the same weights,
    with the config knobs ``knobs`` on both sides and a pinned simulated
    clock: both losses fall by 30% and the final SDF errors agree within a
    factor of 1.5. torch runs on 2 threads here: with several test
    processes on the machine, torch's default of one spinning thread per
    core makes concurrent runs of this test some 20x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return _paired_trainers(knobs, steps, dt)
    finally:
        torch.set_num_threads(threads)


def _paired_trainers(knobs, steps, dt):
    from isdf_tpu.data.synthetic import SyntheticDataset, SyntheticScene
    from isdf_tpu.engine.loop import train_loop as j_loop
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu_torch.engine.loop import train_loop as t_loop
    from isdf_tpu_torch.engine.trainer import Trainer as TTrainer

    scene = SyntheticScene(extents=(5.0, 3.0, 4.0))
    ds = SyntheticDataset(scene, n_frames=60, H=48, W=64)
    jt = JTrainer(_small(JConfig).replace(**knobs), dataset=ds, seed=1)
    tt = TTrainer(_small(TConfig).replace(**knobs), dataset=ds, seed=1,
                  device="cpu")
    tt.params = TM.params_from_jax(jt.params, tt.model)
    tt.frozen_params = TM.copy_params(tt.params)
    tt.opt_state = TA.init_state(tt.params)
    runs = {}
    for name, tr, loop in (("jax", jt, j_loop), ("torch", tt, t_loop)):
        tr._per_step_device_s = dt
        tr._bill_exact = True
        losses = []
        run_steps = tr.run_steps

        def rec(n, run_steps=run_steps, losses=losses):
            out = run_steps(n)
            losses.extend(np.asarray(out["total_loss"]).tolist())
            return out

        tr.run_steps = rec
        res = loop(tr, max_steps=steps)
        assert res.steps == steps
        rng = np.random.default_rng(0)
        pts = (rng.uniform(-1, 1, (4000, 3)) * (scene.extents / 2 - 0.05)
               ).astype(np.float32)
        mae = float(np.abs(tr.sdf_fn(pts) - scene.sdf_np(pts)).mean())
        runs[name] = (np.mean(losses[:10]), np.mean(losses[-10:]), mae,
                      len(res.kf_indices) + 1)
    for name, (first, last, mae, n_kf) in runs.items():
        assert last < 0.7 * first, (name, runs)
    ratio = runs["torch"][2] / runs["jax"][2]
    assert 1 / 1.5 < ratio < 1.5, runs
    return tt


def test_paired_trainers_learn_the_same_scene():
    run_paired_trainers({})


PORT_MODULES = [
    "isdf_tpu_torch.utils.config", "isdf_tpu_torch.utils.device",
    "isdf_tpu_torch.utils.profiling", "isdf_tpu_torch.ops.embedding",
    "isdf_tpu_torch.ops.geometry", "isdf_tpu_torch.ops.sampling",
    "isdf_tpu_torch.utils.nvcc", "isdf_tpu_torch.ops.cuda_bounds",
    "isdf_tpu_torch.ops.bounds", "isdf_tpu_torch.ops.losses",
    "isdf_tpu_torch.ops.render", "isdf_tpu_torch.models.sdf_mlp",
    "isdf_tpu_torch.models.cuda_mlp", "isdf_tpu_torch.models.fused_adamw",
    "isdf_tpu_torch.models.fused_vjp",
    "isdf_tpu_torch.models.cuda_reverse_fused",
    "isdf_tpu_torch.engine.buffer", "isdf_tpu_torch.engine.step",
    "isdf_tpu_torch.engine.trainer", "isdf_tpu_torch.engine.loop",
    "isdf_tpu_torch.data.frame_store", "isdf_tpu_torch.data.synthetic",
    "isdf_tpu_torch.data.datasets", "isdf_tpu_torch.train.train",
    "isdf_tpu_torch.train.profile_step", "isdf_tpu_torch.eval.metrics",
    "isdf_tpu_torch.eval.protocol", "isdf_tpu_torch.ops.frustum",
    "isdf_tpu_torch.engine.pose", "isdf_tpu_torch.eval.eval_pts",
    "isdf_tpu_torch.eval.objects", "isdf_tpu_torch.serve",
    "isdf_tpu_torch.utils.checkpoint", "isdf_tpu_torch.utils.mesh3d",
    "isdf_tpu_torch.utils.native", "isdf_tpu_torch.vis.mesh_export",
    "isdf_tpu_torch.utils.image_io", "isdf_tpu_torch.utils.trajectory",
    "isdf_tpu_torch.data.sdf_util", "isdf_tpu_torch.data.fixtures",
    "isdf_tpu_torch.data.live", "isdf_tpu_torch.data.ros_node",
    "isdf_tpu_torch.data.arkit", "isdf_tpu_torch.data.assets",
    "isdf_tpu_torch.data.replicaCAD_gt_sdf", "isdf_tpu_torch.vis.slices",
    "isdf_tpu_torch.parallel.multi_scene", "isdf_tpu_torch.train.train_multi",
    "isdf_tpu_torch.train.batch", "isdf_tpu_torch.eval.baselines",
    "isdf_tpu_torch.eval.figs",
]


def test_port_imports_neither_jax_nor_isdf_tpu():
    pkg = os.path.join(ROOT, "isdf_tpu_torch")
    found = sorted(
        os.path.relpath(os.path.join(d, f), pkg).replace(os.sep, ".")[:-3]
        for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")
        and f != "__init__.py")
    assert sorted(m[len("isdf_tpu_torch."):] for m in PORT_MODULES) == found
    code = ("import sys\n"
            f"for m in {PORT_MODULES!r}:\n    __import__(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'isdf_tpu', 'optax', 'cv2', 'PIL', "
            "'matplotlib')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "isdf_tpu." not in src.replace(
        "isdf_tpu_torch", "")


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_small(TConfig))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_small(TConfig), device="cuda")
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_tpu_only_knobs_are_inert(monkeypatch):
    """pallas_interpret, remat, compute_dtype and the Pallas environment
    variables change nothing in the port: same step, same numbers. Nor
    does use_pallas on this path, where the fused op computes the pc bounds
    itself (it selects K4 only for pc bounds computed outside the op, as in
    isdf_tpu)."""
    from isdf_tpu_torch.engine.trainer import Trainer
    out = []
    for knobs in ({}, dict(use_pallas=True, pallas_interpret=True,
                           remat=True, compute_dtype="bfloat16")):
        if knobs:
            monkeypatch.setenv("ISDF_PALLAS_TM", "256")
            monkeypatch.setenv("ISDF_PALLAS_FAST32", "1")
        tr = Trainer(_small(TConfig).replace(**knobs), device="cpu")
        tr.add_frame(tr.get_data([0])[0])
        out.append(tr.step()[0]["total_loss"])
    assert out[0] == out[1]


def test_unported_config_parts_raise():
    from isdf_tpu_torch.engine.trainer import Trainer
    # slices are ported: the config part no longer raises
    Trainer(_small(TConfig).replace(save_slices=True), device="cpu")
    with pytest.raises(NotImplementedError, match="data_parallel"):
        Trainer(_small(TConfig).replace(data_parallel=2), device="cpu")
    # every dataset format of isdf_tpu is ported; an unknown one raises
    # as it does there
    with pytest.raises(ValueError, match="unsupported dataset format"):
        Trainer(_small(TConfig).replace(dataset_format="replicaCADX"),
                device="cpu")


def test_cli_runs_synthetic_config_on_cpu(tmp_path):
    """The CLI on the shipped synthetic.json, cut to a tiny camera and
    width; do_eval runs the reference protocol into res.json ("rays")."""
    from isdf_tpu_torch.train.train import main
    cfg = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                       "synthetic.json")
    res = main(["--config", cfg, "--device", "cpu", "--max_steps", "30",
                "--sim_dt", "0.02", "--save_path", str(tmp_path),
                "--set", "dataset.camera.w=32", "--set", "dataset.camera.h=24",
                "--set", "dataset.camera.fx=20", "--set",
                "dataset.camera.fy=20", "--set", "dataset.camera.cx=15.5",
                "--set", "dataset.camera.cy=11.5", "--set", "sample.n_rays=8",
                "--set", "model.hidden_feature_size=32",
                "--set", "tpu.kf_buffer_size=8"])
    assert res.steps == 30
    assert res.sdf_evals and all(np.isfinite(v["rays"]["av_l1"])
                                 for v in res.sdf_evals.values())
    assert os.path.exists(tmp_path / "res.json")
