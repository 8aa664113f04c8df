"""The port's pose tracker (engine/pose.py) against isdf_tpu's on the CPU.

* The solve: given the sample set that isdf_tpu's refine_step draws from
  the same key (its key split, sample_pixels, then 0.05 * normal; the test
  reproduces them with jax.random), the port's Gauss-Newton iterations end
  with isdf_tpu's twists and losses within atol 1e-5 after pose_iters
  iterations, on a trained map and a misposed frame.
* On an untrained map the port holds still: no twist, no pose change.
* The evidence gate (apply_pose_corrections drops a weak burst) and the
  skip gate (should_refine_pose reads the keyframe test's proportion).
* The trainer with pose noise reduces a misposed frame's pose error, as
  tests/test_engine.py shows for isdf_tpu; the loop runs bursts with
  model.refine_poses and bills them to the clock.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu_torch.data.synthetic import SyntheticDataset, SyntheticScene
from isdf_tpu_torch.engine import pose as TP
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.utils.config import Config


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    """test_engine.py's pose-test config."""
    base = dict(dataset_format="synthetic", n_rays=64, n_strat_samples=5,
                n_surf_samples=3, hidden_feature_size=64,
                hidden_layers_block=1, n_embed_funcs=4, kf_buffer_size=8,
                refine_poses=True, bounds_method="ray",
                pose_min_rel_improve=0.05)
    base.update(kw)
    return Config().replace(**base)


_MAP = {}


def _mapped():
    """A port Trainer whose map is trained 450 steps on frame 0 at its true
    pose, with frame 1 ingested at its noisy pose (test_engine.py's
    scenario: 60 frames, 9 degrees apart, pose noise std 0.03). Returns a
    fresh deep copy of its state each call."""
    from isdf_tpu_torch.engine.trainer import Trainer
    if not _MAP:
        ds = SyntheticDataset(SyntheticScene(), n_frames=60, H=32, W=48,
                              pose_noise_std=0.03)
        tr = Trainer(_cfg(), dataset=ds, seed=0, device="cpu")
        f0 = dataclasses.replace(tr.get_data([0])[0], T_WC=ds.poses[0])
        tr.last_is_keyframe = True
        tr.add_frame(f0)
        for _ in range(15):
            tr.run_steps(30)
        f1 = tr.get_data([1])[0]
        assert f1.T_WC_gt is not None
        tr.last_is_keyframe = True
        tr.add_frame(f1)
        _MAP.update(tr=tr, ds=ds, params=TM.copy_params(tr.params),
                    T_WC=tr.buffer.T_WC.clone())
    tr = _MAP["tr"]
    tr.params = TM.copy_params(_MAP["params"])
    tr.buffer.T_WC.copy_(_MAP["T_WC"])
    tr.pose_state.twists.zero_()
    tr._last_burst_rel_improve = None
    return tr, _MAP["ds"]


def _jax_model(tm):
    from isdf_tpu.models import sdf_mlp as JM
    return JM.SDFModel(
        embedding_size=tm.embedding_size, hidden_size=tm.hidden_size,
        hidden_layers_block=tm.hidden_layers_block,
        scale_output=tm.scale_output, scale_input=tm.scale_input,
        min_deg=tm.min_deg, max_deg=tm.max_deg)


def _solve_both(key_seed, n_steps, rows_np=None):
    """isdf_tpu's burst and the port's solve on its draws, over the arena
    rows ``rows_np`` (both frames by default). Returns (port twists,
    losses, isdf_tpu's twists, losses)."""
    from isdf_tpu.engine.pose import build_pose_refine_step, init_pose_state
    from isdf_tpu.ops import geometry as JG
    from isdf_tpu.ops import sampling as JS
    tr, _ = _mapped()
    cfg = tr.cfg
    jmodel = _jax_model(tr.model)
    jparams = TM.params_to_jax(tr.params, tr.model)
    n = tr.buffer.count
    if rows_np is None:
        rows_np = np.arange(n - 2, n)   # both frames, one joint burst
    depth = tr.buffer.depth[rows_np].numpy()
    T = tr.buffer.T_WC[rows_np].numpy()
    transform = tr.transform_dev.numpy()
    dirs = np.asarray(JG.ray_dirs_C(tr.H, tr.W, tr.fx, tr.fy, tr.cx, tr.cy))

    key = jax.random.PRNGKey(key_seed)
    step = build_pose_refine_step(jmodel, n_rays=cfg.n_rays,
                                  n_surf_samples=cfg.n_surf_samples,
                                  min_depth=cfg.min_depth)
    state, _ = init_pose_state(cfg.kf_buffer_size)
    state, jlosses = step(jparams, state, jnp.asarray(depth), jnp.asarray(T),
                          jnp.asarray(rows_np), jnp.asarray(dirs),
                          jnp.asarray(transform), key, n_steps=n_steps)
    # isdf_tpu's draws from the same key (its pose.py:81-91)
    F, H, W = depth.shape
    k_pix, k_ray = jax.random.split(key)
    ib, ih, iw = JS.sample_pixels(k_pix, cfg.n_rays, F, H, W)
    offs = 0.05 * jax.random.normal(
        k_ray, (ib.shape[0], cfg.n_surf_samples - 1), jnp.float32)
    draws = tuple(torch.as_tensor(np.asarray(a)).long() for a in
                  (ib, ih, iw)) + (torch.as_tensor(np.asarray(offs)),)

    twists, losses = tr._pose_step.solve(
        tr.params, torch.zeros((cfg.kf_buffer_size, 6)),
        torch.as_tensor(depth), torch.as_tensor(T),
        torch.as_tensor(rows_np), torch.as_tensor(dirs),
        torch.as_tensor(transform), draws, n_steps=n_steps)
    return twists, losses, np.asarray(state.twists), np.asarray(jlosses)


@pytest.mark.parametrize("key_seed,n_steps", [(0, 10), (7, 10), (3, 4)])
def test_solve_matches_jax_on_its_draws(key_seed, n_steps):
    twists, losses, jtw, jlosses = _solve_both(key_seed, n_steps)
    assert np.abs(jtw).max() > 1e-3       # the burst moved the poses
    assert float(jlosses[-1]) < float(jlosses[0])
    np.testing.assert_allclose(twists.numpy(), jtw, atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               atol=1e-5)


def test_solve_matches_jax_with_a_repeated_frame():
    """A burst whose frames repeat an arena row (the newest frame twice):
    the fixed-order segment sums give each burst frame its own normal
    equations and add both steps into the one twist, as isdf_tpu's
    segment_sum and .at[rows].add do."""
    n = _mapped()[0].buffer.count
    twists, losses, jtw, jlosses = _solve_both(
        7, 6, rows_np=np.array([n - 1, n - 1]))
    assert np.abs(jtw[n - 1]).max() > 1e-4
    assert not np.abs(np.delete(jtw, n - 1, axis=0)).any()
    np.testing.assert_allclose(twists.numpy(), jtw, atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), jlosses, atol=1e-5)


@pytest.mark.parametrize("shape", [(), (6,), (6, 6)])
def test_segment_sum_fixed_order(shape):
    """segment_sum equals the f64 sums by segment over repeated segment
    ids, leaves empty segments zero, and repeats its bits (a fixed-order
    product, not index_add_'s atomics)."""
    rng = np.random.default_rng(11)
    R, F = 600, 5
    seg = rng.integers(0, F - 1, R)         # segment F - 1 stays empty
    v = rng.normal(size=(R,) + shape).astype(np.float32)
    onehot = TP.segment_onehot(torch.as_tensor(seg), F)
    assert onehot.shape == (F, R) and onehot.sum() == R
    out = TP.segment_sum(torch.as_tensor(v), onehot)
    want = np.zeros((F,) + shape)
    np.add.at(want, seg, v.astype(np.float64))
    assert out.shape == (F,) + shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not out[F - 1].any()
    again = TP.segment_sum(torch.as_tensor(v), onehot)
    assert torch.equal(out, again)


def test_holds_still_on_untrained_map():
    """A fresh net renders nothing the gates accept (|grad| is far from 1
    and the LM test rejects): the burst leaves every pose as it was."""
    from isdf_tpu_torch.engine.trainer import Trainer
    ds = SyntheticDataset(SyntheticScene(), n_frames=10, H=24, W=32,
                          pose_noise_std=0.03)
    tr = Trainer(_cfg(pose_min_rel_improve=0.0), dataset=ds, seed=0,
                 device="cpu")
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    T0 = tr.buffer.T_WC.clone()
    tr.refine_poses_step(n_frames=1, n_steps=10)
    assert float(tr.pose_state.twists.abs().max()) == 0.0
    tr.apply_pose_corrections()
    torch.testing.assert_close(tr.buffer.T_WC, T0, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tr.frames[-1].T_WC, T0[0].numpy(), atol=1e-7)


def test_pose_correction_evidence_gate():
    """apply_pose_corrections drops a burst whose loss barely improved:
    arena poses unchanged, twists reset; a strong burst folds."""
    from isdf_tpu_torch.engine.trainer import Trainer
    cfg = _cfg(n_rays=16, n_strat_samples=4, n_surf_samples=2,
               hidden_feature_size=32, n_embed_funcs=3, kf_buffer_size=4,
               bounds_method="pc", pose_min_rel_improve=0.25)
    ds = SyntheticDataset(SyntheticScene(), n_frames=4, H=16, W=24)
    tr = Trainer(cfg, dataset=ds, seed=0, device="cpu")
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    T_before = tr.buffer.T_WC[0].clone()

    tr.pose_state.twists[0, 3] = 0.05
    tr._last_burst_rel_improve = 0.01          # below the 0.25 gate
    tr.apply_pose_corrections()
    torch.testing.assert_close(tr.buffer.T_WC[0], T_before, rtol=0, atol=0)
    assert float(tr.pose_state.twists.abs().max()) == 0.0

    tr.pose_state.twists[0, 3] = 0.05
    tr._last_burst_rel_improve = 0.5           # strong evidence: folds
    tr.apply_pose_corrections()
    assert abs(float(tr.buffer.T_WC[0, 0, 3]) - (float(T_before[0, 3])
                                                 + 0.05)) < 1e-5
    assert float(tr.pose_state.twists.abs().max()) == 0.0
    # the newest frame's host copy holds the folded pose
    np.testing.assert_array_equal(tr.frames[-1].T_WC,
                                  tr.buffer.T_WC[0].numpy())


def test_pose_burst_skip_gate_on_render_evidence():
    from isdf_tpu_torch.engine.trainer import Trainer
    cfg = _cfg(n_rays=16, n_strat_samples=4, n_surf_samples=2,
               hidden_feature_size=32, n_embed_funcs=3, kf_buffer_size=4,
               bounds_method="pc", pose_min_rel_improve=0.25)
    ds = SyntheticDataset(SyntheticScene(), n_frames=4, H=16, W=24)
    tr = Trainer(cfg, dataset=ds, seed=0, device="cpu")
    assert tr.should_refine_pose()             # no evidence yet: refine
    tr._last_kf_prop = 0.95                    # well explained: skip
    assert not tr.should_refine_pose()
    tr._last_kf_prop = 0.40                    # the map disagrees: refine
    assert tr.should_refine_pose()
    tr.cfg = cfg.replace(pose_skip_prop=0.0)   # gate off
    tr._last_kf_prop = 0.99
    assert tr.should_refine_pose()
    tr.cfg = cfg
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([0])[0])
    tr._last_kf_prop = -1.0
    tr.is_keyframe(tr.frames[-1])              # records the proportion
    assert 0.0 <= tr._last_kf_prop <= 1.0


def test_refinement_reduces_pose_error_in_trainer():
    tr, ds = _mapped()
    T_gt = ds.poses[1]
    err0 = float(np.abs(tr.buffer.T_WC[1].numpy() - T_gt).max())
    tr.refine_poses_step(n_steps=60)
    tr.apply_pose_corrections()
    err1 = float(np.abs(tr.buffer.T_WC[1].numpy() - T_gt).max())
    assert np.isfinite(err1)
    assert err1 < err0 * 0.7, (err0, err1)
    assert float(tr.pose_state.twists.abs().max()) == 0.0
    assert tr._last_burst_s > 0.0


@pytest.mark.parametrize("pinned", [None, 0.002])
def test_loop_runs_bursts_and_bills_them(pinned):
    """With model.refine_poses the loop runs one burst per ingested frame
    that the skip gate lets through and bills it to the clock: its
    measured time, or trainer._pose_burst_device_s where a run pins it
    (the clock then ends at exactly steps x dt + bursts x pinned)."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    ds = SyntheticDataset(SyntheticScene(), n_frames=30, H=24, W=32,
                          pose_noise_std=0.01, pose_noise_mode="walk")
    tr = Trainer(_cfg(pose_skip_prop=0.0, pose_iters=3, n_rays=16,
                      hidden_feature_size=32), dataset=ds, seed=0,
                 device="cpu")
    tr._per_step_device_s, tr._bill_exact = 0.001, True
    tr._pose_burst_device_s = pinned
    calls = []
    step = tr.refine_poses_step

    def counting(*a, **k):
        calls.append(k)
        return step(*a, **k)

    tr.refine_poses_step = counting
    res = train_loop(tr, max_steps=300)
    assert len(calls) >= 2
    assert all(c == dict(n_frames=1, n_steps=3) for c in calls)
    if pinned is None:
        assert res.tot_step_time > res.steps * 0.001 + 1e-4
    else:
        assert res.tot_step_time == pytest.approx(
            res.steps * 0.001 + len(calls) * pinned, abs=1e-9)
