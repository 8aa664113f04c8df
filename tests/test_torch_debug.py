"""The port's debug oracles (eval/debug.py, vis/debug.py) and
ops/sampling.py::sample_rays_from_frames against isdf_tpu's on the CPU.

* sample_rays_from_frames: every field equal to isdf_tpu's given its draws
  (atol 1e-6), masked rays (zero depth, NaN normals, an invalid frame)
  included.
* ray_oracle and check_gt_sdf: the same weights, arena and draws as an
  isdf_tpu trainer's; every curve within atol 1e-5.
* the figures (ray_oracle_figure, vis_embedding on both branches,
  check_gt_sdf's panel) within tests/test_torch_plot.py's image bound of
  matplotlib's, with the same canvas sizes and (where the figure is laid
  out by tight_layout) axes boxes within 1 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.eval import debug as JD
from isdf_tpu.ops import sampling as JS
from isdf_tpu.vis import debug as JVD
from isdf_tpu_torch.eval import debug as TD
from isdf_tpu_torch.ops import sampling as S
from isdf_tpu_torch.vis import debug as TVD
from tests.test_torch_plot import (Captured, assert_same_boxes,
                                   assert_within_bound, read_rgb)

CAM = (64, 48, 40.0, 40.0, 31.5, 23.5)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def jax_frame_draws(seed, T, H, W, n_strat, n_surf):
    """The draws isdf_tpu's sample_rays_from_frames takes from
    PRNGKey(seed), as the port's ``draws`` tuple."""
    k_pix, k_ray = jax.random.split(jax.random.PRNGKey(seed))
    kh, kw = jax.random.split(k_pix)
    k_strat, k_surf = jax.random.split(k_ray)
    return (_t(jax.random.randint(kh, (T,), 0, H), torch.long),
            _t(jax.random.randint(kw, (T,), 0, W), torch.long),
            _t(jax.random.uniform(k_strat, (T, n_strat))),
            _t(jax.random.normal(k_surf, (T, n_surf - 1))))


@pytest.mark.parametrize("with_normals", [True, False])
def test_sample_rays_from_frames_given_isdf_tpus_draws(with_normals):
    rng = np.random.default_rng(3)
    F, H, W, n = 3, 12, 16, 40
    depth = rng.uniform(0.5, 4.0, (F, H, W)).astype(np.float32)
    depth[rng.random((F, H, W)) < 0.2] = 0.0
    normals = rng.normal(size=(F, H, W, 3)).astype(np.float32)
    normals[rng.random((F, H, W)) < 0.15] = np.nan
    T = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    T[:, :3, 3] = rng.normal(size=(F, 3))
    T[:, :3, :3] = np.linalg.qr(rng.normal(size=(F, 3, 3)))[0]
    dirs = np.concatenate([rng.normal(size=(H, W, 2)) * 0.5,
                           np.ones((H, W, 1))], -1).astype(np.float32)
    fv = np.array([True, False, True])
    nb = normals if with_normals else None
    want = JS.sample_rays_from_frames(
        jax.random.PRNGKey(7), jnp.asarray(depth), jnp.asarray(T),
        jnp.asarray(dirs), None if nb is None else jnp.asarray(nb),
        jnp.asarray(fv), n, 0.07, 0.1, 9, 4)
    got = S.sample_rays_from_frames(
        None, _t(depth), _t(T), _t(dirs), None if nb is None else _t(nb),
        _t(fv), n, 0.07, 0.1, 9, 4,
        draws=jax_frame_draws(7, F * n, H, W, 9, 4))
    for field in S.RaySamples._fields:
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, atol=1e-6, err_msg=field)
    assert not got.valid[n:2 * n].any()            # the invalid frame
    assert torch.isfinite(got.pc).all()
    # its own draws: on the frames' device, seeded
    g = torch.Generator().manual_seed(1)
    a = S.sample_rays_from_frames(g, _t(depth), _t(T), _t(dirs), None,
                                  _t(fv), n, 0.07, 0.1, 9, 4)
    assert a.pc.shape == (F * n, 13, 3) and a.pc.device.type == "cpu"


def _cfg(cls, **kw):
    cam = cls().camera.__class__(*CAM)
    base = dict(dataset_format="synthetic", n_rays=20, n_strat_samples=9,
                n_surf_samples=4, hidden_feature_size=64,
                hidden_layers_block=1, n_embed_funcs=4, kf_buffer_size=12,
                bounds_method="pc", do_eval=False, mm_precision="highest",
                camera=cam, max_depth=12.0)
    base.update(kw)
    return cls().replace(**base)


@pytest.fixture(scope="module")
def pair():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield make_pair()
    finally:
        torch.set_num_threads(threads)


def make_pair():
    """A port trainer trained 30 steps on two frames, and an isdf_tpu
    trainer on the same scene with its weights and frames."""
    from isdf_tpu.data.synthetic import SyntheticDataset as JDS
    from isdf_tpu.data.synthetic import SyntheticScene as JScene
    from isdf_tpu.engine.trainer import Trainer as JTrainer
    from isdf_tpu.utils.config import Config as JConfig
    from isdf_tpu_torch.data.synthetic import (SyntheticDataset,
                                               SyntheticScene)
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import sdf_mlp as TM
    from isdf_tpu_torch.utils.config import Config

    scene = dict(extents=(5.0, 3.0, 4.0))
    tt = Trainer(_cfg(Config), dataset=SyntheticDataset(
        SyntheticScene(**scene), n_frames=30, H=48, W=64), seed=2,
        device="cpu", grid_dim=32)
    jt = JTrainer(_cfg(JConfig), dataset=JDS(
        JScene(**scene), n_frames=30, H=48, W=64), seed=2, grid_dim=32)
    for tr in (tt, jt):
        for fid in (0, 15):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
    tt.run_steps(30)
    jt.params = jax.tree_util.tree_map(
        jnp.asarray, TM.params_to_jax(tt.params, tt.model))
    return tt, jt


@pytest.mark.parametrize("slot,seed", [(0, 0), (1, 3)])
def test_ray_oracle_equals_isdf_tpus(pair, slot, seed):
    tt, jt = pair
    n_rays = 3
    T = max(4 * n_rays, 64)
    want = JD.ray_oracle(jt, slot=slot, n_rays=n_rays, seed=seed)
    draws = jax_frame_draws(seed, T, tt.H, tt.W, tt.cfg.n_strat_samples,
                            tt.cfg.n_surf_samples)
    got = TD.ray_oracle(tt, slot=slot, n_rays=n_rays, seed=seed,
                        draws=draws)
    assert len(got) == len(want) == n_rays
    for a, b in zip(want, got):
        assert set(a) == set(b) == {"z", "ray", "normal", "pc", "pred",
                                    "gt"}
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
    # its own generator: seeded on the trainer's device
    x = TD.ray_oracle(tt, slot=slot, n_rays=2, seed=seed)
    y = TD.ray_oracle(tt, slot=slot, n_rays=2, seed=seed)
    for a, b in zip(x, y):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def jax_check_draws(tt, seed, n_rays=100):
    """The draws isdf_tpu's check_gt_sdf takes from PRNGKey(seed)."""
    k_pix, k_ray = jax.random.split(jax.random.PRNGKey(seed))
    kh, kw = jax.random.split(k_pix)
    k_strat, k_surf = jax.random.split(k_ray)
    cfg = tt.cfg
    return (_t(jax.random.randint(kh, (n_rays,), 0, tt.H), torch.long),
            _t(jax.random.randint(kw, (n_rays,), 0, tt.W), torch.long),
            _t(jax.random.uniform(k_strat, (n_rays, cfg.n_strat_samples))),
            _t(jax.random.normal(k_surf, (n_rays, cfg.n_surf_samples - 1))))


def test_check_gt_sdf_equals_isdf_tpus(pair):
    tt, jt = pair
    n_rays, seed = 100, 4
    want = JVD.check_gt_sdf(jt, frame_ix=1, n_rays=n_rays, seed=seed)
    got = TVD.check_gt_sdf(tt, frame_ix=1, n_rays=n_rays,
                           draws=jax_check_draws(tt, seed, n_rays))
    assert list(got) == list(want) == [9, 19, 23]
    for i in want:
        for k in ("z", "gt_sdf", "ray", "pc", "normal"):
            np.testing.assert_allclose(got[i][k], want[i][k], atol=1e-5,
                                       err_msg=f"{i} {k}")
    rows = TVD.check_gt_sdf(tt, n_rays=n_rays, seed=seed)
    assert set(rows) == {9, 19, 23}


def test_debug_figures_within_the_bound(pair, tmp_path, monkeypatch):
    tt, jt = pair
    cap = Captured(monkeypatch)
    # ray_oracle_figure on the same curves (isdf_tpu's oracle's)
    rays = JD.ray_oracle(jt, n_rays=3, seed=1)
    JD.ray_oracle_figure(None, str(tmp_path / "rj.png"), rays=rays)
    TD.ray_oracle_figure(None, str(tmp_path / "rt.png"), rays=rays)
    assert_within_bound(read_rgb(tmp_path / "rj.png"),
                        read_rgb(tmp_path / "rt.png"), "ray_oracle_figure")
    # vis_embedding, both branches (B as a tensor for the port)
    from isdf_tpu.ops.embedding import init_gaussian_embedding
    B = np.array(init_gaussian_embedding(jax.random.PRNGKey(0),
                                         n_feats=16))
    for name, kw_j, kw_t in (("bands", dict(scale=0.5), dict(scale=0.5)),
                             ("gauss", dict(B=B), dict(B=torch.as_tensor(
                                 B)))):
        JD.vis_embedding(str(tmp_path / f"ej_{name}.png"), **kw_j)
        TD.vis_embedding(str(tmp_path / f"et_{name}.png"), **kw_t)
        assert_within_bound(read_rgb(tmp_path / f"ej_{name}.png"),
                            read_rgb(tmp_path / f"et_{name}.png"), name)
        assert_same_boxes(cap.mpl[-1], cap.kit[-1])
    # check_gt_sdf's panel, each package on its own trainer and draws
    # (the curves agree within 1e-5 above)
    JVD.check_gt_sdf(jt, seed=2, out_file=str(tmp_path / "gj.png"))
    out = TVD.check_gt_sdf(tt, seed=2, out_file=str(tmp_path / "gt.png"),
                           draws=jax_check_draws(tt, 2))
    assert out == str(tmp_path / "gt.png")
    assert_within_bound(read_rgb(tmp_path / "gj.png"),
                        read_rgb(tmp_path / "gt.png"), "check_gt_sdf")
    assert_same_boxes(cap.mpl[-1], cap.kit[-1])
    # ray_oracle_figure from the port's own oracle writes a figure too
    TD.ray_oracle_figure(tt, str(tmp_path / "own.png"), n_rays=2, seed=1)
    assert read_rgb(tmp_path / "own.png").shape[0] > 200


def test_oracles_raise_without_their_inputs(pair):
    tt, _ = pair

    class Empty:
        buffer = type("B", (), {"count": 0})()
    with pytest.raises(ValueError, match="empty keyframe buffer"):
        TD.ray_oracle(Empty())

    class NoGT:
        gt_sdf_fn = None
    with pytest.raises(ValueError, match="GT SDF"):
        TVD.check_gt_sdf(NoGT())
