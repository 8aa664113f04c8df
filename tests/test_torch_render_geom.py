"""The port's geometry, pose noise, renders and frustum tests against
isdf_tpu's on the CPU, on the same numpy inputs from a seed.

Tolerances: float32 functions that both packages compute in the same
order agree within 1e-6 (absolute, on values of order 1); the SE(3)
perturbed poses and the renders within 1e-5 (a 4x4 product and a sort of
sampled depths on top); boolean outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.data import synthetic as JS
from isdf_tpu.engine.step import build_step_functions
from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.ops import frustum as JF
from isdf_tpu.ops import geometry as JG
from isdf_tpu.ops import render as JR
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.data import synthetic as TS
from isdf_tpu_torch.engine.step import StepFunctions
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import frustum as TF
from isdf_tpu_torch.ops import geometry as TG
from isdf_tpu_torch.ops import render as TR
from isdf_tpu_torch.utils.config import Config as TConfig


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """torch on 2 threads: with several test processes on the machine, its
    default of one spinning thread per core slows concurrent runs many
    times over (tests/test_torch_slice.py::run_paired_trainers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _poses(rng, n):
    import scipy.spatial.transform as st
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = st.Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.5
                                           ).as_matrix()
    T[:, :3, 3] = rng.normal(size=(n, 3))
    return T


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.3, 2.0])
def test_exp_so3_and_exp_se3(scale):
    """Both branches: the Taylor form below theta^2 = 1e-8 and Rodrigues."""
    rng = np.random.default_rng(0)
    tw = (rng.normal(size=(7, 6)) * scale).astype(np.float32)
    np.testing.assert_allclose(
        TG.exp_so3(torch.as_tensor(tw[:, :3])).numpy(),
        np.asarray(JG.exp_so3(jnp.asarray(tw[:, :3]))), atol=1e-6)
    got = TG.exp_se3(torch.as_tensor(tw)).numpy()
    np.testing.assert_allclose(got, np.asarray(JG.exp_se3(jnp.asarray(tw))),
                               atol=1e-6)
    R = got[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.tile(np.eye(3), (7, 1, 1)), atol=1e-5)


def test_make_and_transform_3D_grid():
    rng = np.random.default_rng(1)
    T = _poses(rng, 1)[0]
    scale = np.array([1.5, 0.8, 2.0], np.float32)
    got = TG.make_3D_grid((-1.0, 1.0), 7, transform=torch.as_tensor(T),
                          scale=torch.as_tensor(scale)).numpy()
    want = np.asarray(JG.make_3D_grid((-1.0, 1.0), 7,
                                      transform=jnp.asarray(T),
                                      scale=jnp.asarray(scale)))
    assert got.shape == want.shape == (7, 7, 7, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    g = rng.normal(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TG.transform_3D_grid(torch.as_tensor(g)).numpy(), g)
    np.testing.assert_allclose(
        TG.transform_3D_grid(torch.as_tensor(g), scale=2.0).numpy(), 2 * g)


@pytest.mark.parametrize("mode", ["iid", "walk"])
def test_synthetic_pose_noise(mode):
    """Reported poses perturbed by the same numpy twists, depth and T_gt
    from the true pose."""
    kw = dict(n_frames=12, H=12, W=16, seed=3, pose_noise_std=0.02,
              pose_noise_mode=mode)
    jd = JS.SyntheticDataset(JS.make_scene("room_b"), **kw)
    td = TS.SyntheticDataset(TS.make_scene("room_b"), **kw)
    np.testing.assert_allclose(np.stack(td.noisy_poses),
                               np.stack(jd.noisy_poses), atol=1e-5)
    for i in (0, 7, 11):
        s_t, s_j = td[i], jd[i]
        np.testing.assert_allclose(s_t["T"], s_j["T"], atol=1e-5)
        np.testing.assert_array_equal(s_t["T_gt"], s_j["T_gt"])
        np.testing.assert_allclose(s_t["depth"], s_j["depth"], atol=1e-4)
        assert not np.allclose(s_t["T"], s_t["T_gt"])
    with pytest.raises(ValueError, match="pose_noise_mode"):
        TS.SyntheticDataset(TS.make_scene(), pose_noise_std=0.1,
                            pose_noise_mode="drift", n_frames=2)


def test_gt_sdf_grid():
    js, ts = JS.make_scene("room_c"), TS.make_scene("room_c")
    for dim, pad in ((9, 0.0), (12, 0.1)):
        sj, Tj = js.gt_sdf_grid(dim, pad)
        st, Tt = ts.gt_sdf_grid(dim, pad)
        assert st.shape == (dim, dim, dim)
        np.testing.assert_allclose(st, sj, atol=1e-6)
        np.testing.assert_allclose(Tt, Tj, atol=1e-7)


def test_render_normals_and_weighted():
    rng = np.random.default_rng(2)
    T = _poses(rng, 3)
    dirs = np.concatenate([rng.uniform(-0.5, 0.5, (3, 10, 2)),
                           np.ones((3, 10, 1))], -1).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (3, 10)).astype(np.float32)
    A = rng.normal(size=(3, 3)).astype(np.float32)

    def grad_t(pc):
        return torch.sin(pc) @ torch.as_tensor(A)

    def grad_j(pc):
        return jnp.sin(pc) @ jnp.asarray(A)

    got = TR.render_normals_C(torch.as_tensor(T)[:, None],
                              torch.as_tensor(depth), grad_t,
                              torch.as_tensor(dirs)).numpy()
    want = np.asarray(JR.render_normals_C(jnp.asarray(T)[:, None],
                                          jnp.asarray(depth), grad_j,
                                          jnp.asarray(dirs)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    w = rng.random((4, 6)).astype(np.float32)
    v = rng.normal(size=(4, 6)).astype(np.float32)
    for axis, norm in ((-1, False), (0, True)):
        np.testing.assert_allclose(
            TR.render_weighted(torch.as_tensor(w), torch.as_tensor(v), axis,
                               norm).numpy(),
            np.asarray(JR.render_weighted(jnp.asarray(w), jnp.asarray(v),
                                          axis, norm)), atol=1e-6)


def test_step_render_depth_matches_jax():
    """StepFunctions.render_depth on the same stratified draws."""
    kw = dict(hidden_feature_size=32, hidden_layers_block=1,
              n_embed_funcs=3, mm_precision="highest")
    cfg_j, cfg_t = JConfig().replace(**kw), TConfig().replace(**kw)
    H, W, F, N, n_strat = 12, 16, 2, 9, 20
    jm = JM.SDFModel(embedding_size=cfg_j.embedding_size, hidden_size=32,
                     hidden_layers_block=1, max_deg=3)
    tm = TM.SDFModel(embedding_size=cfg_t.embedding_size, hidden_size=32,
                     hidden_layers_block=1, max_deg=3,
                     mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(0), jm)
    rng = np.random.default_rng(4)
    T = _poses(rng, F)
    T[:, :3, 3] *= 0.1
    dirs = np.concatenate([rng.uniform(-0.5, 0.5, (F, N, 2)),
                           np.ones((F, N, 1))], -1).astype(np.float32)
    depth = rng.uniform(0.5, 2.5, (F, N)).astype(np.float32)
    tr = np.eye(4, dtype=np.float32)
    tr[:3, 3] = [0.2, -0.1, 0.3]
    key = jax.random.PRNGKey(9)
    fj = build_step_functions(cfg_j, jm, H, W, jnp.zeros((H, W, 3)))
    want = np.asarray(fj.render_depth(pj, jnp.asarray(T), jnp.asarray(dirs),
                                      jnp.asarray(depth), jnp.asarray(tr),
                                      key, n_strat=n_strat))
    u = jax.random.uniform(jax.random.split(key)[0], (F * N, n_strat))
    ft = StepFunctions(cfg_t, tm, H, W, torch.zeros(H, W, 3), "cpu")
    got = ft.render_depth(TM.params_from_jax(pj, tm), torch.as_tensor(T),
                          torch.as_tensor(dirs), torch.as_tensor(depth),
                          torch.as_tensor(tr), None, n_strat=n_strat,
                          draws=torch.as_tensor(np.asarray(u))).numpy()
    assert got.shape == (F, N)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_frustum_functions():
    rng = np.random.default_rng(5)
    H, W, fx, fy, cx, cy = 24, 32, 20.0, 21.0, 15.5, 11.5
    T = _poses(rng, 3)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 2.0
    depth = rng.uniform(0.5, 4.0, (3, H, W)).astype(np.float32)
    depth[:, :4] = 0.0
    n_t = TF.frustum_normals(torch.as_tensor(T[0, :3, :3]), H, W, fx, fy,
                             cx, cy)
    n_j = JF.frustum_normals(jnp.asarray(T[0, :3, :3]), H, W, fx, fy, cx, cy)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6)
    np.testing.assert_array_equal(
        TF.inside_frustum(torch.as_tensor(pts), torch.as_tensor(T[0, :3, 3]),
                          n_t).numpy(),
        np.asarray(JF.inside_frustum(jnp.asarray(pts),
                                     jnp.asarray(T[0, :3, 3]), n_j)))
    vis_t = TF.is_visible(torch.as_tensor(pts), torch.as_tensor(T),
                          torch.as_tensor(depth), fx, fy, cx, cy).numpy()
    vis_j = np.asarray(JF.is_visible(jnp.asarray(pts), jnp.asarray(T),
                                     jnp.asarray(depth), fx, fy, cx, cy))
    assert vis_t.shape == (3, 300) and vis_t.any()
    np.testing.assert_array_equal(vis_t, vis_j)
    np.testing.assert_array_equal(
        TF.is_visible_np(pts, T[1], depth[1], fx, fy, cx, cy),
        JF.is_visible_np(pts, T[1], depth[1], fx, fy, cx, cy))
