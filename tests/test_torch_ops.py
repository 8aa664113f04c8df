"""The port's step ops against isdf_tpu's on the CPU.

Random draws: each JAX op takes a key; the test draws the same numbers from
that key with jax.random (replaying the op's own key splits) and hands them
to the port's op, so both compute on identical draws. Tolerances are
float32 round-off (stated per test) unless the op is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.engine import buffer as JB
from isdf_tpu.engine.step import select_window as j_select_window
from isdf_tpu.models.fused_adamw import make_fused_adamw as j_adamw
from isdf_tpu.ops import bounds as JBo
from isdf_tpu.ops import geometry as JG
from isdf_tpu.ops import losses as JL
from isdf_tpu.ops import render as JR
from isdf_tpu.ops import sampling as JS
from isdf_tpu_torch.engine import buffer as TB
from isdf_tpu_torch.engine.step import select_window as t_select_window
from isdf_tpu_torch.models import fused_adamw as TA
from isdf_tpu_torch.ops import bounds as TBo
from isdf_tpu_torch.ops import geometry as TG
from isdf_tpu_torch.ops import losses as TL
from isdf_tpu_torch.ops import render as TR
from isdf_tpu_torch.ops import sampling as TS


def t(x):
    return torch.as_tensor(np.array(x))


def _poses(n, seed=0):
    import scipy.spatial.transform as st
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = st.Rotation.from_rotvec(rng.normal(size=(n, 3))
                                           ).as_matrix()
    T[:, :3, 3] = rng.normal(size=(n, 3))
    return T


# ---------------------------------------------------------------- sampling

def test_sample_pixels_active_matches_given_the_same_draws():
    key = jax.random.PRNGKey(3)
    n_rays, n_frames, H, W = 40, 5, 48, 64
    grids = np.random.default_rng(1).random((n_frames, 8, 8)).astype(
        np.float32)
    grids[2] = 0.0  # an empty grid degrades to uniform
    want = JS.sample_pixels_active(key, n_rays, n_frames, H, W,
                                   jnp.asarray(grids), 0.5)
    kb, kh, kw, ku = jax.random.split(key, 4)
    total = n_rays * n_frames
    draws = (t(jax.random.randint(kh, (total,), 0, H)),
             t(jax.random.randint(kw, (total,), 0, W)),
             t(jax.random.gumbel(kb, (n_frames, n_rays, 64))),
             t(jax.random.randint(ku, (2, total), 0, max(H // 8, W // 8))))
    got = TS.sample_pixels_active(None, n_rays, n_frames, H, W, t(grids),
                                  0.5, draws=draws)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_pixels_layout():
    gen = torch.Generator().manual_seed(0)
    ib, ih, iw = TS.sample_pixels(gen, 7, 3, 10, 20)
    np.testing.assert_array_equal(ib.numpy(), np.repeat(np.arange(3), 7))
    assert ih.max() < 10 and iw.max() < 20 and ih.min() >= 0


def test_sample_along_rays_matches_given_the_same_draws():
    """float32: atol 1e-5 (a 3x3 rotation evaluated in another order)."""
    key = jax.random.PRNGKey(5)
    R = 30
    rng = np.random.default_rng(2)
    T = _poses(R)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, R).astype(np.float32)
    want = JS.sample_along_rays(key, jnp.asarray(T), jnp.asarray(dirs),
                                jnp.asarray(depth), 0.07, 0.1, 19, 8)
    k_strat, k_surf = jax.random.split(key)
    draws = (t(jax.random.uniform(k_strat, (R, 19))),
             t(jax.random.normal(k_surf, (R, 7))))
    got = TS.sample_along_rays(None, t(T), t(dirs), t(depth), 0.07, 0.1, 19,
                               8, draws=draws)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ------------------------------------------------------------------ bounds

def _rays(R=40, S=7, seed=1):
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(R, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.5, 3.0, (R, S)).astype(np.float32), axis=1)
    depth = z[:, 0] + rng.uniform(0, 0.5, R).astype(np.float32)
    pc = origins[:, None] + dirs[:, None] * z[..., None]
    return pc, z, depth, dirs, rng.random(R) > 0.2


@pytest.mark.parametrize("method", ["ray", "pc"])
def test_bounds_match_jax(method):
    """atol 1e-5 on bounds and gradient targets."""
    pc, z, depth, dirs, valid = _rays()
    dirs_W = dirs * 1.3
    a = JBo.compute_bounds(method, jnp.asarray(dirs), jnp.asarray(depth),
                           jnp.asarray(dirs_W), jnp.asarray(z),
                           jnp.asarray(pc), 0.3, None, jnp.asarray(valid))
    b = TBo.compute_bounds(method, t(dirs), t(depth), t(dirs_W), t(z), t(pc),
                           0.3, None, t(valid))
    np.testing.assert_allclose(b.bounds.numpy(), np.asarray(a.bounds),
                               atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad), atol=1e-5)
    if method == "pc":
        np.testing.assert_array_equal(b.grad_valid.numpy(),
                                      np.asarray(a.grad_valid))


def test_bounds_pc_ties_give_the_same_distance():
    """Surface points at exactly tied distances: the bound (the chosen
    point's distance) agrees, whichever index either side picks."""
    surf = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]],
                    np.float32)
    z = np.tile(np.array([0.0, 0.5, 1.5], np.float32), (4, 1))
    pc = np.zeros((4, 3, 3), np.float32)
    pc[:, 0] = surf
    pc[:, 1:, 2] = z[:, 1:]  # samples on the z axis: equidistant pairs
    depth = np.full(4, 1.0, np.float32)
    valid = np.ones(4, bool)
    a = JBo.bounds_pc(jnp.asarray(pc), jnp.asarray(z), jnp.asarray(depth),
                      jnp.asarray(valid))
    b = TBo.bounds_pc(t(pc), t(z), t(depth), t(valid))
    np.testing.assert_allclose(b.bounds.numpy(), np.asarray(a.bounds),
                               atol=1e-6)


def test_cos_sim_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 50, 3)).astype(np.float32)
    a[0] = 0.0
    np.testing.assert_allclose(TBo.cos_sim(t(a), t(b)).numpy(),
                               np.asarray(JBo.cos_sim(a, b)), atol=1e-6)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("loss_type", ["L1", "L2"])
def test_losses_match_jax(loss_type):
    """sdf_loss, grad_cosine_loss and tot_loss; atol 1e-6 + rtol 1e-6
    (L2 squares residuals up to ~25)."""
    rng = np.random.default_rng(4)
    R, S = 30, 9
    sdf = rng.normal(0.1, 0.3, (R, S)).astype(np.float32)
    bnd = rng.normal(0.1, 0.4, (R, S)).astype(np.float32)
    g = rng.normal(size=(R, S, 3)).astype(np.float32)
    gv = rng.normal(size=(R, S - 1, 3)).astype(np.float32)
    gvv = rng.random((R, S - 1)) > 0.3
    normals = rng.normal(size=(R, 3)).astype(np.float32)
    valid = rng.random(R) > 0.2
    mj, fj = JL.sdf_loss(sdf, bnd, 0.29, loss_type)
    mt, ft = TL.sdf_loss(t(sdf), t(bnd), 0.29, loss_type)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    gj = JL.grad_cosine_loss(g, gv, gvv, normals)
    gt = TL.grad_cosine_loss(t(g), t(gv), t(gvv), t(normals))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
    eik = np.abs(np.linalg.norm(g, axis=-1) - 1.0)
    oj = JL.tot_loss(mj, gj, eik, fj, bnd, valid, 0.1, 5.38, 0.018, 0.268)
    ot = TL.tot_loss(mt, gt, t(eik), ft, t(bnd), t(valid), 0.1, 5.38, 0.018,
                     0.268)
    np.testing.assert_allclose(ot.mat.numpy(), np.asarray(oj.mat), atol=1e-6,
                               rtol=1e-6)
    for k in oj.scalars:
        np.testing.assert_allclose(float(ot.scalars[k]),
                                   float(oj.scalars[k]), rtol=1e-5)


def test_frame_avg_loss_sums_repeated_pixels():
    """Repeated pixels add up in the block grid (a summing scatter); exact
    up to float32 summation order (rtol 1e-6)."""
    rng = np.random.default_rng(5)
    n_frames, n_rays, H, W = 3, 50, 48, 64
    total = n_frames * n_rays
    ib = np.repeat(np.arange(n_frames), n_rays)
    ih = rng.integers(0, H, total)
    iw = rng.integers(0, W, total)
    ih[:10] = 5  # the same pixel ten times
    iw[:10] = 7
    loss = rng.random(total).astype(np.float32)
    valid = rng.random(total) > 0.1
    aj, fj = JL.frame_avg_loss(jnp.asarray(loss), jnp.asarray(valid),
                               jnp.asarray(ib), jnp.asarray(ih),
                               jnp.asarray(iw), n_frames, H, W)
    at, ft = TL.frame_avg_loss(t(loss), t(valid), t(ib), t(ih), t(iw),
                               n_frames, H, W)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
    blk = (5 // (H // 8)) * 8 + 7 // (W // 8)
    m = valid[:10]
    same = (ib == 0) & ((ih // (H // 8)) * 8 + iw // (W // 8) == blk) & valid
    np.testing.assert_allclose(at[0].reshape(-1)[blk].item(),
                               loss[same].sum() / same.sum(), rtol=1e-6)
    assert m.sum() > 1


# -------------------------------------------------------------- window

@pytest.mark.parametrize("count,tail", [(3, False), (12, False), (12, True),
                                        (40, False)])
def test_select_window_matches_given_the_same_gumbel(count, tail):
    C, Wn = 40, 5
    losses = np.random.default_rng(6).random(C).astype(np.float32)
    key = jax.random.PRNGKey(count)
    ij, vj = j_select_window(key, jnp.int32(count), jnp.asarray(losses), Wn,
                             tail=jnp.bool_(tail))
    g = t(jax.random.gumbel(key, (C,)))
    it, vt = t_select_window(None, count, t(losses), Wn, tail=tail, g=g)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


# --------------------------------------------------------------- AdamW

def test_fused_adamw_matches_jax_over_steps():
    """Three steps with lr_scale changes; rtol 1e-5 (float32 elementwise
    in another order: the moments differ by an ulp or two)."""
    import optax
    rng = np.random.default_rng(7)
    p = {"Wp": rng.normal(size=(3, 8, 4)).astype(np.float32),
         "bp": rng.normal(size=(3, 4)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p.items()} for _ in range(3)]
    upd_j = j_adamw(1.3e-3, 0.012)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    sj = optax.adamw(1.3e-3, weight_decay=0.012).init(pj)
    upd_t = TA.make_fused_adamw(1.3e-3, 0.012)
    pt = {k: t(v).clone() for k, v in p.items()}
    st_ = TA.init_state(pt)
    for g, s in zip(grads, (1.0, 0.5, 0.2)):
        pj, sj = upd_j(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj, s)
        upd_t(pt, {k: t(v) for k, v in g.items()}, st_, s)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(st_["mu"][k].numpy(),
                                   np.asarray(sj[0].mu[k]), rtol=1e-5)
        np.testing.assert_allclose(st_["nu"][k].numpy(),
                                   np.asarray(sj[0].nu[k]), rtol=1e-5)
    assert st_["count"] == int(sj[0].count)


# -------------------------------------------------------------- render

def test_render_matches_jax():
    rng = np.random.default_rng(8)
    z = rng.uniform(0.1, 3.0, (50, 12)).astype(np.float32)
    sdf = rng.normal(0.2, 0.3, (50, 12)).astype(np.float32)
    sdf[:5] = np.abs(sdf[:5])  # no crossing
    zj, sj = JR.sort_by_z(jnp.asarray(z), jnp.asarray(sdf))
    zt, st_ = TR.sort_by_z(t(z), t(sdf))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(st_.numpy(), np.asarray(sj))
    np.testing.assert_allclose(TR.sdf_render_depth(zt, st_).numpy(),
                               np.asarray(JR.sdf_render_depth(zj, sj)),
                               atol=1e-6)


# ------------------------------------------------------------- geometry

def test_geometry_matches_jax():
    """ray dirs, backprojection and normals (NaN where JAX has NaN);
    atol 1e-5."""
    H, W = 24, 32
    dj = JG.ray_dirs_C(H, W, 30.0, 30.0, 15.5, 11.5)
    dt = TG.ray_dirs_C(H, W, 30.0, 30.0, 15.5, 11.5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    yy, xx = np.mgrid[0:H, 0:W]
    depth = (2.0 + 0.02 * xx + 0.01 * yy
             + 0.1 * np.sin(xx / 4.0)).astype(np.float32)
    depth[3:6, 4:9] = np.nan
    pj = JG.pointcloud_from_depth(jnp.asarray(depth), 30.0, 30.0, 15.5, 11.5)
    pt = TG.pointcloud_from_depth(t(depth), 30.0, 30.0, 15.5, 11.5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    nj = np.asarray(JG.estimate_pointcloud_normals(pj))
    nt = TG.estimate_pointcloud_normals(pt).numpy()
    np.testing.assert_array_equal(np.isnan(nt), np.isnan(nj))
    ok = ~np.isnan(nj)
    np.testing.assert_allclose(nt[ok], nj[ok], atol=1e-5)
    T = _poses(6)
    o_j, d_j = JG.origin_dirs_W(jnp.asarray(T), dj[:6, 0])
    o_t, d_t = TG.origin_dirs_W(t(T), dt[:6, 0])
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j))


# --------------------------------------------------------------- arena

def test_buffer_add_replace_evict_matches_jax():
    C, H, W = 4, 6, 8
    rng = np.random.default_rng(9)
    bj = JB.make_buffer(C, H, W)
    bt = TB.make_buffer(C, H, W)
    for i, rep in enumerate([False, False, True, False, False]):
        d = rng.random((H, W)).astype(np.float32)
        T = _poses(1, seed=i)[0]
        n = rng.random((H, W, 3)).astype(np.float32)
        if not rep and bt.count >= C:
            bj = JB.evict_lowest_priority(bj)
            bt = TB.evict_lowest_priority(bt)
        bj = JB.add_frame(bj, jnp.asarray(d), jnp.asarray(T), jnp.asarray(n),
                          i, rep)
        bt = TB.add_frame(bt, t(d), t(T), t(n), i, rep)
        prio = rng.random(C).astype(np.float32)
        bj = bj._replace(frame_avg_loss=jnp.asarray(prio))
        bt.frame_avg_loss.copy_(t(prio))
    assert bt.count == int(bj.count)
    for f in ("depth", "T_WC", "normals", "frame_avg_loss", "frame_id"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)))
