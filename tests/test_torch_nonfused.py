"""The port's non-fused training step against isdf_tpu's on the CPU.

* The reverse-fused op (models/fused_vjp.py): its forward and its
  parameter gradient against isdf_tpu's make_reverse_fused_mlp (plain jnp)
  and make_pallas_reverse_fused (the Pallas kernels K2/K3 in interpret mode,
  float32), at the JAX package's own limits (tests/test_pallas_kernels.py):
  raw atol 2e-5 + rtol 1e-5, graw atol 2e-5 + rtol 1e-4, loss rtol 1e-5,
  gradients atol 3e-5 + rtol 1e-3. Same weights (params_from_jax), same
  factored PE.
* Its gradient is exactly zero in the packed planes' padding, so AdamW on
  the planes keeps the padding at zero.
* On CPU tensors the K2/K3 wrapper runs this plain op and launches nothing.
* One step of the non-fused step (grad_mode reverse_fused, auto, and the
  plain forward with the spatial-gradient losses off) against isdf_tpu's
  build_step_functions train_bundle on the same batch: both packages get
  the same arena, weights and random draws (the JAX step's own keys,
  replayed). Loss scalars rtol 2e-5; the gradient against isdf_tpu's
  _ray_batch_loss composed from its public functions, atol 1e-5 + rtol
  2e-3; updated weights atol 1e-6 where |grad| > 1e-5 (AdamW's first step
  moves each weight by lr * g / (|g| + 1e-8)); arena priorities rtol 1e-5.
* A paired run of both Trainers with grad_mode=reverse_fused and
  use_pallas=true, as tests/test_torch_slice.py does for the fused path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.engine import buffer as JB
from isdf_tpu.engine.step import build_step_functions
from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.models.fused_vjp import make_reverse_fused_mlp as j_rf
from isdf_tpu.models.pallas_mlp import make_pallas_reverse_fused
from isdf_tpu.ops import bounds as JBo
from isdf_tpu.ops import losses as JL
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.engine import buffer as TB
from isdf_tpu_torch.engine.step import StepFunctions, select_window
from isdf_tpu_torch.models import cuda_reverse_fused as CRF
from isdf_tpu_torch.models import fused_adamw as TA
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp as t_rf
from isdf_tpu_torch.ops import sampling as TS
from isdf_tpu_torch.utils.config import Config as TConfig


def _transform():
    import scipy.spatial.transform as st
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = st.Rotation.from_euler("xyz", [0.3, -0.2, 1.1]).as_matrix()
    T[:3, 3] = [0.4, -0.2, 0.9]
    return T


def _tensors(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _grad_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _rf_setup(n=300, seed=0):
    """Full width (the kernels' 256), one block: the factored PE of n
    points from numpy, weights from JAX."""
    jm = JM.SDFModel(hidden_layers_block=1)
    tm = TM.SDFModel(hidden_layers_block=1, mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(seed), jm)
    x = np.random.default_rng(seed + 1).normal(size=(n, 3)).astype(
        np.float32) * 1.5
    args_j = JM._pe_factored(jnp.asarray(x), jm, jnp.asarray(_transform()))
    return jm, tm, pj, TM.params_from_jax(pj, tm), args_j


def _j_op(kind, jm):
    if kind == "jnp":
        return j_rf(jm, 1)
    return make_pallas_reverse_fused(jm, 1, interpret=True, force_f32=True)


@pytest.mark.parametrize("oracle", ["jnp", "pallas_interpret"])
def test_reverse_fused_forward_matches_jax(oracle):
    jm, tm, pj, pt, args_j = _rf_setup()
    raw_j, graw_j = _j_op(oracle, jm)(pj, *args_j)
    raw_t, graw_t = t_rf(tm)(pt, *_tensors(*args_j))
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(graw_t.numpy(), np.asarray(graw_j),
                               atol=2e-5, rtol=1e-4)


def _test_loss(raw, graw, xp):
    eik = xp.abs(xp.linalg.norm(graw, axis=-1) - 1.0).mean()
    gsum = (graw * xp.asarray([0.2, -0.5, 1.0])).sum(-1).mean()
    return xp.abs(raw).mean() + 0.3 * eik + 0.1 * gsum


@pytest.mark.parametrize("oracle", ["jnp", "pallas_interpret"])
def test_reverse_fused_param_grad_matches_jax(oracle):
    jm, tm, pj, pt, args_j = _rf_setup(seed=3)
    op_j = _j_op(oracle, jm)
    l_j, g_j = jax.value_and_grad(
        lambda p: _test_loss(*op_j(p, *args_j), jnp))(pj)
    p = {k: v.requires_grad_(True) for k, v in pt.items()}
    loss = _test_loss(*t_rf(tm)(p, *_tensors(*args_j)), torch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5)
    g_t = TM.params_to_jax({"Wp": p["Wp"].grad, "bp": p["bp"].grad}, tm)
    for a, b in zip(_grad_leaves(g_t), _grad_leaves(g_j)):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=1e-3)


def test_reverse_fused_gradient_is_exactly_zero_in_the_padding():
    """A narrow model with E < K so every kind of padding exists: layer 0's
    rows past E, the hidden layers' rows past H, the skip layer's rows past
    K + E, the output layer's columns past 0 and its bias past 0."""
    tm = TM.SDFModel(hidden_size=48, hidden_layers_block=1, max_deg=2,
                     embedding_size=129)
    pt = TM.init_params(torch.Generator().manual_seed(0), tm)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(50, 3)),
                        dtype=torch.float32)
    p = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    raw, graw = t_rf(tm)(p, *TM._pe_factored(x, tm, None))
    _test_loss(raw, graw, torch).backward()
    dW, db = p["Wp"].grad, p["bp"].grad
    E, H, K, c = tm.embedding_size, tm.hidden_size, tm.pack_rows, tm.cat_idx
    assert torch.all(dW[0, E:] == 0) and torch.all(dW[1:, H:K] == 0)
    assert torch.all(dW[c, K + E:] == 0)
    assert torch.all(dW[[l for l in range(tm.n_layers) if l != c], K:] == 0)
    assert torch.all(dW[-1, :, 1:] == 0) and torch.all(db[-1, 1:] == 0)
    assert dW[c, K:K + E].abs().max() > 0 and dW[-1, :H, 0].abs().max() > 0
    # one AdamW step on the planes leaves the padding at zero
    state = TA.init_state(pt)
    TA.make_fused_adamw(1e-3, 0.012)(pt, {"Wp": dW, "bp": db}, state)
    assert torch.all(pt["Wp"][0, E:] == 0) and torch.all(pt["bp"][-1, 1:] == 0)


def test_cuda_reverse_fused_runs_the_plain_op_on_cpu():
    jm, tm, pj, pt, args_j = _rf_setup(n=40)
    before = dict(CRF.LAUNCHES)
    args = _tensors(*args_j)
    raw_k, graw_k = CRF.make_cuda_reverse_fused(tm)(pt, *args)
    raw_p, graw_p = t_rf(tm)(pt, *args)
    assert torch.equal(raw_k, raw_p) and torch.equal(graw_k, graw_p)
    assert CRF.LAUNCHES == before
    assert all(v == 0 for v in CRF.LAUNCHES.values())


# ------------------------------------------------------------ one step

Wn, N_RAYS, H, W, C = 5, 8, 24, 32, 6


def _cfg(cfg_cls, **kw):
    return cfg_cls().replace(
        hidden_feature_size=64, hidden_layers_block=1, n_embed_funcs=3,
        window_size=Wn, n_rays=N_RAYS, n_strat_samples=6, n_surf_samples=3,
        kf_buffer_size=C, do_active=False, mm_precision="highest", **kw)


def _model(cfg, mod):
    return mod.SDFModel(
        embedding_size=cfg.embedding_size,
        hidden_size=cfg.hidden_feature_size,
        hidden_layers_block=cfg.hidden_layers_block,
        scale_output=cfg.scale_output, scale_input=cfg.scale_input,
        min_deg=0, max_deg=cfg.n_embed_funcs, gauss_embed=cfg.gauss_embed,
        gauss_embed_std=cfg.gauss_embed_std, mm_precision=cfg.mm_precision)


def _arena(bj, bt, seed=4, count=3):
    import scipy.spatial.transform as st
    rng = np.random.default_rng(seed)
    for i in range(count):
        d = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
        d[rng.random((H, W)) < 0.1] = 0.0
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = st.Rotation.from_rotvec(rng.normal(size=3) * 0.3
                                            ).as_matrix()
        T[:3, 3] = rng.normal(size=3) * 0.2
        n = rng.normal(size=(H, W, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        n[rng.random((H, W)) < 0.05] = np.nan
        bj = JB.add_frame(bj, jnp.asarray(d), jnp.asarray(T), jnp.asarray(n),
                          i, False)
        TB.add_frame(bt, *_tensors(d, T, n), i, False)
    prio = rng.random(C).astype(np.float32)
    bj = bj._replace(frame_avg_loss=jnp.asarray(prio))
    bt.frame_avg_loss.copy_(torch.as_tensor(prio))
    return bj, bt


def _j_ray_batch_loss(cfg, jm, p, T, noise, b):
    """isdf_tpu's _ray_batch_loss (step.py:187-262) from its public
    functions, for the gradient the step takes."""
    pc = b["pc"]
    do_grad = cfg.eik_weight != 0 or cfg.grad_weight != 0
    if cfg.grad_mode == "reverse_fused":
        R_, S_, _ = pc.shape
        raw, graw = j_rf(jm, 1)(p, *JM._pe_factored(pc.reshape(-1, 3), jm, T))
        sdf = raw.reshape(R_, S_) * jm.scale_output
        g = graw.reshape(R_, S_, 3) * jm.scale_output
    else:
        sdf = JM.apply(p, pc, jm, transform=T)
        g = jax.grad(lambda x: JM.apply(p, x, jm, transform=T).sum())(pc) \
            if do_grad else None
    sdf = sdf + noise * jm.scale_output
    bnd = JBo.compute_bounds(cfg.bounds_method, b["dirs_C"], b["depth"],
                             b["dirs_W"], b["z"], pc, cfg.trunc_distance,
                             b["normals"], b["valid"],
                             do_grad=cfg.grad_weight != 0)
    mat, fs = JL.sdf_loss(sdf, bnd.bounds, cfg.trunc_distance, cfg.loss_type)
    eik = (jnp.abs(jnp.linalg.norm(g, axis=-1) - 1.0)
           if cfg.eik_weight != 0 else None)
    gmat = (JL.grad_cosine_loss(g, bnd.grad, bnd.grad_valid, b["normals"],
                                cfg.orien_loss)
            if cfg.grad_weight != 0 else None)
    return JL.tot_loss(mat, gmat, eik, fs, bnd.bounds, b["valid"],
                       cfg.eik_apply_dist, cfg.trunc_weight,
                       cfg.grad_weight, cfg.eik_weight).total


@pytest.mark.parametrize("knobs", [
    dict(grad_mode="reverse_fused", bounds_method="pc", use_pallas=True),
    dict(grad_mode="auto", bounds_method="ray"),
    dict(grad_mode="pallas", bounds_method="normal", eik_weight=0.0,
         grad_weight=0.0),
    dict(grad_mode="pallas", bounds_method="ray", gauss_embed=True),
], ids=["reverse_fused-pc-K4", "auto-ray", "plain-forward-normal",
        "gauss_embed-autograd-ray"])
def test_one_nonfused_step_matches_jax_step(knobs):
    """The Gaussian embedding's case: isdf_tpu builds no fused op for it
    and takes autodiff through the MLP whatever the grad_mode (its
    step.py:146, 197); its matrix B is trained, gradient and AdamW step
    held like the planes'."""
    cfg_j, cfg_t = _cfg(JConfig, **knobs), _cfg(TConfig, **knobs)
    jm, tm = _model(cfg_j, JM), _model(cfg_t, TM)
    T = _transform()
    rng = np.random.default_rng(7)
    dirs = np.concatenate([rng.uniform(-0.5, 0.5, (H, W, 2)),
                           np.ones((H, W, 1))], -1).astype(np.float32)
    pj = JM.init_params(jax.random.PRNGKey(2), jm)
    bj, bt = _arena(JB.make_buffer(C, H, W), TB.make_buffer(C, H, W))
    key, noise_std, lr_scale = jax.random.PRNGKey(5), 0.1, 0.8

    # ---- the batch the JAX step draws, from its own keys ----
    k_sel, k_pix, k_ray, k_noise = jax.random.split(jax.random.fold_in(key,
                                                                       0), 4)
    kh, kw = jax.random.split(k_pix)
    R = Wn * N_RAYS
    S = cfg_t.n_strat_samples + cfg_t.n_surf_samples
    ih, iw = (jax.random.randint(kh, (R,), 0, H),
              jax.random.randint(kw, (R,), 0, W))
    k_strat, k_surf = jax.random.split(k_ray)
    draws = _tensors(jax.random.uniform(k_strat, (R, cfg_t.n_strat_samples)),
                     jax.random.normal(k_surf, (R, cfg_t.n_surf_samples - 1)))
    noise = jax.random.normal(k_noise, (R, S)) * noise_std

    # ---- isdf_tpu_torch: the step's own pieces on that batch ----
    fns = StepFunctions(cfg_t, tm, H, W, torch.as_tensor(dirs), "cpu")
    assert fns.train_op is None
    pt = TM.params_from_jax(pj, tm)
    opt_t = TA.init_state(pt)
    idxs, slot_valid = select_window(None, bt.count, bt.frame_avg_loss, Wn,
                                     g=torch.zeros(C))
    ib = torch.arange(Wn).repeat_interleave(N_RAYS)
    ih_t, iw_t = _tensors(ih, iw)
    gi = idxs[ib]
    depth = bt.depth[gi, ih_t, iw_t]
    valid = (depth != 0.0) & slot_valid[ib]
    normals = bt.normals[gi, ih_t, iw_t]
    valid &= ~torch.isnan(normals[..., 0])
    normals = torch.nan_to_num(normals)
    depth_safe = torch.where(valid, depth, 1.0)
    dirs_C = fns.dirs[ih_t, iw_t]
    pc, z, _, dirs_W = TS.sample_along_rays(
        None, bt.T_WC[gi], dirs_C, depth_safe, cfg_t.min_depth,
        cfg_t.dist_behind_surf, cfg_t.n_strat_samples, cfg_t.n_surf_samples,
        draws=draws)
    surf, sv = fns.surf_set(None, pc, valid)
    scalars, ploss, grads = fns.loss_and_grad(
        pt, torch.as_tensor(T), pc, z, dirs_C, dirs_W, depth_safe, normals,
        valid, torch.as_tensor(np.array(noise)).reshape(-1), surf=surf,
        sv=sv)
    g_plane = [g.clone() for g in grads]
    fns.update(pt, opt_t, bt, grads, ploss, idxs, slot_valid, ib, ih_t,
               iw_t, valid, lr_scale)

    # ---- isdf_tpu: its loss composition, then its whole step ----
    b = {k: jnp.asarray(v.numpy()) for k, v in dict(
        pc=pc, z=z, dirs_C=dirs_C, dirs_W=dirs_W, depth=depth_safe,
        normals=normals, valid=valid).items()}
    g_j = jax.grad(lambda p: _j_ray_batch_loss(
        cfg_j, jm, p, jnp.asarray(T), noise, b))(pj)
    fj = build_step_functions(cfg_j, jm, H, W, jnp.asarray(dirs))
    assert not fj.uses_pallas_kernel
    pj2, _, bj2, sc_j = fj.train_bundle(
        pj, fj.optimiser.init(pj), bj, fj.dirs, jnp.asarray(T), key,
        noise_std, n_steps=1, lr_scale=lr_scale)

    assert sorted(scalars) == sorted(sc_j)
    for k in scalars:
        np.testing.assert_allclose(float(scalars[k]), float(sc_j[k][0]),
                                   rtol=2e-5, atol=1e-9, err_msg=k)
    assert len(g_plane) == (3 if cfg_t.gauss_embed else 2)
    g_t = TM.params_to_jax(dict(zip(("Wp", "bp", "B"), g_plane)), tm)
    for a, gj in zip(_grad_leaves(g_t), _grad_leaves(g_j)):
        np.testing.assert_allclose(a, gj, atol=1e-5, rtol=2e-3)
    p_t = TM.params_to_jax(pt, tm)
    for a, pj_, gj in zip(_grad_leaves(p_t), _grad_leaves(pj2),
                          _grad_leaves(g_j)):
        sure = np.abs(gj) > 1e-5
        np.testing.assert_allclose(a[sure], pj_[sure], atol=1e-6)
    np.testing.assert_allclose(bt.frame_avg_loss.numpy(),
                               np.asarray(bj2.frame_avg_loss), rtol=1e-5)
    np.testing.assert_allclose(bt.loss_approx.numpy(),
                               np.asarray(bj2.loss_approx), rtol=1e-5,
                               atol=1e-7)


def test_paired_trainers_reverse_fused_with_k4():
    from test_torch_slice import run_paired_trainers
    run_paired_trainers(dict(grad_mode="reverse_fused", use_pallas=True),
                        steps=160)
