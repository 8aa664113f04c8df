"""The port's streamed-PE train op, its bounds and K4 against isdf_tpu's on
the CPU.

* sdf_mlp._pe_factored: atol 1e-6 (float32 round-off of the same ops).
* bounds_normal and compute_bounds("normal"): atol 1e-5 on bounds and
  gradient targets, as tests/test_torch_ops.py holds the other methods.
* K4's plain version against isdf_tpu's closest_surface_ix kernel in
  interpret mode: exact indices, as tests/test_pallas_kernels.py requires
  of that kernel; exactly tied scores and an all-invalid surface set take
  the first index (0) on both sides; a budgeted surface subset and the
  strided view pc[:, 0] give the same indices.
* bounds_pc with the kernel flag against isdf_tpu's pallas_mode="interpret":
  atol 1e-5.
* K1-stream's plain version (models/cuda_mlp.py, pe streamed in) against
  make_pallas_train_op(pe_in_kernel=False) in interpret mode with
  force_f32, at the tolerances tests/test_torch_train_op.py holds K1-ray
  to: sums rtol 2e-5 + atol 1e-5, per-point loss atol 2e-5, gradients
  atol 5e-5 + rtol 2e-3; its gradient is exactly zero in the padding.
* The step's fused path with pe_in_kernel=False and use_pallas=True on one
  batch against the same composition of isdf_tpu functions (its streamed
  train op in interpret mode, its pc bounds with the K4 kernel in interpret
  mode, AdamW): loss scalars rtol 2e-5, gradient atol 5e-5 + rtol 2e-3,
  updated weights atol 1e-6 where |grad| > 1e-5.
* A paired run of both Trainers with pe_in_kernel=false and
  use_pallas=true, as tests/test_torch_slice.py does for the shipped config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.models.fused_adamw import make_fused_adamw
from isdf_tpu.models.pallas_mlp import make_pallas_train_op, pack_params_train
from isdf_tpu.ops import bounds as JBo
from isdf_tpu.ops.pallas.bounds_pc import closest_surface_ix
from isdf_tpu.utils.config import Config as JConfig
from isdf_tpu_torch.engine.step import StepFunctions
from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models import fused_adamw as TA
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import bounds as TBo
from isdf_tpu_torch.ops import cuda_bounds as CB
from isdf_tpu_torch.utils.config import Config as TConfig

KW = dict(loss_type="L1", trunc_distance=0.1, trunc_weight=5.3,
          eik_apply_dist=0.1, eik_weight=0.268, grad_weight=0.018,
          orien_loss=False)


def t(x):
    return torch.as_tensor(np.array(x))


def _transform():
    import scipy.spatial.transform as st
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = st.Rotation.from_euler("xyz", [0.3, -0.2, 1.1]).as_matrix()
    T[:3, 3] = [0.4, -0.2, 0.9]
    return T


# -------------------------------------------------------------------- PE

@pytest.mark.parametrize("with_transform", [True, False])
def test_pe_factored_matches_jax(with_transform):
    x = (np.random.default_rng(0).normal(size=(500, 3)) * 3).astype(
        np.float32)
    T = _transform() if with_transform else None
    want = JM._pe_factored(jnp.asarray(x), JM.SDFModel(),
                           None if T is None else jnp.asarray(T))
    got = TM._pe_factored(t(x), TM.SDFModel(), None if T is None else t(T))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------- bounds

def _rays(R=40, S=7, seed=1):
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(R, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.5, 3.0, (R, S)).astype(np.float32), axis=1)
    depth = z[:, 0] + rng.uniform(0, 0.5, R).astype(np.float32)
    pc = origins[:, None] + dirs[:, None] * z[..., None]
    normals = rng.normal(size=(R, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pc, z, depth, dirs, rng.random(R) > 0.2, normals


def test_bounds_normal_matches_jax():
    pc, z, depth, dirs, valid, normals = _rays()
    dirs_W = dirs * 1.3
    a = JBo.bounds_normal(jnp.asarray(depth), jnp.asarray(z),
                          jnp.asarray(dirs), jnp.asarray(normals), 0.3,
                          jnp.asarray(dirs_W))
    b = TBo.bounds_normal(t(depth), t(z), t(dirs), t(normals), 0.3,
                          t(dirs_W))
    np.testing.assert_allclose(b.bounds.numpy(), np.asarray(a.bounds),
                               atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad), atol=1e-5)
    c = TBo.compute_bounds("normal", t(dirs), t(depth), t(dirs_W), t(z),
                           t(pc), 0.3, t(normals), t(valid), do_grad=False)
    d = JBo.compute_bounds("normal", jnp.asarray(dirs), jnp.asarray(depth),
                           jnp.asarray(dirs_W), jnp.asarray(z),
                           jnp.asarray(pc), 0.3, jnp.asarray(normals),
                           jnp.asarray(valid), do_grad=False)
    np.testing.assert_allclose(c.bounds.numpy(), np.asarray(d.bounds),
                               atol=1e-5)
    assert c.grad is None and d.grad is None


def _surface_case(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        pts = rng.normal(size=(700, 3)).astype(np.float32) * 2.0
        surf = rng.normal(size=(90, 3)).astype(np.float32) * 2.0
        valid = np.ones(90, bool)
        valid[10:20] = False
    elif kind == "ties":
        # surface points in +-pairs on the axes, sample points on the
        # orthogonal axes: exactly equal scores within each pair
        base = np.array([[2, 0, 0], [-2, 0, 0], [0, 2, 0], [0, -2, 0],
                         [0, 0, 2], [0, 0, -2]], np.float32)
        surf = np.concatenate([base, base * 1.5], 0)
        axis = np.zeros((60, 3), np.float32)
        axis[np.arange(60), rng.integers(0, 3, 60)] = 1.0
        pts = axis * rng.integers(0, 5, (60, 1)).astype(np.float32) * 0.25
        valid = np.ones(12, bool)
        valid[[0, 7]] = False
    elif kind == "budget":
        # a budgeted surface set as StepFunctions.surf_set draws it: valid
        # points first, then at random, 64 of 150 surface samples
        pc = rng.normal(size=(150, 5, 3)).astype(np.float32) * 1.5
        ray_valid = rng.random(150) > 0.3
        sel = np.argsort(-(ray_valid * 2.0 + rng.random(150)),
                         kind="stable")[:64]
        pts, surf, valid = pc.reshape(-1, 3), pc[sel, 0], ray_valid[sel]
    elif kind == "strided":
        # the trainer's surface set: the strided view pc[:, 0], no copy
        pc = rng.normal(size=(120, 9, 3)).astype(np.float32) * 1.5
        valid = rng.random(120) > 0.2
        surf_t = t(pc)[:, 0]
        assert not surf_t.is_contiguous()
        return pc.reshape(-1, 3), pc[:, 0], valid, surf_t
    else:  # no valid surface point: every score +inf
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        surf = rng.normal(size=(9, 3)).astype(np.float32)
        valid = np.zeros(9, bool)
    return pts, surf, valid, t(surf)


@pytest.mark.parametrize("kind", ["random", "ties", "none_valid", "budget",
                                  "strided"])
def test_closest_surface_plain_matches_pallas_kernel(kind):
    pts, surf, valid, surf_t = _surface_case(kind)
    want = np.asarray(closest_surface_ix(jnp.asarray(pts), jnp.asarray(surf),
                                         jnp.asarray(valid), interpret=True))
    before = dict(CB.LAUNCHES)
    got = CB.closest_surface_ix(t(pts), surf_t, t(valid))
    assert CB.LAUNCHES == before  # CPU: the plain version, no launch
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "none_valid":
        assert not got.any()


def test_bounds_pc_kernel_flag_matches_jax_interpret():
    pc, z, depth, _, valid, _ = _rays()
    a = JBo.bounds_pc(jnp.asarray(pc), jnp.asarray(z), jnp.asarray(depth),
                      jnp.asarray(valid), do_grad=True,
                      pallas_mode="interpret")
    b = TBo.bounds_pc(t(pc), t(z), t(depth), t(valid), do_grad=True,
                      use_kernel=True)
    np.testing.assert_allclose(b.bounds.numpy(), np.asarray(a.bounds),
                               atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad), atol=1e-5)
    np.testing.assert_array_equal(b.grad_valid.numpy(),
                                  np.asarray(a.grad_valid))


# ------------------------------------------------------- K1-stream

def _stream_batch(N=280, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 3)).astype(np.float32) * 1.5
    return dict(
        x=x, bounds=rng.normal(0.1, 0.4, N).astype(np.float32),
        valid=(rng.random(N) > 0.2).astype(np.float32),
        noise=rng.normal(0, 0.03, N).astype(np.float32),
        gt=rng.normal(size=(N, 3)).astype(np.float32))


def _run_stream(**knobs):
    jm = JM.SDFModel(hidden_layers_block=1)
    tm = TM.SDFModel(hidden_layers_block=1, mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(8), jm)
    pt = TM.params_from_jax(pj, tm)
    b = _stream_batch()
    kw = dict(KW, **knobs)
    pe, _, dxs, dproj2 = JM._pe_factored(jnp.asarray(b["x"]), jm,
                                         jnp.asarray(_transform()))
    invC = np.float32(1.0 / b["valid"].sum())
    op_j = make_pallas_train_op(jm, 1, **kw, interpret=True, force_f32=True,
                                pe_in_kernel=False)
    out_j = op_j(pj, pe, dxs, dproj2, jnp.asarray(b["bounds"]),
                 jnp.asarray(b["valid"]), jnp.asarray(b["noise"]),
                 jnp.asarray(b["gt"]), jnp.float32(invC))
    op_t = K.make_train_op(tm, **kw, pe_in_kernel=False)
    out_t = op_t(pt, t(pe), t(dxs), t(dproj2), t(b["bounds"]), t(b["valid"]),
                 t(b["noise"]), t(b["gt"]), torch.tensor(float(invC)))
    return out_j, out_t, tm


@pytest.mark.parametrize("loss_type,orien", [
    ("L1", False), ("L2", False), ("L2", True)])
def test_stream_train_op_matches_pallas_kernel(loss_type, orien):
    (sj, lj, gj), (st_, lt, gt), tm = _run_stream(loss_type=loss_type,
                                                  orien_loss=orien)
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5)
    g_tree = TM.params_to_jax({"Wp": gt[0], "bp": gt[1]}, tm)
    for a, b in zip(jax.tree_util.tree_leaves(g_tree),
                    jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=2e-3)
    assert K.LAUNCHES["K1-stream"] == 0  # CPU: the plain version


def test_stream_train_op_gradient_padding_is_exactly_zero():
    _, (_, _, (dW, db)), tm = _run_stream()
    E, H, K_ = tm.embedding_size, tm.hidden_size, tm.pack_rows
    assert torch.all(dW[0, E:] == 0) and torch.all(dW[1, H:] == 0)
    assert torch.all(dW[tm.cat_idx, K_ + E:] == 0)
    assert torch.all(dW[-1, :, 1:] == 0) and torch.all(db[-1, 1:] == 0)


# ------------------------------------------------- the step, one batch

def test_one_stream_step_matches_jax_composition():
    from test_torch_slice import _step_batch
    Wn, H, W, C = 5, 48, 64, 8
    knobs = dict(bounds_method="pc", hidden_layers_block=1, window_size=Wn,
                 mm_precision="highest", kf_buffer_size=C,
                 pe_in_kernel=False, use_pallas=True)
    cfg = TConfig().replace(**knobs)
    jcfg = JConfig().replace(**knobs)
    jm = JM.SDFModel(hidden_layers_block=1)
    tm = TM.SDFModel(hidden_layers_block=1, mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(11), jm)
    T = _transform()
    b = _step_batch(Wn=Wn, H=H, W=W)
    R, S = b["z"].shape
    N = R * S
    lr_scale = 0.7

    # ---- isdf_tpu: _pallas_loss_and_grad's streamed branch ----
    op = make_pallas_train_op(
        jm, 1, loss_type=jcfg.loss_type, trunc_distance=jcfg.trunc_distance,
        trunc_weight=jcfg.trunc_weight, eik_apply_dist=jcfg.eik_apply_dist,
        eik_weight=jcfg.eik_weight, grad_weight=jcfg.grad_weight,
        orien_loss=jcfg.orien_loss, interpret=True, force_f32=True,
        pe_in_kernel=False, packed_io=True)
    packed = pack_params_train(pj)
    pc = jnp.asarray(b["pc"])
    valid = jnp.asarray(b["valid"])
    normals = jnp.asarray(b["normals"])
    pe, _, dxs, dproj2 = JM._pe_factored(pc.reshape(N, 3), jm,
                                         jnp.asarray(T))
    bnd = JBo.compute_bounds(
        "pc", jnp.asarray(b["dirs_C"]), jnp.asarray(b["depth"]),
        jnp.asarray(b["dirs_W"]), jnp.asarray(b["z"]), pc,
        jcfg.trunc_distance, normals, valid, do_grad=True,
        pallas_mode="interpret", surf=pc[:, 0], surf_valid=valid)
    gv = jnp.where(bnd.grad_valid[..., None], bnd.grad, normals[:, None, :])
    gtj = jnp.concatenate([normals[:, None, :], gv], 1).reshape(N, 3)
    vflat = jnp.repeat(valid, S).astype(jnp.float32)
    invC = 1.0 / float(S * b["valid"].sum())
    sums, _, grads = op(packed, pe, dxs, dproj2, bnd.bounds.reshape(-1),
                        vflat, jnp.asarray(b["noise"]), gtj,
                        jnp.float32(invC))
    opt = optax.adamw(jcfg.lr, weight_decay=jcfg.weight_decay).init(packed)
    (Wp_j, bpt_j), _ = make_fused_adamw(jcfg.lr, jcfg.weight_decay)(
        packed, grads, opt, lr_scale)

    # ---- isdf_tpu_torch: the step's fused path ----
    fns = StepFunctions(cfg, tm, H, W, torch.zeros(H, W, 3), "cpu")
    assert fns.train_op is not None and not fns.pc_in_kernel
    pt = TM.params_from_jax(pj, tm)
    opt_t = TA.init_state(pt)
    tt = {k: torch.as_tensor(v) for k, v in b.items()}
    scalars, _, grads_t = fns.loss_and_grad(
        pt, torch.as_tensor(T), tt["pc"], tt["z"], tt["dirs_C"],
        tt["dirs_W"], tt["depth"], tt["normals"], tt["valid"], tt["noise"],
        surf=tt["pc"][:, 0], sv=tt["valid"])
    g_plane = grads_t[0].clone()
    fns.adamw(pt, {"Wp": grads_t[0], "bp": grads_t[1]}, opt_t, lr_scale)

    np.testing.assert_allclose(float(scalars["total_loss"]),
                               float(sums[0]) * invC, rtol=2e-5)
    np.testing.assert_allclose(float(scalars["grad_loss"]),
                               float(sums[2]) * invC, rtol=2e-5)
    np.testing.assert_allclose(g_plane.numpy(), np.asarray(grads[0]),
                               atol=5e-5, rtol=2e-3)
    sure = np.abs(np.asarray(grads[0])) > 1e-5
    np.testing.assert_allclose(pt["Wp"].numpy()[sure],
                               np.asarray(Wp_j)[sure], atol=1e-6)
    np.testing.assert_allclose(pt["bp"].numpy().reshape(-1),
                               np.asarray(bpt_j)[0], atol=1e-6)


def test_paired_trainers_stream_pe_with_k4():
    from test_torch_slice import run_paired_trainers
    tt = run_paired_trainers(dict(pe_in_kernel=False, use_pallas=True),
                             steps=160)
    assert tt.fns.train_op is not None and not tt.fns.pc_in_kernel
