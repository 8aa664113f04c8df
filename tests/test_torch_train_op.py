"""The port's fused train op against isdf_tpu's Pallas train kernel.

On the CPU the port's op runs its plain version (models/cuda_mlp.py::
train_op_plain, hidden products in float32 for a model built with
mm_precision="highest") and the JAX op
runs its Pallas kernel in interpret mode with force_f32 — the pattern of
tests/test_pallas_kernels.py. Same weights (params_from_jax), same inputs
(numpy, from a seed). Tolerances: sums rtol 2e-5 + atol 1e-5, per-point
loss atol 2e-5, gradients atol 5e-5 + rtol 2e-3 — the ones the JAX
package holds its own kernel variants to.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and, at full size, chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.models.pallas_mlp import make_pallas_train_op
from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models import sdf_mlp as TM

KW = dict(loss_type="L1", trunc_distance=0.1, trunc_weight=5.3,
          eik_apply_dist=0.1, eik_weight=0.268, grad_weight=0.018,
          orien_loss=False)
N_BLOCKS = 1


def _transform():
    import scipy.spatial.transform as st
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = st.Rotation.from_euler("xyz", [0.3, -0.2, 1.1]).as_matrix()
    T[:3, 3] = [0.4, -0.2, 0.9]
    return T


def _batch(R=28, S=10, seed=9, ties=False):
    """Rays from the origin through a wall at z~2, surface sample first.
    ``ties``: integer geometry where pairs of surface points lie at exactly
    the same score from many sample points."""
    rng = np.random.default_rng(seed)
    if ties:
        # surface points in +-pairs about the origin on the axes; sample
        # points on the orthogonal axes -> exactly equal scores
        base = np.array([[2, 0, 0], [-2, 0, 0], [0, 2, 0], [0, -2, 0],
                         [0, 0, 2], [0, 0, -2]], np.float32)
        surf = np.concatenate([base, base * 1.5], 0)[:R]
        surf = np.resize(surf, (R, 3)).astype(np.float32)
        z_vals = np.tile(np.arange(S, dtype=np.float32) * 0.25, (R, 1))
        z_vals[:, 0] = 0.0
        axis = np.zeros((R, 3), np.float32)
        axis[np.arange(R), rng.integers(0, 3, R)] = 1.0
        pc = axis[:, None] * z_vals[..., None]
        pc[:, 0] = surf
        depth = np.full(R, 1.0, np.float32)
    else:
        depth = rng.uniform(1.5, 2.5, R).astype(np.float32)
        z_vals = np.sort(rng.uniform(0.1, 2.7, (R, S)).astype(np.float32), 1)
        z_vals[:, 0] = depth
        dirs = rng.normal(size=(R, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pc = dirs[:, None, :] * z_vals[..., None]
    valid = rng.random(R) > 0.2
    normals = rng.normal(size=(R, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    N = R * S
    return dict(
        R=R, S=S, pc=pc, z_vals=z_vals, depth=depth, valid=valid,
        normals=normals,
        flat=pc.reshape(N, 3).astype(np.float32),
        surf=pc[:, 0].astype(np.float32).copy(),
        zd=(z_vals - depth[:, None]).reshape(N).astype(np.float32),
        normals_pt=np.repeat(normals, S, 0),
        is_surf=np.tile(np.eye(1, S, dtype=np.float32)[0], R),
        vflat=np.repeat(valid, S).astype(np.float32),
        noise=rng.normal(0, 0.03, N).astype(np.float32),
        bounds=rng.normal(0.1, 0.4, N).astype(np.float32),
        gt=rng.normal(size=(N, 3)).astype(np.float32),
        invC=np.float32(1.0 / max(float(S * valid.sum()), 1.0)))


def _models():
    jm = JM.SDFModel(hidden_layers_block=N_BLOCKS)
    tm = TM.SDFModel(hidden_layers_block=N_BLOCKS, mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(8), jm)
    return jm, tm, pj, TM.params_from_jax(pj, tm)


def _run_both(pc_bounds, b, **knobs):
    jm, tm, pj, pt = _models()
    T = _transform()
    kw = dict(KW, **knobs)
    op_j = make_pallas_train_op(jm, N_BLOCKS, **kw, interpret=True,
                                force_f32=True, pe_in_kernel=True,
                                pc_bounds=pc_bounds)
    op_t = K.make_train_op(tm, **kw, pc_bounds=pc_bounds)
    t = {k: torch.as_tensor(v) for k, v in b.items()
         if isinstance(v, np.ndarray)}
    invC = torch.tensor(float(b["invC"]))
    if pc_bounds:
        sj, lj, gj = op_j(pj, jnp.asarray(T), jnp.asarray(b["flat"]),
                          jnp.asarray(b["surf"]),
                          jnp.asarray(b["valid"].astype(np.float32)),
                          jnp.asarray(b["zd"]), jnp.asarray(b["normals_pt"]),
                          jnp.asarray(b["is_surf"]), jnp.asarray(b["vflat"]),
                          jnp.asarray(b["noise"]), jnp.float32(b["invC"]))
        st_, lt, gt = op_t(pt, torch.as_tensor(T), t["flat"], t["surf"],
                           torch.as_tensor(b["valid"].astype(np.float32)),
                           t["zd"], t["normals_pt"], t["is_surf"], t["vflat"],
                           t["noise"], invC)
    else:
        sj, lj, gj = op_j(pj, jnp.asarray(T), jnp.asarray(b["flat"]),
                          jnp.asarray(b["bounds"]), jnp.asarray(b["vflat"]),
                          jnp.asarray(b["noise"]), jnp.asarray(b["gt"]),
                          jnp.float32(b["invC"]))
        st_, lt, gt = op_t(pt, torch.as_tensor(T), t["flat"], t["bounds"],
                           t["vflat"], t["noise"], t["gt"], invC)
    return (np.asarray(sj), np.asarray(lj), gj), (st_, lt, gt), tm


def _assert_close(j, t, tm):
    (sj, lj, gj), (st_, lt, gt) = j, t
    np.testing.assert_allclose(st_.numpy(), sj, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), lj, atol=2e-5)
    g_tree = TM.params_to_jax({"Wp": gt[0], "bp": gt[1]}, tm)
    for a, b in zip(jax.tree_util.tree_leaves(g_tree),
                    jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=2e-3)


@pytest.mark.parametrize("variant,loss_type,orien", [
    ("pc", "L1", False), ("ray", "L1", False), ("pc", "L2", False),
    ("ray", "L2", True)])
def test_train_op_matches_pallas_kernel(variant, loss_type, orien):
    b = _batch()
    j, t, tm = _run_both(variant == "pc", b, loss_type=loss_type,
                         orien_loss=orien)
    _assert_close(j, t, tm)
    assert set(K.LAUNCHES) >= {"K1-pc", "K1-ray", "K1-stream"}
    assert all(v == 0 for v in K.LAUNCHES.values())  # CPU: no kernel


def test_train_op_pc_with_surface_point_ties():
    """Exactly tied scores: both take the first index; the bound (the
    chosen point's distance) and everything downstream agree."""
    b = _batch(R=24, S=8, ties=True)
    j, t, tm = _run_both(True, b)
    _assert_close(j, t, tm)


def test_padding_of_gradient_planes_is_exactly_zero():
    b = _batch()
    _, (_, _, (dW, db)), tm = _run_both(True, b)
    E, H, K_ = tm.embedding_size, tm.hidden_size, tm.pack_rows
    assert torch.all(dW[0, E:] == 0) and torch.all(dW[1, H:] == 0)
    assert torch.all(dW[tm.cat_idx, K_ + E:] == 0)
    assert torch.all(dW[-1, :, 1:] == 0) and torch.all(db[-1, 1:] == 0)


def test_bf16_plain_version_stays_near_f32():
    """mm_dtype=bf16 (the kernel's precision) moves the loss sums by well
    under 1%."""
    jm, tm32, pj, pt = _models()
    tm16 = TM.SDFModel(hidden_layers_block=N_BLOCKS)
    b = _batch()
    op32 = K.make_train_op(tm32, **KW, pc_bounds=True)
    op16 = K.make_train_op(tm16, **KW, pc_bounds=True)
    args = (pt, torch.as_tensor(_transform()), torch.as_tensor(b["flat"]),
            torch.as_tensor(b["surf"]),
            torch.as_tensor(b["valid"].astype(np.float32)),
            torch.as_tensor(b["zd"]), torch.as_tensor(b["normals_pt"]),
            torch.as_tensor(b["is_surf"]), torch.as_tensor(b["vflat"]),
            torch.as_tensor(b["noise"]), torch.tensor(float(b["invC"])))
    s32, _, _ = op32(*args)
    s16, _, _ = op16(*args)
    np.testing.assert_allclose(s16.numpy(), s32.numpy(), rtol=1e-2)
