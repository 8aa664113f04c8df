"""isdf_tpu_torch's encoder and MLP against isdf_tpu's on the CPU, float32.

Same weights (carried across by params_from_jax), same points (numpy, from
a seed). Tolerance: 2e-5 absolute, float32 round-off of two differently
ordered evaluations of the same expression.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.models import sdf_mlp as JM
from isdf_tpu.ops import embedding as JE
from isdf_tpu_torch.models import sdf_mlp as TM
from isdf_tpu_torch.ops import embedding as TE

ATOL = 2e-5


def _transform():
    import scipy.spatial.transform as st
    R = st.Rotation.from_euler("xyz", [0.3, -0.2, 1.1]).as_matrix()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = [0.4, -0.2, 0.9]
    return T


def _models(n_blocks=1, hidden=256):
    jm = JM.SDFModel(hidden_layers_block=n_blocks, hidden_size=hidden)
    tm = TM.SDFModel(hidden_layers_block=n_blocks, hidden_size=hidden)
    return jm, tm


def _points(n=300, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * 1.5
            ).astype(np.float32)


def test_positional_encoding_matches_jax():
    x, T = _points(), _transform()
    want = np.asarray(JE.positional_encoding(
        jnp.asarray(x), transform=jnp.asarray(T), scale=0.05937489,
        min_deg=0, max_deg=5))
    got = TE.positional_encoding(torch.as_tensor(x), torch.as_tensor(T),
                                 scale=0.05937489, min_deg=0, max_deg=5)
    assert got.shape == (300, 255)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("with_transform", [True, False])
def test_pe_consts_match_jax(with_transform):
    jm, tm = _models()
    T = _transform() if with_transform else None
    Mj, dxj, dpj = JM._pe_consts(jm, None if T is None else jnp.asarray(T))
    Mt, dxt, dpt = TM._pe_consts(tm, None if T is None else torch.as_tensor(T))
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=1e-6)
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), atol=1e-7)
    np.testing.assert_allclose(dpt.numpy(), np.asarray(dpj), atol=1e-5)


def test_params_round_trip_through_jax_pytree():
    jm, tm = _models(n_blocks=2)
    pj = JM.init_params(jax.random.PRNGKey(3), jm)
    pt = TM.params_from_jax(pj, tm)
    assert pt["Wp"].shape == (7, 512, 256) and pt["bp"].shape == (7, 256)
    back = TM.params_to_jax(pt, tm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_packed_layout_matches_jax_packed_planes():
    """At H=256 the port's planes are the JAX kernel's packed planes."""
    from isdf_tpu.models.pallas_mlp import pack_params_train
    jm, tm = _models(n_blocks=2)
    pj = JM.init_params(jax.random.PRNGKey(5), jm)
    Wp, bpt = pack_params_train(pj)
    pt = TM.params_from_jax(pj, tm)
    np.testing.assert_array_equal(pt["Wp"].numpy(), np.asarray(Wp))
    np.testing.assert_array_equal(pt["bp"].numpy().reshape(-1),
                                  np.asarray(bpt)[0])


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_apply_and_sdf_and_grad_match_jax(n_blocks):
    jm, tm = _models(n_blocks=n_blocks)
    pj = JM.init_params(jax.random.PRNGKey(1), jm)
    pt = TM.params_from_jax(pj, tm)
    x, T = _points(seed=2), _transform()
    sj, gj = JM.sdf_and_grad(pj, jnp.asarray(x), jm, transform=jnp.asarray(T))
    st_ = TM.apply(pt, torch.as_tensor(x), tm, transform=torch.as_tensor(T))
    s2, gt = TM.sdf_and_grad(pt, torch.as_tensor(x), tm,
                             transform=torch.as_tensor(T))
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj), atol=ATOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(sj), atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL)


def test_apply_with_noise_matches_jax_given_the_same_draws():
    jm, tm = _models()
    pj = JM.init_params(jax.random.PRNGKey(4), jm)
    pt = TM.params_from_jax(pj, tm)
    x = _points(n=50, seed=3)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (50,), jnp.float32))
    want = JM.apply_with_noise(pj, jnp.asarray(x), jm, key, 0.25)
    got = TM.apply_with_noise(pt, torch.as_tensor(x), tm, None, 0.25,
                              noise=torch.as_tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_init_params_layout_and_scale():
    tm = TM.SDFModel(hidden_layers_block=1, hidden_size=64,
                     embedding_size=213, max_deg=4)
    p = TM.init_params(torch.Generator().manual_seed(0), tm)
    K = tm.pack_rows
    assert p["Wp"].shape == (5, 2 * K, 64)
    # padding is exactly zero: in-layer rows beyond E, mid rows beyond H,
    # the output layer beyond column 0
    assert torch.all(p["Wp"][0, 213:] == 0)
    assert torch.all(p["Wp"][1, 64:] == 0)
    assert torch.all(p["Wp"][4, :, 1:] == 0)
    assert torch.all(p["bp"][4, 1:] == 0)
    w0 = p["Wp"][0, :213]
    assert abs(float(w0.std()) - (2.0 / (213 + 64)) ** 0.5) < 0.01
