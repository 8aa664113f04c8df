"""The port's Gaussian random-Fourier-feature embedding against
isdf_tpu's on the CPU: the encoding, the model path, the parameter round
trip and a short trainer run. (One step with gauss_embed against
build_step_functions is a case of
tests/test_torch_nonfused.py::test_one_nonfused_step_matches_jax_step.)

Tolerances: the encoding and the SDF of the same weights within 2e-5
(float32 sin/cos of arguments up to ~1e2 with std-11 features).
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


def _T():
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.2, 0.1]
    return T


@pytest.mark.parametrize("with_transform", [False, True])
def test_gaussian_encoding_matches_jax(with_transform):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    B = (11.0 * rng.normal(size=(3, 126))).astype(np.float32)
    T = _T() if with_transform else None
    got = TE.gaussian_encoding(
        torch.as_tensor(x), torch.as_tensor(B),
        transform=None if T is None else torch.as_tensor(T),
        scale=0.05937489).numpy()
    want = np.asarray(JE.gaussian_encoding(
        jnp.asarray(x), jnp.asarray(B),
        transform=None if T is None else jnp.asarray(T), scale=0.05937489))
    assert got.shape == (50, 255)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_gaussian_matrix_init():
    B = TE.init_gaussian_embedding(torch.Generator().manual_seed(0), 11.0,
                                   126)
    assert B.shape == (3, 126) and B.dtype == torch.float32
    assert 9.0 < float(B.std()) < 13.0


def test_gauss_model_matches_jax_and_round_trips():
    kw = dict(hidden_size=32, hidden_layers_block=1, gauss_embed=True)
    jm = JM.SDFModel(**kw)
    tm = TM.SDFModel(**kw, mm_precision="highest")
    pj = JM.init_params(jax.random.PRNGKey(1), jm)
    pt = TM.params_from_jax(pj, tm)
    assert sorted(pt) == ["B", "Wp", "bp"]
    np.testing.assert_array_equal(pt["B"].numpy(), np.asarray(pj["B"]))
    back = TM.params_to_jax(pt, tm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(2)
    x = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    got = TM.apply(pt, torch.as_tensor(x), tm,
                   transform=torch.as_tensor(_T())).numpy()
    want = np.asarray(JM.apply(pj, jnp.asarray(x), jm,
                               transform=jnp.asarray(_T())))
    np.testing.assert_allclose(got, want, atol=2e-5)
    fresh = TM.init_params(torch.Generator().manual_seed(0), tm)
    assert fresh["B"].shape == (3, (tm.embedding_size - 3) // 2)


def test_gauss_trainer_trains_B_through_autograd():
    """A port Trainer with gauss_embed takes autograd (no fused op, no
    kernel source), and AdamW moves B."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from test_torch_slice import _small
    tr = Trainer(_small(TConfig).replace(gauss_embed=True), device="cpu")
    assert tr.fns.train_op is None and tr.fns.rf_op is None
    B0 = tr.params["B"].clone()
    tr.add_frame(tr.get_data([0])[0])
    out = tr.run_steps(3)
    assert np.isfinite(out["total_loss"]).all()
    assert not torch.equal(tr.params["B"], B0)
    assert tr.opt_state["count"] == 3
