"""The plain reference against float64 NumPy at a tiny size."""

import numpy as np
import pytest
import torch

from benchmark import inputs as I
from benchmark import reference as REF

CFG = {"model": {"embedding": {"n_embed_funcs": 2, "scale_input": 0.05937489},
                 "hidden_feature_size": 16, "hidden_layers_block": 1,
                 "scale_output": 0.14}}


def _numpy_sdf(layers, x, T, mp):
    """The map in float64 NumPy, from the paper's equations."""
    xs = (x @ T[:3, :3].T + T[:3, 3]) * mp.scale_input
    bands = 2.0 ** np.arange(mp.n_freqs)
    xb = ((xs @ REF.ICOSA.T.astype(np.float64))[..., None] * bands
          ).reshape(len(x), -1)
    pe = np.concatenate([xs, np.sin(xb), np.sin(xb + np.pi / 2)], axis=1)
    h = pe
    for i, (w, b) in enumerate(layers[:-1]):
        if i == mp.blocks + 1:
            h = np.concatenate([h, pe], axis=1)
        z = 100.0 * (h @ w + b)
        h = (np.maximum(z, 0) + np.log1p(np.exp(-np.abs(z)))) / 100.0
    w, b = layers[-1]
    return (h @ w + b)[:, 0] * mp.scale_output


def _setup():
    mp = REF.Map(CFG)
    layers = I.make_weights(5, mp.E, mp.H, mp.blocks, "cpu")
    T = np.eye(4)
    T[:3, 3] = [0.3, -0.2, 0.1]
    x = np.random.default_rng(0).uniform(-2, 2, (64, 3))
    return mp, layers, T, x


def test_reference_sdf_matches_float64():
    mp, layers, T, x = _setup()
    got = REF.sdf(layers, torch.as_tensor(x, dtype=torch.float32),
                  torch.as_tensor(T, dtype=torch.float32), mp).numpy()
    want = _numpy_sdf([(w.double().numpy(), b.double().numpy())
                       for w, b in layers], x, T, mp)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_reference_gradient_matches_float64_differences():
    mp, layers, T, x = _setup()
    _, g = REF.sdf_and_grad(
        [(w.double(), b.double()) for w, b in layers],
        torch.as_tensor(x), torch.as_tensor(T), mp)
    l64 = [(w.double().numpy(), b.double().numpy()) for w, b in layers]
    h = 1e-6
    fd = np.stack([(_numpy_sdf(l64, x + h * e, T, mp)
                    - _numpy_sdf(l64, x - h * e, T, mp)) / (2 * h)
                   for e in np.eye(3)], axis=1)
    assert np.abs(g.numpy() - fd).max() <= 1e-6 * np.abs(fd).max() + 1e-9


@pytest.mark.parametrize("prec,lo,hi", [("bf16", 1e-4, 3e-2),
                                        ("tf32", 1e-5, 5e-3),
                                        ("fp8", 1e-3, 0.3)])
def test_lower_precisions_depart_from_float32(prec, lo, hi):
    mp, layers, T, x = _setup()
    x = torch.as_tensor(x, dtype=torch.float32)
    T = torch.as_tensor(T, dtype=torch.float32)
    a = REF.sdf(layers, x, T, mp)
    b = REF.sdf(layers, x, T, mp, prec)
    gap = float((a - b).abs().max() / a.abs().max())
    assert lo < gap < hi


def test_step_seed_is_splitmix64():
    # splitmix64's published first output for state 0 after one increment
    assert REF.step_seed(0, -1) == 0


def test_oriented_bounds_of_a_box():
    v = np.array([[x, y, z] for x in (-3, 3) for y in (-1.5, 1.5)
                  for z in (-2, 2)], np.float32)
    T, ext = REF.oriented_bounds(v + 0.5)
    assert sorted(np.round(ext, 6)) == [3.0, 4.0, 6.0]
    assert np.allclose(T[:3, :3] @ (np.full(3, 0.5)) + T[:3, 3], 0)
