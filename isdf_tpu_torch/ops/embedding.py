"""Positional encodings of the SDF MLP input (isdf_tpu/ops/embedding.py).

* Icosahedron PE: project the scene-normalised, scaled xyz onto the 21
  unit directions through the vertices and edge midpoints of half an
  icosahedron, multiply by 2^k frequency bands, take sin and the
  pi/2-phase-shifted sin (== cos), and concatenate the scaled coords
  (reference isdf/modules/embedding.py:25-111). Embedding size
  2*21*n_freqs + 3.
* Gaussian random-Fourier features: [scaled_xyz, sin(2 pi xs B),
  cos(2 pi xs B)] with B ~ N(0, std^2) of shape [3, n_feats] (the
  reference declares this option but its forward path is unimplemented;
  isdf_tpu makes it work, and so does this copy).
"""

from __future__ import annotations

import numpy as np
import torch

# 21 unit directions: vertices + edge midpoints of a half icosahedron
ICOSAHEDRON_DIRS = np.array([
    [0.8506508, 0.0, 0.5257311],
    [0.809017, 0.5, 0.309017],
    [0.5257311, 0.8506508, 0.0],
    [1.0, 0.0, 0.0],
    [0.809017, 0.5, -0.309017],
    [0.8506508, 0.0, -0.5257311],
    [0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, -0.8506508],
    [0.5, 0.309017, -0.809017],
    [0.0, 1.0, 0.0],
    [-0.5257311, 0.8506508, 0.0],
    [-0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, 0.8506508],
    [-0.309017, 0.809017, 0.5],
    [0.309017, 0.809017, 0.5],
    [0.5, 0.309017, 0.809017],
    [0.5, -0.309017, 0.809017],
    [0.0, 0.0, 1.0],
    [-0.5, 0.309017, 0.809017],
    [-0.809017, 0.5, 0.309017],
    [-0.809017, 0.5, -0.309017],
], dtype=np.float32)  # [21, 3]


def n_freqs(min_deg: int, max_deg: int) -> int:
    return max_deg - min_deg + 1


def embedding_size(min_deg: int = 0, max_deg: int = 5) -> int:
    """Width of the icosahedron PE: 2 * 21 * n_freqs + 3."""
    return 2 * ICOSAHEDRON_DIRS.shape[0] * n_freqs(min_deg, max_deg) + 3


def bands(min_deg: int, max_deg: int) -> torch.Tensor:
    """2^k for k = min_deg..max_deg, float32 (on the CPU)."""
    nf = n_freqs(min_deg, max_deg)
    return torch.from_numpy(2.0 ** np.linspace(min_deg, max_deg, nf)
                            .astype(np.float32))


def scale_input(x, transform=None, scale=None):
    """Map world coords into the normalised scene frame, then scale
    (reference embedding.py:12-22)."""
    if transform is not None:
        x = x @ transform[:3, :3].T + transform[:3, 3]
    if scale is not None:
        x = x * scale
    return x


_DEVICE_CONSTS = {}


def _device_consts(min_deg: int, max_deg: int, device):
    """(bands, icosahedron directions [3, 21]) on ``device``, copied there
    once: a copy from pageable host memory on every call would wait for
    the card's stream."""
    key = (min_deg, max_deg, str(device))
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = (
            bands(min_deg, max_deg).to(device),
            torch.from_numpy(ICOSAHEDRON_DIRS.T.copy()).to(device))
    return _DEVICE_CONSTS[key]


def positional_encoding(x, transform=None, scale: float = 1.0,
                        min_deg: int = 0, max_deg: int = 5):
    """x: [..., 3] world coordinates -> [..., 2*21*n_freqs + 3], laid out
    [scaled_xyz, sin(proj * 2^k) (dir-major, freq-minor),
    sin(proj * 2^k + pi/2)]. Float32 throughout."""
    b, D = _device_consts(min_deg, max_deg, x.device)
    xs = scale_input(x, transform=transform, scale=scale)
    proj = xs @ D                                            # [..., 21]
    xb = (proj[..., None] * b).reshape(*proj.shape[:-1], -1)
    emb = torch.sin(torch.cat([xb, xb + 0.5 * np.pi], dim=-1))
    return torch.cat([xs, emb], dim=-1)


def init_gaussian_embedding(gen: torch.Generator, std: float = 11.0,
                            n_feats: int = 126, device="cpu"):
    """Random Fourier feature matrix B ~ N(0, std^2) [3, n_feats], drawn
    on the CPU from ``gen`` and moved to ``device``."""
    return (std * torch.randn((3, n_feats), generator=gen)).to(device)


def gaussian_encoding(x, B, transform=None, scale: float = 1.0):
    """Gaussian RFF embedding [..., 3] -> [..., 3 + 2 n_feats]:
    [scaled_xyz, sin(2 pi xs B), cos(2 pi xs B)], float32."""
    xs = scale_input(x, transform=transform, scale=scale)
    proj = 2.0 * np.pi * (xs @ B)
    return torch.cat([xs, torch.sin(proj), torch.cos(proj)], dim=-1)
