"""The launch geometry of the MLP kernels' three phases
(isdf_tpu_torch/models/cuda_mlp.py::k1_geometry), on the CPU.

Phase 1 runs one block per tile of TM rows, phase 2 (k_dw) one block per
output tile, GEMM and split of rps rows, read in slabs of DW_SLAB rows,
and phase 3 (k_reduce) sums the partials the first two wrote. The kernels
index their scratch by this geometry, so it is held here for ragged and
exact sizes."""

import pytest

from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models.sdf_mlp import SDFModel

SIZES = (1, 63, 64, 5400, 27000, 27008)


def _geo(N):
    return K.k1_geometry(N, SDFModel().n_layers)


@pytest.mark.parametrize("N", SIZES)
def test_tiles_cover_every_row_once(N):
    g = _geo(N)
    assert g["NP"] % K.TM == 0 and g["NP"] >= N > g["NP"] - K.TM
    rows = [t * K.TM + r for t in range(g["n_tiles"]) for r in range(K.TM)]
    assert rows == list(range(g["NP"]))


@pytest.mark.parametrize("N", SIZES)
def test_splits_cover_every_row_once_in_whole_slabs(N):
    g = _geo(N)
    NP, S, rps = g["NP"], g["S"], g["rps"]
    assert rps % g["slab"] == 0 and rps > 0
    assert S * rps >= NP
    covered = []
    for s in range(S):
        rb, re = s * rps, min((s + 1) * rps, NP)
        n = max(re - rb, 0)
        assert n % g["slab"] == 0  # k_dw reads whole slabs only
        covered += range(rb, rb + n)
    assert covered == list(range(NP))


@pytest.mark.parametrize("N", SIZES)
def test_partials_have_the_shapes_k_reduce_reads(N):
    model = SDFModel()
    L, nh, H = model.n_layers, model.n_layers - 1, K.HID
    g = _geo(N)
    sh = g["shapes"]
    assert sh["part_dw"] == (g["S"], nh + 1, H, H)
    assert sh["part_db"] == (g["n_tiles"], L * H)
    assert sh["part_dwout"] == (g["n_tiles"], H)
    assert sh["part_scal"] == (g["n_tiles"], 8)
    assert sh["dW"] == (L, 2 * H, H) and sh["db"] == (L, H)
    for k in ("sig", "u", "dzb", "dub"):
        assert sh[k] == (nh, g["NP"], H)
    for k in ("pe32", "h5", "peb", "m0b"):
        assert sh[k] == (g["NP"], H)


def test_scratch_follows_the_geometry():
    """vjp_scratch allocates exactly the geometry's shapes, bf16 where the
    kernels read bf16 dW operands, and every pointer name is an argument of
    the kernels' argument block."""
    import torch
    model = SDFModel()
    scratch = K.vjp_scratch(model, 128, "cpu")
    sh = K.k1_geometry(128, model.n_layers)["shapes"]
    assert {k: tuple(v.shape) for k, v in scratch.items()} == sh
    assert set(scratch) <= set(K.ARG_PTRS)
    for k, v in scratch.items():
        want = torch.bfloat16 if k in K.BF16_SCRATCH else torch.float32
        assert v.dtype == want, k
    assert len(K.ARG_PTRS) == 37  # N_PTRS of csrc/mlp_tile.cuh
