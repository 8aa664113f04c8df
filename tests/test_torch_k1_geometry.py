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
        want = (torch.bfloat16 if k in K.OPERAND_SCRATCH
                else torch.float32)
        assert v.dtype == want, k
    assert len(K.ARG_PTRS) == 37  # N_PTRS of csrc/mlp_tile.cuh


# the H100's shared memory a block can use (227 KB, dynamic and static)
SMEM_BLOCK_MAX = 232448


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_mode_geometry_and_shared_memory(f32):
    """The product mode's operand dtype, scratch dtypes and shared memory:
    the geometry the wrappers allocate by is the layout of
    csrc/mlp_tile.cuh (SMEM_DYN, SMEM_DW), within a block's limit, and the
    f32 mode changes only the operand planes and the shared memory."""
    import torch
    model = SDFModel()
    g = K.k1_geometry(27000, model.n_layers, f32=f32)
    op = torch.float32 if f32 else torch.bfloat16
    assert g["op_dtype"] == op
    for k, dt in g["dtypes"].items():
        assert dt == (op if k in K.OPERAND_SCRATCH else torch.float32), k
    esz = 4 if f32 else 2
    assert g["smem"] == (2 * K.TM * g["ldx"] + g["nstage"] * K.HID
                         * (g["ks"] + 8)) * esz
    assert g["smem_dw"] == g["dw_stages"] * 4 * K.DW_SLAB * 136 * esz
    assert g["smem"] + g["smem_static"] <= SMEM_BLOCK_MAX
    assert g["smem_dw"] <= SMEM_BLOCK_MAX
    # the f32 tile of the row reductions (64 x 260 f32) aliases X and X2
    assert K.TM * 260 * 4 <= 2 * K.TM * g["ldx"] * esz
    # 16-byte cp.async rows and float4 / ldmatrix rows stay aligned
    assert (g["ldx"] * esz) % 16 == 0 and ((g["ks"] + 8) * esz) % 16 == 0
    base = K.k1_geometry(27000, model.n_layers)
    assert {k: g[k] for k in ("NP", "n_tiles", "S", "rps", "shapes")} == \
        {k: base[k] for k in ("NP", "n_tiles", "S", "rps", "shapes")}
    if f32:
        assert g["blocks_per_sm"] == 1 and g["smem"] == 215040
    else:  # two blocks share an SM's 228 KB
        assert g["blocks_per_sm"] == 2 and g["smem"] == 108544
        assert 2 * (g["smem"] + g["smem_static"] + 1024) <= 233472


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_scratch_and_weights_follow_the_product_mode(precision,
                                                      monkeypatch):
    """vjp_scratch and weight_args give the kernels their mode's operand
    type: bf16 weights and planes for "default", f32 for any other
    mm_precision (isdf_tpu's mm_dtype = float32)."""
    import torch
    model = SDFModel(mm_precision=precision)
    f32 = precision != "default"
    assert K.is_f32(model) == f32
    scratch = K.vjp_scratch(model, 100, "cpu")
    for k in K.OPERAND_SCRATCH:
        assert scratch[k].dtype == (torch.float32 if f32 else torch.bfloat16)
    L = model.n_layers
    Wp = torch.randn(L, 2 * K.HID, K.HID)
    bp = torch.randn(L, K.HID)
    # CPU tensors: the device check is the only one that would refuse
    monkeypatch.setattr(K, "_check", lambda *a, **k: None)
    w = K.weight_args({"Wp": Wp, "bp": bp}, model)
    assert w["W"].dtype == (torch.float32 if f32 else torch.bfloat16)
    if f32:
        assert w["W"] is Wp
    assert torch.equal(w["w_out"], Wp[L - 1, :K.HID, 0])
