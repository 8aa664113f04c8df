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
    # X, X2 and the weight ring in the operand type
    assert g["smem"] == (2 * K.TM * g["ldx"] + g["nstage"] * K.HID
                         * (g["ks"] + 8)) * esz
    # k_dw: its ring of the four operands' slabs (bf16), or two buffers of
    # a slab's three bf16 planes (f32)
    assert g["smem_dw"] == g["dw_stages"] * (3 if f32 else 1) * 4 * \
        g["dw_ks"] * g["dw_ld"] * 2
    assert g["smem"] + g["smem_static"] <= SMEM_BLOCK_MAX
    assert g["smem_dw"] <= SMEM_BLOCK_MAX
    # the f32 tile of the row reductions (64 x 260 f32) aliases X and X2
    assert K.TM * 260 * 4 <= 2 * K.TM * g["ldx"] * esz
    # 16-byte cp.async rows and float2 / ldmatrix rows stay aligned
    assert (g["ldx"] * esz) % 16 == 0 and ((g["ks"] + 8) * esz) % 16 == 0
    assert (g["dw_ld"] * 2) % 16 == 0 and K.HID % g["ks"] == 0
    assert g["slab"] % g["dw_ks"] == 0  # k_dw's slabs tile a split's rows
    base = K.k1_geometry(27000, model.n_layers)
    assert {k: g[k] for k in ("NP", "n_tiles")} == \
        {k: base[k] for k in ("NP", "n_tiles")}
    # the f32 mode splits dW's rows S ways for its one-block k_dw
    assert g["S"] == (K.N_SPLITS_F32 if f32 else K.N_SPLITS)
    assert {k: v for k, v in g["shapes"].items() if k != "part_dw"} == \
        {k: v for k, v in base["shapes"].items() if k != "part_dw"}
    assert g["shapes"]["part_dw"] == (g["S"],) + base["shapes"]["part_dw"][1:]
    if f32:
        assert g["blocks_per_sm"] == 1 and g["smem"] == 217088
        assert g["smem_dw"] == 104448
    else:  # two blocks share an SM's 228 KB
        assert g["blocks_per_sm"] == 2 and g["smem"] == 108544
        assert 2 * (g["smem"] + g["smem_static"] + 1024) <= 233472


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_scratch_and_weights_follow_the_product_mode(precision,
                                                      monkeypatch):
    """vjp_scratch and weight_args give the kernels their mode's operand
    type: bf16 weights and planes for "default", f32 for any other
    mm_precision (isdf_tpu's mm_dtype = float32), split in the kernels'
    registers."""
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
    if f32:  # split in the kernels' registers
        assert w["W"] is Wp
    else:
        assert torch.equal(w["W"], Wp.to(torch.bfloat16))
    assert torch.equal(w["w_out"], Wp[L - 1, :K.HID, 0])


# an SM's shared memory for resident blocks (228 KB; 1 KB of it reserved
# per block)
SMEM_SM = 233472


@pytest.mark.parametrize("phase", ["k_train_tile", "k_dw"])
def test_f32_mode_shared_memory_budget(phase):
    """The f32-product mode's budget: f32 X and X2 with a two-stage ring of
    32-row f32 weight slabs (k_train_tile), two buffers of the bf16 planes
    a 16-row slab of f32 operands splits into (k_dw); each within a
    block's 227 KB. Three bf16 planes of the weights (6 bytes a weight,
    against the f32 ring's 4) would fit the block only at 16-row
    stages."""
    L = SDFModel().n_layers
    g = K.k1_geometry(27000, L, f32=True)
    assert g["nstage"] == 2 and g["ks"] == 32
    if phase == "k_train_tile":
        x_bytes = 2 * K.TM * g["ldx"] * 4
        ring = g["nstage"] * K.HID * (g["ks"] + 8) * 4
        assert (x_bytes, ring) == (135168, 81920)
        used = g["smem"] + g["smem_static"]
        # two 32-row stages of three bf16 planes would not fit
        assert x_bytes + 2 * 3 * K.HID * 40 * 2 + g["smem_static"] > \
            SMEM_BLOCK_MAX
    else:
        used = g["smem_dw"]
        assert g["dw_stages"] == 2 and g["dw_ks"] == 16
        assert used == 2 * 3 * 4 * 16 * 136 * 2
    assert used <= SMEM_BLOCK_MAX and used + 1024 <= SMEM_SM
    if phase == "k_train_tile":
        assert SMEM_SM < 2 * (used + 1024) and g["blocks_per_sm"] == 1


def _banks(words):
    """The shared-memory banks of 4-byte words."""
    return [w % 32 for w in words]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_f32_fragment_loads_fall_in_distinct_banks(f32):
    """The f32 mode builds its fragments with ld.shared: lanes (g, q) of a
    warp read A at rows g (+ 8), columns 2q, 2q + 1 of X and X2 and B at
    rows n = g (+ 8 jn), columns 2q, 2q + 1 of a [n][k] weight slab (8
    bytes; a half-warp a transaction), or B at rows 2q, 2q + 1 and column
    g of a [k][n] slab (4 bytes; the whole warp). With the geometry's row
    strides (X 264, [n][k] ks + 8, [k][n] 260) no two lanes of a
    transaction share a bank. The bf16 mode reads by ldmatrix and keeps
    its strides, and so does k_dw's read of its split planes."""
    g = K.k1_geometry(27000, SDFModel().n_layers, f32=f32)
    if not f32:
        assert (g["ldx"], g["ks"] + 8, g["dw_ld"]) == (264, 40, 136)
        return
    assert g["dw_ld"] == 136
    ldx, ldt, ldw = g["ldx"], g["ks"] + 8, 260
    for stride in (ldx, ldt):
        for half in (0, 1):  # lanes 16 half .. 16 half + 15
            words = []
            for lane in range(16 * half, 16 * half + 16):
                gg, q = lane // 4, lane % 4
                w = gg * stride + 2 * q
                words += [w, w + 1]
            assert sorted(_banks(words)) == list(range(32))
    words = [2 * (lane % 4) * ldw + lane // 4 for lane in range(32)]
    assert sorted(_banks(words)) == list(range(32))


@pytest.mark.parametrize("N", SIZES)
def test_f32_splits_cover_every_row_once_in_whole_waves(N):
    """The f32 mode's k_dw: N_SPLITS_F32 splits of whole slabs cover every
    row once, and at the trainer's size its blocks (4 output tiles x L
    GEMMs x S splits, one a SM) fill whole waves of an H100's 132 SMs."""
    L = SDFModel().n_layers
    g = K.k1_geometry(N, L, f32=True)
    NP, S, rps = g["NP"], g["S"], g["rps"]
    assert S == K.N_SPLITS_F32 and rps % g["slab"] == 0
    covered = []
    for s in range(S):
        rb, re = s * rps, min((s + 1) * rps, NP)
        n = max(re - rb, 0)
        assert n % g["dw_ks"] == 0
        covered += range(rb, rb + n)
    assert covered == list(range(NP))
    if N == 27000:
        assert (4 * L * S) % 132 == 0
