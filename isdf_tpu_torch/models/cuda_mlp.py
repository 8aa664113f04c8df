"""The fused train op: loss AND parameter gradients of one ray batch.

Port of isdf_tpu/models/pallas_mlp.py::make_pallas_train_op (the TPU
kernel ``_make_kernel_train``, variants ``op_pc_bounds``,
``op_pe_in_kernel`` and ``op``). One call computes, for N sample points:

  * the PE: built from the world points (one f32 affine map + sin), or
    streamed in as a [N, E] plane (sdf_mlp._pe_factored, the ``op``
    variant, pe_in_kernel=False);
  * (pc variant) the batch-distance bound: signed distance to the nearest
    valid surface point, first-index argmin, behind-surface sign, and the
    gradient target with the per-point normal fallback at degeneracies;
  * the softplus(100) MLP forward with the skip-concat, and the reverse
    v-chain for d sdf / dx;
  * the per-point loss (free-space / truncation L1 or L2, gradient cosine,
    gated eikonal), the sums [total, sdf, grad, eik, count] (unnormalised),
    the per-point total loss;
  * the hand-derived loss backward and the parameter VJP -> (dW, db) on the
    packed planes of models/sdf_mlp.py.

Two executors of the same function:

  * ``train_op_plain`` — eager torch. Hidden-layer operands are rounded to
    ``mm_dtype`` (bf16 when model.mm_precision == "default") with float32
    accumulation, like the kernel; the PE, scores, tangent contractions
    and output head stay float32. The CPU tests hold it against the JAX
    package, and chip_smoke.py holds the kernel against it on the card.
  * the CUDA kernel csrc/train_mlp.cu (sm_90a), built with nvcc at first
    use into a directory .gitignore lists, and bound through ctypes; for
    mm_precision other than "default" its f32-product mode,
    csrc/train_mlp_f32.cu (isdf_tpu's mm_dtype = float32), whose hidden
    products are split-bf16 tensor-core products (SPLIT_TERMS), the f32
    operands split in the kernel's registers; for an embedding wider than
    256 lanes (n_embed_funcs 8: E = 381, iSDF's live configs) its 384-lane
    build, csrc/train_mlp_384.cu, in the bf16 mode only.

``make_train_op`` returns a function that takes the plain version for CPU
tensors and launches the kernel for CUDA tensors; it never falls back.
``LAUNCHES`` counts kernel launches per variant, the f32 mode's and the
384-lane build's apart.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from isdf_tpu_torch.models import fused_vjp as FV
from isdf_tpu_torch.models.sdf_mlp import SDFModel, _pe_consts
from isdf_tpu_torch.utils import nvcc

HID = 256
TM = 64           # rows per tile of the kernels' first phase
N_SPLITS = 16     # split-K partials of the dW products
# ... in the f32-product mode, where k_dw runs one block per SM: 4 output
# tiles x 7 GEMMs x 33 splits = 924 blocks, seven full waves on an H100's
# 132 SMs (16 splits: 448 blocks, 3.4 waves)
N_SPLITS_F32 = 33
DW_SLAB = 32      # rows per shared-memory slab of k_dw (csrc: DW_KS)
HALF_PI = float(np.float32(np.pi / 2))

# the PE lanes of K1's 384-lane build (csrc/train_mlp_384.cu, bf16 mode);
# K1's f32 mode, K2/K3 and the query kernel take at most HID
K1_MAX_LANES = 384

# kernel launches per variant, "-f32" the f32-product mode, "-384" the
# 384-lane build; only the wrapper below adds to them (a captured launch
# once per graph replay, utils/nvcc.py)
LAUNCHES = {"K1-pc": 0, "K1-ray": 0, "K1-stream": 0, "K1-pc-f32": 0,
            "K1-ray-f32": 0, "K1-stream-f32": 0, "K1-pc-384": 0,
            "K1-ray-384": 0, "K1-stream-384": 0}
MODES = {"K1-pc": 0, "K1-ray": 1, "K1-stream": 2}

# the pointer fields of the kernels' argument block (csrc/mlp_tile.cuh,
# struct Args), in declaration order
ARG_PTRS = ("pts", "valid", "noise", "col_a", "vec3", "is_surf", "sp",
            "surf", "Mc", "Tc", "b", "w_out", "inv_count", "W", "ploss",
            "sums", "dW", "db", "pe32", "sig", "u", "h5", "peb", "m0b",
            "hb", "tb", "dzb", "dub", "part_scal", "part_db", "part_dwout",
            "part_dw", "pe_in", "raw_out", "graw_out", "draw_in", "dg_in")


# the cross terms of the f32-product mode's split products, (part of A,
# part of B) with 0 hi, 1 mid, 2 lo, in the kernel's order (csrc/
# mlp_tile.cuh, mma_split): smallest first, the three terms below 2^-24 of
# the product (ml, lm, ll) left out, as a TPU's Precision.HIGHEST leaves
# them out of its six bf16 passes
SPLIT_TERMS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def _round_up(n, m):
    return (n + m - 1) // m * m


def _loss_knobs(model, loss_type, trunc_distance, trunc_weight,
                eik_apply_dist, eik_weight, grad_weight, orien_loss,
                free_space_factor):
    return dict(so=float(model.scale_output), trunc_d=float(trunc_distance),
                tw=float(trunc_weight), gw=float(grad_weight),
                ew=float(eik_weight), ead=float(eik_apply_dist),
                fsf=float(free_space_factor), loss_type=loss_type,
                orien=bool(orien_loss))


def pe_lanes(model: SDFModel) -> int:
    """The PE lanes of the kernels' planes for this model: its packed rows
    (sdf_mlp.SDFModel.pack_rows), at least 256; K1 builds 256 or 384."""
    return max(HID, model.pack_rows)


def tangent_rows(model: SDFModel, dxs, dproj2):
    """Tc [3, pe_lanes] f32: row k = [dxs[k] | dproj2[k] | 0]."""
    E = model.embedding_size
    T = torch.zeros((3, pe_lanes(model)), dtype=torch.float32,
                    device=dxs.device)
    T[:, :3] = dxs
    T[:, 3:E] = dproj2
    return T


def score_plane(surf, surf_valid):
    """sp [4, R]: scores = x sp[0] + y sp[1] + z sp[2] + sp[3] =
    -2 x.s + |s|^2, +1e30 on invalid surface points."""
    pen = (surf * surf).sum(-1) + (1.0 - surf_valid) * 1e30
    return torch.cat([(-2.0 * surf).T, pen[None]], dim=0).contiguous()


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def train_op_plain(params, model: SDFModel, lk, M, Tc, pts, valid, noise,
                   inv_count, *, bounds=None, gt=None, surf=None,
                   surf_valid=None, zd=None, normals_pt=None, is_surf=None,
                   pe=None, mm_dtype=torch.bfloat16):
    """Eager-torch train op. pc variant when ``surf`` is given (then zd,
    normals_pt, is_surf, surf_valid), else the ray variant (bounds, gt);
    ``pe`` [N, E] streams the PE in (then pts and M are unused).
    Returns (sums [5], ploss [N], (dW like Wp, db like bp))."""
    E = model.embedding_size
    F = (E - 3) // 2
    so = lk["so"]
    dev = valid.device
    lane = torch.arange(E, device=dev)
    if pe is None:
        # ---- PE (the kernel's rounding order) ----
        x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
        Me = M[:, :E]
        pre = ((x * Me[0] + y * Me[1]) + z * Me[2]) + Me[3]
        s = torch.sin(pre + torch.where(lane >= 3 + F, HALF_PI, 0.0))
        pe = torch.where(lane < 3, pre, s)
    cb = torch.cat([torch.ones_like(pe[:, :3]), pe[:, 3 + F:],
                    -pe[:, 3:3 + F]], dim=1)

    # ---- bounds and gradient targets ----
    if surf is not None:
        x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
        sp = score_plane(surf, surf_valid)
        scores = ((x * sp[0] + y * sp[1]) + z * sp[2]) + sp[3]
        closest = scores.argmin(dim=1)
        diff = pts - surf[closest]
        d = diff.square().sum(-1, keepdim=True).sqrt()
        sgn = torch.where(zd[:, None] > 0, -1.0, 1.0)
        b_col = sgn * d
        live = (d > 1e-12) & (is_surf[:, None] < 0.5)
        gt = torch.where(live, diff * sgn / d.clamp(min=1e-12), normals_pt)
    else:
        b_col = bounds[:, None]

    # ---- forward, v-chain -> spatial gradient ----
    raw, sigs, hs = FV.forward_values(params, model, pe, mm_dtype)
    raw = raw[:, None]
    vpe = FV.v_chain(params, model, sigs, mm_dtype)
    g = (cb * vpe) @ Tc[:, :E].T                                # [N, 3]

    # ---- per-point loss ----
    v_col = valid[:, None]
    gs = g * so
    sdf = (raw + noise[:, None]) * so
    fs = b_col > lk["trunc_d"]
    a_ = torch.relu(sdf - b_col)
    c_ = torch.exp(-lk["fsf"] * sdf) - 1.0
    f_ = torch.maximum(a_, c_)
    da = (sdf > b_col).float()
    dc = -lk["fsf"] * torch.exp(-lk["fsf"] * sdf)
    df = torch.where(a_ > c_, da, torch.where(c_ > a_, dc, 0.5 * (da + dc)))
    mt = sdf - b_col
    if lk["loss_type"] == "L1":
        matf, dmatf, matt, dmatt = f_, df, mt.abs(), torch.sign(mt)
    else:
        matf, dmatf, matt, dmatt = f_ * f_, 2.0 * f_ * df, mt * mt, 2.0 * mt
    sdf_mat = torch.where(fs, matf, matt * lk["tw"])
    dsdf_mat = torch.where(fs, dmatf, dmatt * lk["tw"])

    total = sdf_mat
    zero = torch.zeros((), device=dev)
    s_grad = s_eik = zero
    dg = torch.zeros_like(gs)
    eps = 1e-6
    gnorm = gs.square().sum(-1, keepdim=True).sqrt()
    if lk["gw"] != 0.0:
        gtn = gt.square().sum(-1, keepdim=True).sqrt()
        na, nb = gtn.clamp(min=eps), gnorm.clamp(min=eps)
        dotg = (gt * gs).sum(-1, keepdim=True)
        gmat = 1.0 - dotg / (na * nb)
        if lk["orien"]:
            gmat = (gmat > 1.0).float()
        else:
            live_g = (gnorm > eps).float()
            dg = dg + lk["gw"] * -(gt / (na * nb) - dotg * gs * live_g
                                   / (na * nb * nb * gnorm.clamp(min=1e-12)))
        total = total + lk["gw"] * gmat
        s_grad = (gmat * v_col).sum()
    if lk["ew"] != 0.0:
        emat = (gnorm - 1.0).abs()
        gate = (b_col >= lk["ead"]).float()
        eikw = emat * (gate * lk["ew"])
        dg = dg + (lk["ew"] * gate * torch.sign(gnorm - 1.0) * gs
                   / gnorm.clamp(min=1e-12))
        total = total + eikw
        s_eik = (eikw * v_col).sum()
    total = total * v_col
    sums = torch.stack([total.sum(), (sdf_mat * v_col).sum(), s_grad, s_eik,
                        v_col.sum()])

    # ---- loss backward -> (draw, dg) ----
    w_pt = v_col * inv_count
    draw = w_pt * dsdf_mat * so                                 # [N, 1]
    dg = dg * so * w_pt

    # ---- combined tangent, tangent chain, parameter VJP ----
    dgT = dg @ Tc[:, :E]
    m0 = torch.where(lane < 3, dgT, cb * dgT)
    dW, db = FV.param_vjp(params, model, pe, m0, sigs, hs, draw[:, 0],
                          mm_dtype)
    return sums, total[:, 0], (dW, db)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_kernel_model(model: SDFModel, max_lanes: int = HID,
                       what: str = "the MLP kernels"):
    """Raises unless ``what`` takes the model: hidden width 256 and an
    embedding of at most ``max_lanes`` lanes."""
    if model.hidden_size != HID or model.embedding_size > max_lanes:
        raise ValueError(
            f"{what}: hidden_size 256 and an embedding of at most "
            f"{max_lanes} lanes needed; this map has hidden_size "
            f"{model.hidden_size} and {model.embedding_size} lanes")


def is_f32(model: SDFModel) -> bool:
    """Whether the kernels run their f32-product mode for this model."""
    return FV.mm_dtype_of(model) == torch.float32


def check_k1_model(model: SDFModel):
    """K1 takes up to 256 lanes, or in its bf16 mode an embedding packed
    to 384 (n_embed_funcs 8: E = 381)."""
    if is_f32(model):
        check_kernel_model(model, HID, "K1 in the f32-product mode")
    elif model.pack_rows not in (HID, K1_MAX_LANES):
        raise ValueError(
            f"K1: an embedding of at most 256 lanes, or of 369 to 384 lanes "
            f"(its 384-lane build), needed; this map has "
            f"{model.embedding_size} lanes")
    else:
        check_kernel_model(model, K1_MAX_LANES, "K1")


def source(name: str, model: SDFModel) -> str:
    """The csrc/ source of an MLP kernel library ("train_mlp",
    "reverse_fused") in the model's product mode and, for K1, lanes."""
    if is_f32(model):
        return name + "_f32"
    if name == "train_mlp" and pe_lanes(model) > HID:
        return name + "_384"
    return name


def variant(mode: str, model: SDFModel) -> str:
    """K1's variant and lanes as spans name them, e.g. "K1-ray/384" or
    "K1-pc-f32/256"."""
    return (f"{mode}{'-f32' if is_f32(model) else ''}"
            f"/{pe_lanes(model)}")


@functools.lru_cache(maxsize=None)
def _occupancy(src: str, device_index: int):
    """Resident blocks an SM of k_train_tile in modes pc, ray, stream, as
    the library ``src``'s isdf_train_mlp_occupancy reads them on a card."""
    with torch.cuda.device(device_index):
        out = (ctypes.c_int * 4)()
        fn = nvcc.load(src).isdf_train_mlp_occupancy
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"isdf_train_mlp_occupancy: CUDA error {rc}")
    return tuple(out[:3])


def blocks_per_sm(mode: str, model: SDFModel, device) -> int:
    """Resident blocks an SM of K1's k_train_tile for ``mode`` ("K1-pc",
    "K1-ray", "K1-stream") in this model's build on ``device``: read once a
    library and card, then cached."""
    index = torch.device(device).index or 0
    return _occupancy(source("train_mlp", model), index)[MODES[mode]]


def weight_args(params, model: SDFModel):
    """The weight pointers of the argument block: W (the planes [L, 2
    pe_lanes, 256] in the products' operand type: bf16, or f32 as they
    are, split in the kernels' registers), b and w_out, checked."""
    L = model.n_layers
    Wp, bp = params["Wp"], params["bp"]
    _check("Wp", Wp, (L, 2 * pe_lanes(model), HID))
    _check("bp", bp, (L, HID))
    W = Wp if is_f32(model) else Wp.to(torch.bfloat16).contiguous()
    return dict(W=W, b=bp, w_out=Wp[L - 1, :HID, 0].contiguous())


# the scratch planes that hold product operands (bf16, or f32 in the f32
# mode); the rest of the scratch is f32 in both modes
OPERAND_SCRATCH = ("peb", "m0b", "hb", "tb", "dzb", "dub")


def k1_geometry(N: int, L: int, f32: bool = False, lanes: int = HID) -> dict:
    """Launch geometry of the MLP kernels' phases for N points and L packed
    layers: NP rows in n_tiles tiles of TM (phase 1), S splits of rps rows
    each, a multiple of the k_dw slab (phase 2), and the shapes of the
    scratch the phases pass on (phase 3 reads the partials). ``f32``: the
    f32-product mode; ``lanes``: the PE's lanes (256, or 384 in K1's
    384-lane build: pe32, peb, m0b and layer 0's and the skip layer's pe
    rows of dW that wide). Also the mode's operand dtype (of the weights,
    the activation tiles and the dW operand planes) and the shared memory
    of each phase as csrc/mlp_tile.cuh lays it out (SMEM_DYN, SMEM_DW): the
    activation tiles X and X2 (TM rows of ldx: 256 lanes at every lane
    count), the weight ring (nstage stages of ``stage`` bytes, a
    transposed slab of 256 rows of ks + 8), k_dw's ring (dw_stages stages
    of the four operands' dw_ks rows of dw_ld; in the f32 mode two buffers
    of the three bf16 planes a slab splits into), k_dw's grid (dw_tiles
    output tiles a GEMM), the static shared arrays of k_train_tile
    (smem_static) and the resident blocks an SM they leave room for
    (blocks_per_sm). The bf16 budget: X and X2 (67,584 B) and a ring of
    two stages (40,960 B), two blocks an SM at 256 and at 384 lanes. At
    384 a stage holds, where a product reads the PE's lanes past 256, the
    unpadded plain slab [ks][256] (wslab) and the A slab [TM][ks] of those
    lanes (aslab) from the stash. The f32 mode's: X and X2 f32 (135,168
    B) and a ring of two f32 stages of 32 rows (81,920 B), one block per
    SM; k_dw's two buffers of 16-row split planes (104,448 B)."""
    assert lanes == HID or (lanes == K1_MAX_LANES and not f32), lanes
    nh = L - 1
    NP = _round_up(max(N, 1), TM)
    n_tiles = NP // TM
    S = N_SPLITS_F32 if f32 else N_SPLITS
    rps = _round_up(-(-NP // S), DW_SLAB)
    P = lanes
    shapes = dict(
        pe32=(NP, P), sig=(nh, NP, HID), u=(nh, NP, HID), h5=(NP, HID),
        peb=(NP, P), m0b=(NP, P), hb=(max(nh - 1, 1), NP, HID),
        tb=(max(nh - 1, 1), NP, HID), dzb=(nh, NP, HID), dub=(nh, NP, HID),
        part_scal=(n_tiles, 8), part_db=(n_tiles, L * HID),
        part_dwout=(n_tiles, HID), part_dw=(S, nh + 1, P, HID),
        dW=(L, 2 * P, HID), db=(L, HID))
    op_dtype = torch.float32 if f32 else torch.bfloat16
    esz = 4 if f32 else 2
    ldx, ks, nstage, dw_ld = HID + 8, 32, 2, 136
    stage = HID * (ks + 8) * esz
    smem = 2 * TM * ldx * esz + nstage * stage
    if f32:  # two buffers of a 16-row slab's three bf16 planes
        dw_stages, dw_ks = 2, 16
        smem_dw = dw_stages * 3 * 4 * dw_ks * dw_ld * 2
    else:
        dw_stages, dw_ks = 3, DW_SLAB
        smem_dw = dw_stages * 4 * dw_ks * dw_ld * esz
    smem_static = (22 * TM + HID) * 4  # per-row columns, ctb, st_col
    dtypes = {k: op_dtype if k in OPERAND_SCRATCH else torch.float32
              for k in shapes}
    return dict(NP=NP, n_tiles=n_tiles, S=S, rps=rps, slab=DW_SLAB,
                shapes=shapes, dtypes=dtypes, op_dtype=op_dtype, ldx=ldx,
                ks=ks, nstage=nstage, dw_stages=dw_stages, dw_ks=dw_ks,
                dw_ld=dw_ld, smem=smem, smem_dw=smem_dw,
                smem_static=smem_static, lanes=P, stage=stage,
                wslab=ks * HID * esz, aslab=TM * ks * esz if P > HID else 0,
                dw_tiles=(P // 128) * (HID // 128),
                blocks_per_sm=1 if f32 else 2)


def vjp_scratch(model: SDFModel, N: int, dev):
    """Scratch of the parameter-VJP phases for N points (sig/u stash, dW
    operands in the products' type, per-tile and split-K partials) and the
    dW/db outputs."""
    geo = k1_geometry(N, model.n_layers, f32=is_f32(model),
                      lanes=pe_lanes(model))
    return {k: torch.empty(shape, device=dev, dtype=geo["dtypes"][k])
            for k, shape in geo["shapes"].items()}


def launch(lib, fn_name, model: SDFModel, N: int, ptrs: dict, lk=None,
           R: int = 0, extra_ints=()):
    """Launch an entry point of the MLP kernels with the argument block
    made of ``ptrs`` (ARG_PTRS names, W among them; missing ones are
    null)."""
    unknown = set(ptrs) - set(ARG_PTRS)
    assert not unknown, unknown
    geo = k1_geometry(N, model.n_layers, f32=is_f32(model),
                      lanes=pe_lanes(model))
    lk = lk or dict(so=0.0, trunc_d=0.0, tw=0.0, gw=0.0, ew=0.0, ead=0.0,
                    fsf=0.0, loss_type="L1", orien=False)
    knobs = [lk["so"], lk["trunc_d"], lk["tw"], lk["gw"], lk["ew"],
             lk["ead"], lk["fsf"]]
    ints = [N, geo["NP"], R, model.n_layers, model.cat_idx,
            model.embedding_size, int(lk["loss_type"] == "L1"),
            int(lk["orien"]), geo["S"], geo["rps"], *extra_ints]
    nvcc.call(lib, fn_name, [ptrs.get(k) for k in ARG_PTRS], knobs, ints,
              ptrs["W"].device)


def train_op_cuda(params, model: SDFModel, lk, M, Tc, pts, valid, noise,
                  inv_count, *, bounds=None, gt=None, surf=None,
                  surf_valid=None, zd=None, normals_pt=None, is_surf=None,
                  pe=None):
    """Launch the kernel (three phases on the current stream). Same
    arguments and results as train_op_plain with mm_dtype =
    FV.mm_dtype_of(model)."""
    check_k1_model(model)
    P = pe_lanes(model)
    mode = ("K1-pc" if surf is not None else
            "K1-stream" if pe is not None else "K1-ray")
    N = (pe if pe is not None else pts).shape[0]
    dev = (pe if pe is not None else pts).device
    ptrs = weight_args(params, model)
    _check("valid", valid, (N,))
    _check("noise", noise, (N,))
    _check("inv_count", inv_count, ())
    _check("Tc", Tc, (3, P))
    ptrs.update(valid=valid, noise=noise, inv_count=inv_count, Tc=Tc)
    R = 0
    if mode == "K1-stream":
        _check("pe", pe, (N, model.embedding_size))
        ptrs["pe_in"] = pe
    else:
        _check("pts", pts, (N, 3))
        _check("M", M, (128, P))
        ptrs.update(pts=pts, Mc=M[:4].contiguous())
    if mode == "K1-pc":
        R = surf.shape[0]
        _check("surf", surf, (R, 3))
        _check("surf_valid", surf_valid, (R,))
        _check("zd", zd, (N,))
        _check("normals_pt", normals_pt, (N, 3))
        _check("is_surf", is_surf, (N,))
        ptrs.update(col_a=zd, vec3=normals_pt, is_surf=is_surf,
                    sp=score_plane(surf, surf_valid), surf=surf)
    else:
        _check("bounds", bounds, (N,))
        _check("gt", gt, (N, 3))
        ptrs.update(col_a=bounds, vec3=gt)

    ptrs.update(vjp_scratch(model, N, dev))
    ptrs.update(ploss=torch.empty(N, device=dev),
                sums=torch.empty(5, device=dev))
    launch(nvcc.load(source("train_mlp", model)), "isdf_train_mlp", model,
           N, ptrs, lk=lk, R=R, extra_ints=(MODES[mode],))
    nvcc.count_launch(LAUNCHES, mode + ("-f32" if is_f32(model) else
                                        "-384" if P > HID else ""))
    return ptrs["sums"], ptrs["ploss"], (ptrs["dW"], ptrs["db"])


def make_train_op(model: SDFModel, *, loss_type: str, trunc_distance: float,
                  trunc_weight: float, eik_apply_dist: float,
                  eik_weight: float, grad_weight: float, orien_loss: bool,
                  free_space_factor: float = 5.0, pc_bounds: bool = False,
                  pe_in_kernel: bool = True):
    """Fused train op (isdf_tpu make_pallas_train_op with packed_io=True).

    pc_bounds=True: op(params, transform, pts [N,3], surf [R,3],
        surf_valid [R] f32, zd [N], normals_pt [N,3], is_surf [N] f32,
        valid [N] f32, noise [N], inv_count [])
    pe_in_kernel=True: op(params, transform, pts, bounds [N], valid, noise,
        gt [N,3], inv_count)
    pe_in_kernel=False: op(params, pe [N,E], dxs [3,3], dproj2 [3,2F],
        bounds, valid, noise, gt, inv_count)  (sdf_mlp._pe_factored)
    -> (sums [5], ploss [N], (dW, db)).

    CPU tensors take train_op_plain (hidden products in bf16 when
    model.mm_precision == "default", else f32); CUDA tensors launch the
    kernel in the same product mode.
    """
    assert eik_weight != 0.0 or grad_weight != 0.0, \
        "the train op needs the spatial-gradient losses"
    assert pe_in_kernel or not pc_bounds, "pc_bounds needs pe_in_kernel"
    lk = _loss_knobs(model, loss_type, trunc_distance, trunc_weight,
                     eik_apply_dist, eik_weight, grad_weight, orien_loss,
                     free_space_factor)
    mm_dtype = FV.mm_dtype_of(model)

    def run(params, M, Tc, pts, kw, valid, noise, inv_count):
        dev = (pts if pts is not None else kw["pe"]).device
        if dev.type == "cuda":
            return train_op_cuda(params, model, lk, M, Tc, pts, valid, noise,
                                 inv_count, **kw)
        return train_op_plain(params, model, lk, M, Tc, pts, valid, noise,
                              inv_count, mm_dtype=mm_dtype, **kw)

    # (transform, its version, device, M, Tc): the PE constants depend on
    # the scene transform only, so they are built once per transform (an
    # edit in place bumps its version and rebuilds them); holding the
    # tensor keeps its identity unambiguous
    built = [None]

    def consts(transform, dev):
        b = built[0]
        if (b is not None and b[0] is transform and b[2] == dev
                and b[1] == getattr(transform, "_version", None)
                and isinstance(transform, torch.Tensor)):
            return b[3], b[4]
        M, dxs, dproj2 = _pe_consts(model, transform, device=dev)
        Tc = tangent_rows(model, dxs, dproj2).contiguous()
        built[0] = (transform, getattr(transform, "_version", None), dev, M,
                    Tc)
        return M, Tc

    if pc_bounds:
        def op_pc_bounds(params, transform, pts, surf, surf_valid, zd,
                         normals_pt, is_surf, valid, noise, inv_count):
            M, Tc = consts(transform, pts.device)
            return run(params, M, Tc, pts,
                       dict(surf=surf, surf_valid=surf_valid, zd=zd,
                            normals_pt=normals_pt, is_surf=is_surf),
                       valid, noise, inv_count)
        return op_pc_bounds

    if pe_in_kernel:
        def op_pe_in_kernel(params, transform, pts, bounds, valid, noise, gt,
                            inv_count):
            M, Tc = consts(transform, pts.device)
            return run(params, M, Tc, pts, dict(bounds=bounds, gt=gt),
                       valid, noise, inv_count)
        return op_pe_in_kernel

    def op(params, pe, dxs, dproj2, bounds, valid, noise, gt, inv_count):
        Tc = tangent_rows(model, dxs, dproj2).contiguous()
        return run(params, None, Tc, None, dict(bounds=bounds, gt=gt, pe=pe),
                   valid, noise, inv_count)
    return op
