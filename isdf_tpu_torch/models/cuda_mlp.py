"""The fused train op: loss AND parameter gradients of one ray batch.

Port of isdf_tpu/models/pallas_mlp.py::make_pallas_train_op (the TPU
kernel ``_make_kernel_train``, variants ``op_pc_bounds`` and
``op_pe_in_kernel``). One call computes, for N sample points:

  * the PE from the world points (one f32 affine map + sin);
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
    use into a directory .gitignore lists, and bound through ctypes.

``make_train_op`` returns a function that takes the plain version for CPU
tensors and launches the kernel for CUDA tensors; it never falls back.
``LAUNCHES`` counts kernel launches per variant.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from isdf_tpu_torch.models.sdf_mlp import SDFModel, _pe_consts

HID = 256
TM = 64           # rows per tile of the kernel's first phase
N_SPLITS = 8      # split-K partials of the dW products
HALF_PI = float(np.float32(np.pi / 2))

# kernel launches per variant; only the wrapper below adds to them
LAUNCHES = {"K1-pc": 0, "K1-ray": 0}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "train_mlp.cu")
_LIB = None
_LIB_LOCK = threading.Lock()
BUILD_INFO = {}


def build_dir() -> str:
    return os.environ.get(
        "ISDF_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "_build"))


def load_library():
    """Build (first use; the library is keyed by the source's hash) and
    load the kernel library. nvcc's -Xptxas -v report lands in
    BUILD_INFO["nvcc_log"]."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.perf_counter()
        with open(_SRC, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        out = os.path.join(build_dir(), f"libisdf_train_mlp_{digest}.so")
        if not os.path.exists(out):
            os.makedirs(build_dir(), exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            r = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", tmp, _SRC],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            BUILD_INFO["nvcc_log"] = r.stdout
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{r.stdout}")
            os.replace(tmp, out)
        BUILD_INFO["build_s"] = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        lib.isdf_train_mlp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p]
        lib.isdf_train_mlp.restype = ctypes.c_int
        _LIB = lib
        return lib


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


def tangent_rows(model: SDFModel, dxs, dproj2):
    """Tc [3, 256] f32: row k = [dxs[k] | dproj2[k] | 0]."""
    E = model.embedding_size
    T = torch.zeros((3, max(HID, E)), dtype=torch.float32,
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

def _rnd(x, mm_dtype):
    return x if mm_dtype == torch.float32 else x.to(mm_dtype).float()


def _sig_sp(z):
    x = 100.0 * z
    e = torch.exp(-x.abs())
    inv = 1.0 / (1.0 + e)
    sig = torch.where(x >= 0, inv, e * inv)
    h = (torch.clamp(x, min=0.0) + torch.log1p(e)) * 0.01
    return sig, h


def train_op_plain(params, model: SDFModel, lk, M, Tc, pts, valid, noise,
                   inv_count, *, bounds=None, gt=None, surf=None,
                   surf_valid=None, zd=None, normals_pt=None, is_surf=None,
                   mm_dtype=torch.bfloat16):
    """Eager-torch train op. pc variant when ``surf`` is given (then zd,
    normals_pt, is_surf, surf_valid), else ray variant (bounds, gt).
    Returns (sums [5], ploss [N], (dW like Wp, db like bp))."""
    E, H, K = model.embedding_size, model.hidden_size, model.pack_rows
    L, cat = model.n_layers, model.cat_idx
    nh = L - 1
    F = (E - 3) // 2
    Wp, bp = params["Wp"], params["bp"]
    dev = pts.device
    so = lk["so"]
    x, y, z = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]

    # ---- PE (the kernel's rounding order) ----
    Me = M[:, :E]
    pre = ((x * Me[0] + y * Me[1]) + z * Me[2]) + Me[3]
    lane = torch.arange(E, device=dev)
    cos_lane = lane >= 3 + F
    s = torch.sin(pre + torch.where(cos_lane, HALF_PI, 0.0))
    pe = torch.where(lane < 3, pre, s)
    cb = torch.cat([torch.ones_like(pe[:, :3]), pe[:, 3 + F:],
                    -pe[:, 3:3 + F]], dim=1)

    # ---- bounds and gradient targets ----
    if surf is not None:
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

    def mm(a, w):
        return _rnd(a, mm_dtype) @ _rnd(w, mm_dtype)

    def w_in(l):          # main-input rows of layer l
        return Wp[l, :E] if l == 0 else Wp[l, :H]

    # ---- forward ----
    h = pe
    sigs, hs = [], []
    for l in range(nh):
        zz = mm(h, w_in(l))
        if l == cat:
            zz = zz + mm(pe, Wp[l, K:K + E])
        sig, h = _sig_sp(zz + bp[l])
        sigs.append(sig)
        hs.append(h)
    w_out = Wp[L - 1, :H, 0]
    raw = (h * w_out).sum(-1, keepdim=True) + bp[L - 1, 0]

    # ---- v-chain -> spatial gradient ----
    v = w_out.expand_as(h)
    vpe = torch.zeros_like(pe)
    for l in range(nh - 1, -1, -1):
        vs = v * sigs[l]
        if l == cat:
            vpe = vpe + mm(vs, Wp[l, K:K + E].T)
        v = mm(vs, w_in(l).T)
    vpe = vpe + v
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

    # ---- combined tangent + tangent chain ----
    dgT = dg @ Tc[:, :E]
    m0 = torch.where(lane < 3, dgT, cb * dgT)
    t = m0
    us, ts = [], []
    for l in range(nh):
        u = mm(t, w_in(l))
        if l == cat:
            u = u + mm(m0, Wp[l, K:K + E])
        t = u * sigs[l]
        us.append(u)
        ts.append(t)

    dW = torch.zeros_like(Wp)
    db = torch.zeros_like(bp)
    dW[L - 1, :H, 0] = (h * draw).sum(0) + t.sum(0)
    db[L - 1, 0] = draw.sum()

    def mm_c(a, b_):       # a^T b over the rows
        return _rnd(a, mm_dtype).T @ _rnd(b_, mm_dtype)

    dh = draw * w_out
    dt = w_out.expand_as(dh)
    for l in range(nh - 1, -1, -1):
        sig, u = sigs[l], us[l]
        sigp = 100.0 * sig * (1.0 - sig)
        du = dt * sig
        dz = dh * sig + (dt * u) * sigp
        a_in = pe if l == 0 else hs[l - 1]
        ta_in = m0 if l == 0 else ts[l - 1]
        dW[l, :a_in.shape[1]] = mm_c(a_in, dz) + mm_c(ta_in, du)
        if l == cat:
            dW[l, K:K + E] = mm_c(pe, dz) + mm_c(m0, du)
        db[l] = dz.sum(0)
        if l > 0:
            dh = mm(dz, w_in(l).T)
            dt = mm(du, w_in(l).T)
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


def train_op_cuda(params, model: SDFModel, lk, M, Tc, pts, valid, noise,
                  inv_count, *, bounds=None, gt=None, surf=None,
                  surf_valid=None, zd=None, normals_pt=None, is_surf=None):
    """Launch the kernel (three phases on the current stream). Same
    arguments and results as train_op_plain with mm_dtype=bf16."""
    if model.hidden_size != HID or model.embedding_size > HID:
        raise ValueError("the train kernel needs hidden_size == 256 and "
                         "an embedding of at most 256 lanes")
    if model.mm_precision != "default":
        raise NotImplementedError(
            "the train kernel runs bf16 hidden products only "
            "(mm_precision='default')")
    pc = surf is not None
    N = pts.shape[0]
    L = model.n_layers
    nh = L - 1
    dev = pts.device
    Wp, bp = params["Wp"], params["bp"]
    _check("Wp", Wp, (L, 2 * HID, HID))
    _check("bp", bp, (L, HID))
    _check("pts", pts, (N, 3))
    _check("valid", valid, (N,))
    _check("noise", noise, (N,))
    _check("inv_count", inv_count, ())
    _check("M", M, (128, HID))
    _check("Tc", Tc, (3, HID))
    if pc:
        R = surf.shape[0]
        _check("surf", surf, (R, 3))
        _check("surf_valid", surf_valid, (R,))
        _check("zd", zd, (N,))
        _check("normals_pt", normals_pt, (N, 3))
        _check("is_surf", is_surf, (N,))
        col_a, vec3 = zd, normals_pt
        sp = score_plane(surf, surf_valid)
    else:
        R = 0
        _check("bounds", bounds, (N,))
        _check("gt", gt, (N, 3))
        col_a, vec3, sp = bounds, gt, None
        surf = is_surf = None

    lib = load_library()
    NP = _round_up(N, TM)
    n_tiles = NP // TM
    rps = _round_up(-(-NP // N_SPLITS), 16)
    W16 = Wp.to(torch.bfloat16).contiguous()
    w_out = Wp[L - 1, :HID, 0].contiguous()
    Mc = M[:4].contiguous()

    f32, b16 = torch.float32, torch.bfloat16

    def e(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    ploss, sums = e(N), e(5)
    dW, db = e(L, 2 * HID, HID), e(L, HID)
    scratch = dict(
        pe32=e(NP, HID), sig=e(nh, NP, HID), u=e(nh, NP, HID),
        h5=e(NP, HID), t5=e(NP, HID),
        peb=e(NP, HID, dtype=b16), m0b=e(NP, HID, dtype=b16),
        hb=e(max(nh - 1, 1), NP, HID, dtype=b16),
        tb=e(max(nh - 1, 1), NP, HID, dtype=b16),
        dzb=e(nh, NP, HID, dtype=b16), dub=e(nh, NP, HID, dtype=b16),
        part_scal=e(n_tiles, 8), part_db=e(n_tiles, L * HID),
        part_dwout=e(n_tiles, HID), part_dw=e(N_SPLITS, nh + 1, HID, HID))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ptrs = [pts, valid, noise, col_a, vec3, is_surf, sp, surf, Mc, Tc, bp,
            w_out, inv_count, W16, ploss, sums, dW, db,
            *(scratch[k] for k in ("pe32", "sig", "u", "h5", "t5", "peb",
                                   "m0b", "hb", "tb", "dzb", "dub",
                                   "part_scal", "part_db", "part_dwout",
                                   "part_dw"))]
    p_arr = (ctypes.c_longlong * len(ptrs))(*[ptr(t) for t in ptrs])
    k_arr = (ctypes.c_float * 7)(lk["so"], lk["trunc_d"], lk["tw"], lk["gw"],
                                 lk["ew"], lk["ead"], lk["fsf"])
    i_arr = (ctypes.c_int * 11)(N, NP, R, L, model.cat_idx,
                                model.embedding_size,
                                int(lk["loss_type"] == "L1"),
                                int(lk["orien"]), N_SPLITS, rps, int(pc))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.isdf_train_mlp(p_arr, k_arr, i_arr, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"train_mlp kernel launch failed: CUDA error {rc}")
    LAUNCHES["K1-pc" if pc else "K1-ray"] += 1
    return sums, ploss, (dW, db)


def make_train_op(model: SDFModel, *, loss_type: str, trunc_distance: float,
                  trunc_weight: float, eik_apply_dist: float,
                  eik_weight: float, grad_weight: float, orien_loss: bool,
                  free_space_factor: float = 5.0, pc_bounds: bool = False):
    """Fused train op (isdf_tpu make_pallas_train_op with
    pe_in_kernel=True and packed_io=True).

    pc_bounds=True: op(params, transform, pts [N,3], surf [R,3],
        surf_valid [R] f32, zd [N], normals_pt [N,3], is_surf [N] f32,
        valid [N] f32, noise [N], inv_count [])
    else:           op(params, transform, pts, bounds [N], valid, noise,
        gt [N,3], inv_count)
    -> (sums [5], ploss [N], (dW, db)).

    CPU tensors take train_op_plain (hidden products in bf16 when
    model.mm_precision == "default", else f32); CUDA tensors launch the
    kernel.
    """
    assert eik_weight != 0.0 or grad_weight != 0.0, \
        "the train op needs the spatial-gradient losses"
    lk = _loss_knobs(model, loss_type, trunc_distance, trunc_weight,
                     eik_apply_dist, eik_weight, grad_weight, orien_loss,
                     free_space_factor)
    mm_dtype = (torch.bfloat16 if model.mm_precision == "default"
                else torch.float32)

    def consts(transform, dev):
        M, dxs, dproj2 = _pe_consts(model, transform, device=dev)
        return M, tangent_rows(model, dxs, dproj2).contiguous()

    def run(params, transform, pts, kw, valid, noise, inv_count):
        M, Tc = consts(transform, pts.device)
        if pts.device.type == "cuda":
            return train_op_cuda(params, model, lk, M, Tc, pts, valid, noise,
                                 inv_count, **kw)
        return train_op_plain(params, model, lk, M, Tc, pts, valid, noise,
                              inv_count, mm_dtype=mm_dtype, **kw)

    if pc_bounds:
        def op_pc_bounds(params, transform, pts, surf, surf_valid, zd,
                         normals_pt, is_surf, valid, noise, inv_count):
            return run(params, transform, pts,
                       dict(surf=surf, surf_valid=surf_valid, zd=zd,
                            normals_pt=normals_pt, is_surf=is_surf),
                       valid, noise, inv_count)
        return op_pc_bounds

    def op_pe_in_kernel(params, transform, pts, bounds, valid, noise, gt,
                        inv_count):
        return run(params, transform, pts, dict(bounds=bounds, gt=gt),
                   valid, noise, inv_count)
    return op_pe_in_kernel
