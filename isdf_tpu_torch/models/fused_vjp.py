"""Hand-derived value + spatial-gradient MLP with a custom backward
(isdf_tpu/models/fused_vjp.py on the port's packed planes).

For the iSDF MLP this computes (raw sdf, d raw / dx) from the factored PE
(sdf_mlp._pe_factored) by the reverse v-chain, and implements the
parameter VJP by hand through ONE combined tangent

    m0 = [dg dxs | cos_b * (dg dproj2)]          (<dg, grad f> = jvp along m0)
    u_l = ta_{l-1} W_l,  t_l = u_l sig_l          tangent chain
    dz_l = dh_l sig_l + (dt_l u_l) sig'_l,  du_l = dt_l sig_l
    dW_l = a_{l-1}^T dz_l + ta_{l-1}^T du_l,  db_l = sum dz_l
    dh, dt <- dz W_l^T, du W_l^T                  (pe slice dropped at the
                                                   skip-concat layer)

with sig = sigmoid(100 z) and sig' = 100 sig (1 - sig). No gradient flows
to pe, cos_b, dxs or dproj2: they depend on the sample positions only.

The gradient is written into the packed planes (models/sdf_mlp.py) with
exact zeros in every padded entry, so AdamW on the planes
(models/fused_adamw.py) is AdamW on the layer pytree
(isdf_tpu/models/pallas_mlp.py:103-117).

Precision: the hidden products round their operands to ``mm_dtype`` (bf16
when model.mm_precision == "default", as isdf_tpu's DEFAULT matmuls do on
the TPU; float32 otherwise) and accumulate in float32. The output head,
the biases and the tangent contractions stay float32.

The forward, the v-chain and the parameter VJP here are also the plain
version of the fused train op (models/cuda_mlp.py::train_op_plain), and
this op is the plain version of the K2/K3 kernels
(models/cuda_reverse_fused.py).
"""

from __future__ import annotations

import torch

from isdf_tpu_torch.models.sdf_mlp import SDFModel


def mm_dtype_of(model: SDFModel):
    return torch.bfloat16 if model.mm_precision == "default" else torch.float32


def _rnd(x, mm_dtype):
    return x if mm_dtype == torch.float32 else x.to(mm_dtype).float()


def _mm(a, w, mm_dtype):
    return _rnd(a, mm_dtype) @ _rnd(w, mm_dtype)


def sig_sp(z):
    """sigmoid(100 z) and softplus(100 z) / 100 from one exp(-|100 z|)."""
    x = 100.0 * z
    e = torch.exp(-x.abs())
    inv = 1.0 / (1.0 + e)
    sig = torch.where(x >= 0, inv, e * inv)
    h = (torch.clamp(x, min=0.0) + torch.log1p(e)) * 0.01
    return sig, h


def _w_in(params, model: SDFModel, l: int):
    """The main-input weight rows of layer l (pe rows for layer 0)."""
    Wp = params["Wp"]
    return Wp[l, :model.embedding_size] if l == 0 else \
        Wp[l, :model.hidden_size]


def _w_pe(params, model: SDFModel):
    """The skip layer's pe rows."""
    K, E = model.pack_rows, model.embedding_size
    return params["Wp"][model.cat_idx, K:K + E]


def forward_values(params, model: SDFModel, pe, mm_dtype):
    """Forward from pe [N, E]. Returns (raw [N], sigs, hs): sig_l and the
    output h_l of every hidden layer."""
    bp, L = params["bp"], model.n_layers
    h = pe
    sigs, hs = [], []
    for l in range(L - 1):
        z = _mm(h, _w_in(params, model, l), mm_dtype)
        if l == model.cat_idx:
            z = z + _mm(pe, _w_pe(params, model), mm_dtype)
        sig, h = sig_sp(z + bp[l])
        sigs.append(sig)
        hs.append(h)
    w_out = params["Wp"][L - 1, :model.hidden_size, 0]
    raw = (h * w_out).sum(-1) + bp[L - 1, 0]
    return raw, sigs, hs


def v_chain(params, model: SDFModel, sigs, mm_dtype):
    """d raw / d pe [N, E]: the reverse chain of the in-layer and skip
    paths."""
    L, H = model.n_layers, model.hidden_size
    w_out = params["Wp"][L - 1, :H, 0]
    v = w_out.expand_as(sigs[-1])
    vpe = 0.0
    for l in range(L - 2, -1, -1):
        vs = v * sigs[l]
        if l == model.cat_idx:
            vpe = vpe + _mm(vs, _w_pe(params, model).T, mm_dtype)
        v = _mm(vs, _w_in(params, model, l).T, mm_dtype)
    return vpe + v


def param_vjp(params, model: SDFModel, pe, m0, sigs, hs, draw, mm_dtype):
    """(dWp, dbp) on the packed planes from the cotangent of raw (draw
    [N]) and the combined tangent m0 [N, E] of the spatial gradient's
    cotangent; every padded entry is exactly zero."""
    Wp, bp = params["Wp"], params["bp"]
    L, H, K, E = (model.n_layers, model.hidden_size, model.pack_rows,
                  model.embedding_size)
    cat = model.cat_idx
    nh = L - 1
    # ---- tangent chain ----
    t = m0
    us, ts = [], []
    for l in range(nh):
        u = _mm(t, _w_in(params, model, l), mm_dtype)
        if l == cat:
            u = u + _mm(m0, _w_pe(params, model), mm_dtype)
        t = u * sigs[l]
        us.append(u)
        ts.append(t)

    dW = torch.zeros_like(Wp)
    db = torch.zeros_like(bp)
    w_out = Wp[L - 1, :H, 0]
    draw = draw[:, None]
    dW[L - 1, :H, 0] = (hs[-1] * draw).sum(0) + t.sum(0)
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
            dh = _mm(dz, _w_in(params, model, l).T, mm_dtype)
            dt = _mm(du, _w_in(params, model, l).T, mm_dtype)
    return dW, db


def _primal(params, model, pe, cos_b, dxs, dproj2, mm_dtype):
    raw, sigs, _ = forward_values(params, model, pe, mm_dtype)
    vpe = v_chain(params, model, sigs, mm_dtype)
    graw = vpe[:, :3] @ dxs.T + (cos_b * vpe[:, 3:]) @ dproj2.T
    return raw, graw


class _ReverseFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Wp, bp, pe, cos_b, dxs, dproj2, model, mm_dtype):
        ctx.save_for_backward(Wp, bp, pe, cos_b, dxs, dproj2)
        ctx.model, ctx.mm_dtype = model, mm_dtype
        return _primal({"Wp": Wp, "bp": bp}, model, pe, cos_b, dxs, dproj2,
                       mm_dtype)

    @staticmethod
    def backward(ctx, draw, dgraw):
        Wp, bp, pe, cos_b, dxs, dproj2 = ctx.saved_tensors
        params = {"Wp": Wp, "bp": bp}
        m0 = torch.cat([dgraw @ dxs, cos_b * (dgraw @ dproj2)], dim=1)
        # recompute the residuals instead of saving them
        _, sigs, hs = forward_values(params, ctx.model, pe, ctx.mm_dtype)
        dW, db = param_vjp(params, ctx.model, pe, m0, sigs, hs, draw,
                           ctx.mm_dtype)
        return dW, db, None, None, None, None, None, None


def make_reverse_fused_mlp(model: SDFModel):
    """op(params, pe [N,E], cos_b [N,2F], dxs [3,3], dproj2 [3,2F]) ->
    (raw [N], graw [N,3]), differentiable in params["Wp"], params["bp"]."""
    mm_dtype = mm_dtype_of(model)

    def fused(params, pe, cos_b, dxs, dproj2):
        return _ReverseFused.apply(params["Wp"], params["bp"], pe, cos_b,
                                   dxs, dproj2, model, mm_dtype)

    return fused
