"""The SDF MLP: a static model description plus pure functions on tensors.

Architecture (reference SDFMap, isdf/modules/fc_map.py:63-111;
isdf_tpu/models/sdf_mlp.py):

    pe  = encode(x)                                  # E = 255 by default
    h   = sp(W_in pe + b)                            # H = 256
    h   = blocks1(h)                                 # hidden_layers_block x
    h   = sp(W_cat [h, pe] + b)                      # skip connection
    h   = blocks2(h)
    sdf = scale_output * (W_out h + b [+ noise])

with sp = Softplus(beta=100). Xavier-normal weights, U(+-1/sqrt(fan_in))
biases.

Parameters live in ONE packed layout, the train kernel's operand layout
(isdf_tpu/models/pallas_mlp.py::pack_params_train, generalised to any
hidden width):

    Wp [L, 2K, H] f32, K = max(H, E) rounded up to 16
       layer l's weight [fan_in, fan_out] at rows 0:fan_in; the skip
       layer's pe rows at K:K+E; the output layer's [H, 1] weight in
       column 0
    bp [L, H] f32, the output bias at bp[L-1, 0]

with L = 2 * hidden_layers_block + 3 and every padded entry zero. At
H = 256, E = 255 this is exactly the JAX package's [L, 512, 256] plane, so
the optimiser runs elementwise on these planes and the kernel reads them
as they are. With the Gaussian embedding (``gauss_embed``) the params also
hold its matrix ``B`` [3, (E - 3) / 2], trained with the MLP as isdf_tpu
trains it. ``params_from_jax`` / ``params_to_jax`` convert from / to the
JAX pytree (keys in/mid1/cat/mid2/out[/B], w stored [fan_in, fan_out]).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from isdf_tpu_torch.ops import embedding as emb

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SDFModel:
    """Static model description."""
    embedding_size: int = 255
    hidden_size: int = 256
    hidden_layers_block: int = 2
    scale_output: float = 0.14
    scale_input: float = 0.05937489
    min_deg: int = 0
    max_deg: int = 5
    # hidden products of the MLP kernels: "default" = bf16 x bf16 -> f32
    # (the JAX package's default), anything else = f32
    mm_precision: str = "default"
    gauss_embed: bool = False
    gauss_embed_std: float = 11.0
    # the eager forward's hidden dtype (tpu.compute_dtype): "bfloat16"
    # casts the PE, the weights and the hidden activations to bf16 and
    # keeps the output head in float32, as isdf_tpu's apply does; the
    # kernels K1-K3 take their operand type from mm_precision instead
    compute_dtype: str = "float32"

    @property
    def n_layers(self) -> int:
        return 2 * self.hidden_layers_block + 3

    @property
    def cat_idx(self) -> int:
        return 1 + self.hidden_layers_block

    @property
    def pack_rows(self) -> int:
        """K: the row offset of the skip layer's pe rows."""
        k = max(self.hidden_size, self.embedding_size)
        return (k + 15) // 16 * 16

    def encode(self, params: Params, x, transform=None):
        """Positional encoding of world points x [..., 3]."""
        if self.gauss_embed:
            return emb.gaussian_encoding(x, params["B"], transform=transform,
                                         scale=self.scale_input)
        return emb.positional_encoding(
            x, transform=transform, scale=self.scale_input,
            min_deg=self.min_deg, max_deg=self.max_deg)


def layer_shapes(model: SDFModel):
    """[(fan_in, fan_out)] in execution order: in, mid1.., cat, mid2.., out."""
    E, H, B = (model.embedding_size, model.hidden_size,
               model.hidden_layers_block)
    return ([(E, H)] + [(H, H)] * B + [(H + E, H)] + [(H, H)] * B
            + [(H, 1)])


def _pack(model: SDFModel, ws, bs, device="cpu") -> Params:
    """Packed planes from per-layer weights [fan_in, fan_out] and biases."""
    L, H, K = model.n_layers, model.hidden_size, model.pack_rows
    Wp = torch.zeros((L, 2 * K, H), dtype=torch.float32, device=device)
    bp = torch.zeros((L, H), dtype=torch.float32, device=device)
    for l, (w, b) in enumerate(zip(ws, bs)):
        w = torch.as_tensor(w, dtype=torch.float32, device=device)
        b = torch.as_tensor(b, dtype=torch.float32, device=device)
        if l == model.cat_idx:
            Wp[l, :H] = w[:H]
            Wp[l, K:K + w.shape[0] - H] = w[H:]
        else:
            Wp[l, :w.shape[0], :w.shape[1]] = w
        bp[l, :b.shape[0]] = b
    return {"Wp": Wp, "bp": bp}


def unpack(params: Params, model: SDFModel):
    """Per-layer (w [fan_in, fan_out], b [fan_out]) views of the planes."""
    H, K = model.hidden_size, model.pack_rows
    Wp, bp = params["Wp"], params["bp"]
    out = []
    for l, (fi, fo) in enumerate(layer_shapes(model)):
        if l == model.cat_idx:
            w = torch.cat([Wp[l, :H, :fo], Wp[l, K:K + fi - H, :fo]], dim=0)
        else:
            w = Wp[l, :fi, :fo]
        out.append((w, bp[l, :fo]))
    return out


def param_count(params: Params, model: SDFModel) -> int:
    """Trained entries of the map: the layer weights and biases (not the
    packed planes' padding), and B with the Gaussian embedding; isdf_tpu's
    count of its parameter pytree."""
    n = sum(w.numel() + b.numel() for w, b in unpack(params, model))
    return n + (params["B"].numel() if "B" in params else 0)


def init_params(gen: torch.Generator, model: SDFModel,
                device="cpu") -> Params:
    """Xavier-normal weights, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) biases,
    and the Gaussian embedding's B ~ N(0, std^2) where the model has one,
    drawn on the CPU from ``gen`` and moved to ``device``."""
    ws, bs = [], []
    for fi, fo in layer_shapes(model):
        std = math.sqrt(2.0 / (fi + fo))
        ws.append(torch.randn((fi, fo), generator=gen) * std)
        bound = 1.0 / math.sqrt(fi)
        bs.append((torch.rand((fo,), generator=gen) * 2.0 - 1.0) * bound)
    params = _pack(model, ws, bs, device=device)
    if model.gauss_embed:
        params["B"] = emb.init_gaussian_embedding(
            gen, model.gauss_embed_std, (model.embedding_size - 3) // 2,
            device=device)
    return params


def params_from_jax(tree, model: SDFModel, device="cpu") -> Params:
    """The JAX package's init_params pytree (numpy or jax leaves) -> the
    port's packed planes."""
    seq = [tree["in"], *tree["mid1"], tree["cat"], *tree["mid2"],
           tree["out"]]
    params = _pack(model, [np.array(p["w"], np.float32) for p in seq],
                   [np.array(p["b"], np.float32) for p in seq],
                   device=device)
    if "B" in tree:
        params["B"] = torch.as_tensor(np.array(tree["B"], np.float32),
                                      device=device)
    return params


def params_to_jax(params: Params, model: SDFModel):
    """Inverse of params_from_jax: a pytree of float32 numpy arrays."""
    layers = [(w.detach().cpu().numpy().copy(),
               b.detach().cpu().numpy().copy())
              for w, b in unpack(params, model)]
    B = model.hidden_layers_block

    def d(i):
        return {"w": layers[i][0], "b": layers[i][1]}

    tree = {"in": d(0), "mid1": [d(1 + i) for i in range(B)],
            "cat": d(1 + B), "mid2": [d(2 + B + i) for i in range(B)],
            "out": d(2 + 2 * B)}
    if "B" in params:
        tree["B"] = params["B"].detach().cpu().numpy().copy()
    return tree


def copy_params(params: Params) -> Params:
    return {k: v.clone() for k, v in params.items()}


# 0.01 rounded to bf16: in bf16 the constant takes the operand's type, as
# isdf_tpu's weakly typed 0.01 does
_BF16_HUNDREDTH = float(torch.tensor(0.01, dtype=torch.bfloat16))


def _softplus_ops(x, c):
    z = 100.0 * x
    return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))) * c


class _SoftplusBf16(torch.autograd.Function):
    """softplus_b100 in bf16 with isdf_tpu's derivative: JAX
    differentiates logaddexp(z, 0) by its rule exp(z - softplus(z)), each
    op rounded to bf16; autograd through the stable form would round
    other intermediates. The backward recomputes from the saved input, so
    a second derivative (the eikonal loss of the autograd routes) flows.
    ``f32_out``: the last multiply in float32, unrounded (the activation
    the float32 head reads)."""

    @staticmethod
    def forward(ctx, x, f32_out):
        ctx.save_for_backward(x)
        ctx.f32_out = f32_out
        if f32_out:
            return _softplus_ops(x, 1.0).float() * _BF16_HUNDREDTH
        return _softplus_ops(x, _BF16_HUNDREDTH)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        z = 100.0 * x
        sp = torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))
        g = (g * _BF16_HUNDREDTH).to(x.dtype)
        return (g * torch.exp(z - sp)) * 100.0, None


def softplus_b100(x, f32_out: bool = False):
    """Softplus with beta=100, the stable logaddexp form (reference
    fc_map.py:51-55), each op rounded to x's dtype. ``f32_out`` (bf16
    only): the final scaling in float32, as isdf_tpu's jitted forward
    leaves the activation its float32 head reads (XLA keeps the excess
    precision of a bf16 result converted straight back to float32)."""
    if x.dtype == torch.bfloat16:
        return _SoftplusBf16.apply(x, f32_out)
    return _softplus_ops(x, 0.01)


def hidden_dtype(model: SDFModel) -> torch.dtype:
    return (torch.bfloat16 if model.compute_dtype == "bfloat16"
            else torch.float32)


def apply(params: Params, x, model: SDFModel, transform=None):
    """SDF value at world points x [..., 3] -> [...], float32. The hidden
    layers run in ``model.compute_dtype`` (each product, bias add and
    activation rounded to it, as isdf_tpu's _linear and softplus are), the
    output head in float32 (isdf_tpu sdf_mlp.py:113-131)."""
    dt = hidden_dtype(model)
    layers = unpack(params, model)
    pe = model.encode(params, x, transform=transform).to(dt)
    h = pe
    last = len(layers) - 2
    for l, (w, b) in enumerate(layers[:-1]):
        if l == model.cat_idx:
            h = torch.cat([h, pe], dim=-1)
        h = softplus_b100(h @ w.to(dt) + b.to(dt), f32_out=l == last)
    w, b = layers[-1]
    return (h.float() @ w + b)[..., 0] * model.scale_output


def apply_with_noise(params, x, model: SDFModel, gen, noise_std,
                     transform=None, noise=None):
    """Forward with Gaussian output noise added to the raw output before
    scale_output (reference fc_map.py:106-109). ``noise`` overrides the
    standard-normal draw from ``gen``."""
    raw = apply(params, x, model, transform=transform) / model.scale_output
    if noise is None:
        noise = torch.randn(raw.shape, generator=gen, device=raw.device)
    return (raw + noise * noise_std) * model.scale_output


def sdf_and_grad(params, x, model: SDFModel, transform=None):
    """SDF values and spatial gradients d sdf / d x at points [..., 3]."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sdf = apply(params, xg, model, transform=transform)
        (g,) = torch.autograd.grad(sdf.sum(), xg)
    return sdf.detach(), g


def _scale(model: SDFModel) -> float:
    """scale_input as float32: a Python number multiplies a float32
    tensor in float32, and needs no copy to the card."""
    return float(np.float32(model.scale_input))


def _pe_factored(x, model: SDFModel, transform):
    """The PE of points x [N, 3] with its Jacobian in factored form:
    (pe [N,E], cos_b [N,2F], dxs [3,3], dproj2 [3,2F]), F = 21 * n_freqs
    (isdf_tpu/models/sdf_mlp.py::_pe_factored). The tangent of pe along
    world axis k is [dxs[k] | cos_b * dproj2[k]], and cos_b =
    [cos(xb), -sin(xb)] is a column permutation of pe. IEEE float32; the
    cos lanes are cos(xb) here, where the in-kernel PE takes
    sin(xb + pi/2)."""
    dev = x.device
    nf = emb.n_freqs(model.min_deg, model.max_deg)
    b, D = emb._device_consts(model.min_deg, model.max_deg, dev)  # D [3,21]
    s = _scale(model)
    if transform is not None:
        T = torch.as_tensor(transform, dtype=torch.float32, device=dev)
        R, t = T[:3, :3], T[:3, 3]
        xs = (x @ R.T + t) * s
        C = s * (R.T @ D)
        dxs = s * R.T
    else:
        xs = x * s
        C = s * D
        dxs = s * torch.eye(3, dtype=torch.float32, device=dev)
    proj = xs @ D                                                # [N, 21]
    F = D.shape[1] * nf
    xb = (proj[:, :, None] * b).reshape(-1, F)
    sin_b, cos_half = torch.sin(xb), torch.cos(xb)
    pe = torch.cat([xs, sin_b, cos_half], dim=-1)
    cos_b = torch.cat([cos_half, -sin_b], dim=-1)
    dproj = (C[:, :, None] * b).reshape(3, F)
    return pe, cos_b, dxs, torch.cat([dproj, dproj], dim=-1)


def _pe_consts(model: SDFModel, transform, device="cpu"):
    """Point-independent pieces of the factored PE, for building the
    encoding inside the train kernel:

      M [128, max(256, K)] f32 — packed affine plane (K = pack_rows):
        for r = [x, y, z, 1, 0...], pre = r @ M has lanes
        [xs(3) | xb(F) | xb(F) | 0], so
        pe = [pre[:3], sin(pre[3:3+F]), cos(pre[3+F:3+2F])];
      dxs [3, 3], dproj2 [3, 2F] — the PE Jacobian's constant factors.
    """
    nf = emb.n_freqs(model.min_deg, model.max_deg)
    b, D = emb._device_consts(model.min_deg, model.max_deg, device)
    s = _scale(model)
    if transform is not None:
        T = torch.as_tensor(transform, dtype=torch.float32, device=device)
        R, t = T[:3, :3], T[:3, 3]
    else:
        R = torch.eye(3, dtype=torch.float32, device=device)
        t = torch.zeros(3, dtype=torch.float32, device=device)
    A = s * R
    c = s * t
    C = s * (R.T @ D)
    dxs = s * R.T
    F = D.shape[1] * nf
    dproj = (C[:, :, None] * b).reshape(3, F)
    dproj2 = torch.cat([dproj, dproj], dim=-1)
    P = (D[:, :, None] * b).reshape(3, F)
    AP = A.T @ P
    cP = c @ P
    M = torch.zeros((128, max(256, model.pack_rows)), dtype=torch.float32,
                    device=device)
    M[:3, :3] = A.T
    M[3, :3] = c
    M[:3, 3:3 + F] = AP
    M[3, 3:3 + F] = cP
    M[:3, 3 + F:3 + 2 * F] = AP
    M[3, 3 + F:3 + 2 * F] = cP
    return M, dxs, dproj2
