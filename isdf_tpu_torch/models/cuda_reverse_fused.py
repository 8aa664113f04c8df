"""The reverse-fused SDF MLP with both directions in CUDA kernels.

Port of isdf_tpu/models/pallas_mlp.py::make_pallas_reverse_fused: a
differentiable op (params, pe [N,E], cos_b [N,2F], dxs [3,3], dproj2 [3,2F])
-> (raw [N], graw [N,3]) whose forward is the kernel K2 (TPU kernel
``_make_kernel_f``) and whose backward is the kernel K3 (``_make_kernel_b``),
both in csrc/reverse_fused.cu (sm_90a), built at first use; for
mm_precision other than "default" their f32-product mode,
csrc/reverse_fused_f32.cu.

* K2: forward, reverse v-chain and the factored tangent contraction.
* K3: the parameter VJP from (draw, dgraw) through the combined tangent,
  written straight into the packed planes (models/sdf_mlp.py) with exact
  zeros in the padding. Nothing flows to pe, cos_b, dxs or dproj2, as the
  TPU op returns zeros for them. cos_b is taken for the signature: the
  kernels derive it from pe.

The plain version of both is models/fused_vjp.py::make_reverse_fused_mlp
(the oracle isdf_tpu names for its kernels): ``make_cuda_reverse_fused``
takes it for CPU tensors and launches the kernels for CUDA tensors; it
never falls back. ``LAUNCHES`` counts the kernels' launches.
"""

from __future__ import annotations

import torch

from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp
from isdf_tpu_torch.models.sdf_mlp import SDFModel
from isdf_tpu_torch.utils import nvcc

# kernel launches, "-f32" the f32-product mode; only the wrappers below
# add to them
LAUNCHES = {"K2": 0, "K3": 0, "K2-f32": 0, "K3-f32": 0}


def _inputs(params, model: SDFModel, pe, Tc):
    K.check_kernel_model(model, K.HID, "K2/K3 (the reverse-fused op)")
    N = pe.shape[0]
    K._check("pe", pe, (N, model.embedding_size))
    K._check("Tc", Tc, (3, K.HID))
    ptrs = K.weight_args(params, model)
    ptrs.update(pe_in=pe, Tc=Tc)
    return N, K._round_up(N, K.TM), ptrs


def _lib(model: SDFModel):
    """(library, launch-count suffix) of the model's product mode."""
    return (nvcc.load(K.source("reverse_fused", model)),
            "-f32" if K.is_f32(model) else "")


def rf_forward_cuda(params, model: SDFModel, pe, Tc):
    """K2 on the current stream -> (raw [N], graw [N, 3])."""
    N, NP, ptrs = _inputs(params, model, pe, Tc)
    dev = pe.device
    ptrs.update(pe32=torch.empty(NP, K.HID, device=dev),
                sig=torch.empty(model.n_layers - 1, NP, K.HID, device=dev),
                raw_out=torch.empty(N, device=dev),
                graw_out=torch.empty(N, 3, device=dev))
    lib, suffix = _lib(model)
    K.launch(lib, "isdf_rf_forward", model, N, ptrs)
    nvcc.count_launch(LAUNCHES, "K2" + suffix)
    return ptrs["raw_out"], ptrs["graw_out"]


def rf_backward_cuda(params, model: SDFModel, pe, Tc, draw, dgraw):
    """K3 on the current stream -> (dWp, dbp) on the packed planes."""
    N, _, ptrs = _inputs(params, model, pe, Tc)
    K._check("draw", draw, (N,))
    K._check("dgraw", dgraw, (N, 3))
    ptrs.update(K.vjp_scratch(model, N, pe.device))
    ptrs.update(draw_in=draw, dg_in=dgraw)
    lib, suffix = _lib(model)
    K.launch(lib, "isdf_rf_backward", model, N, ptrs)
    nvcc.count_launch(LAUNCHES, "K3" + suffix)
    return ptrs["dW"], ptrs["db"]


class _CudaReverseFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Wp, bp, pe, Tc, model):
        ctx.save_for_backward(Wp, bp, pe, Tc)
        ctx.model = model
        return rf_forward_cuda({"Wp": Wp, "bp": bp}, model, pe, Tc)

    @staticmethod
    def backward(ctx, draw, dgraw):
        Wp, bp, pe, Tc = ctx.saved_tensors
        dW, db = rf_backward_cuda({"Wp": Wp, "bp": bp}, ctx.model, pe, Tc,
                                  draw.contiguous(), dgraw.contiguous())
        return dW, db, None, None, None


def make_cuda_reverse_fused(model: SDFModel):
    """op(params, pe, cos_b, dxs, dproj2) -> (raw, graw): the kernels on
    CUDA tensors, make_reverse_fused_mlp's plain op on CPU tensors."""
    plain = make_reverse_fused_mlp(model)

    def fused(params, pe, cos_b, dxs, dproj2):
        if pe.device.type != "cuda":
            return plain(params, pe, cos_b, dxs, dproj2)
        Tc = K.tangent_rows(model, dxs, dproj2).contiguous()
        return _CudaReverseFused.apply(params["Wp"], params["bp"],
                                       pe.contiguous(), Tc, model)

    return fused
