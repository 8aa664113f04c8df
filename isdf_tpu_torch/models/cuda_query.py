"""The serve engine's query kernel: the SDF values, or their spatial
gradients, of a chunk of points in one launch (csrc/query_mlp.cu, sm_90a),
built at first use.

It replaces no TPU kernel: isdf_tpu answers a query with one jitted,
XLA-fused program. Its plain version is the eager chain of
models/sdf_mlp.py, ``apply`` and ``sdf_and_grad`` (``query_plain``), which
stays the route for CPU tensors, bf16 maps and the Gaussian embedding.
``supports`` says which maps and devices the kernel takes; ``query_cuda``
launches it on CUDA tensors or raises; ``query_preact`` also returns the
hidden pre-activations, for the tests. ``LAUNCHES`` counts the serve
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from isdf_tpu_torch.models import sdf_mlp as M
from isdf_tpu_torch.models.cuda_mlp import HID, TM, _check
from isdf_tpu_torch.ops import embedding as emb
from isdf_tpu_torch.utils import nvcc

MAX_NF = 6  # frequency bands: E = 42 nf + 3 <= 256

# kernel launches; only query_cuda adds to them
LAUNCHES = {"query_sdf": 0, "query_grad": 0}


def supports(model: M.SDFModel, device) -> bool:
    """Whether the kernel answers queries on this map on ``device``: a CUDA
    device, the icosahedron PE, float32 hidden layers, hidden width 256 and
    an embedding of at most 256 lanes."""
    nf = emb.n_freqs(model.min_deg, model.max_deg)
    return (torch.device(device).type == "cuda" and not model.gauss_embed
            and model.compute_dtype == "float32"
            and model.hidden_size == HID and 1 <= nf <= MAX_NF
            and model.embedding_size
            == emb.embedding_size(model.min_deg, model.max_deg))


def query_plain(params, x, model: M.SDFModel, transform, out, grad: bool):
    """The eager chain: SDF values [n] (or gradients [n, 3]) of points x
    [n, 3] into ``out``."""
    if grad:
        out.copy_(M.sdf_and_grad(params, x, model, transform=transform)[1])
    else:
        with torch.no_grad():
            out.copy_(M.apply(params, x, model, transform=transform))


@functools.lru_cache(maxsize=None)
def _resident(device_index: int):
    """(k_query_sdf, k_query_grad) blocks the card holds at once."""
    with torch.cuda.device(device_index):
        out = (ctypes.c_int * 3)()
        fn = nvcc.load("query_mlp").isdf_query_occupancy
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"isdf_query_occupancy: CUDA error {rc}")
    return out[0] * out[2], out[1] * out[2]


def query_cuda(params, x, model: M.SDFModel, transform, out, grad: bool):
    """One launch on the current stream: SDF values [n] (or gradients
    [n, 3]) of points x [n, 3] into ``out``, the scene frame from
    ``transform`` [4, 4]."""
    _launch("query_grad" if grad else "query_sdf", params, x, model,
            transform, out)


def query_preact(params, x, model: M.SDFModel, transform):
    """The values kernel with each hidden layer's pre-activation written
    out, for the tests: (values [n], pre-activations [L - 1, n, 256])."""
    n = x.shape[0]
    out = torch.empty((n,), device=x.device)
    zout = torch.empty((model.n_layers - 1, n, HID), device=x.device)
    _launch("query_preact", params, x, model, transform, out, zout)
    return out, zout


def _launch(key, params, x, model, transform, out, zout=None):
    n = x.shape[0]
    grad = key == "query_grad"
    L, K = model.n_layers, model.pack_rows
    _check("x", x, (n, 3))
    if not supports(model, x.device):
        raise ValueError("the query kernel takes float32 maps with the "
                         "icosahedron PE, hidden width 256 and at most 256 "
                         "embedding lanes")
    _check("transform", transform, (4, 4))
    _check("Wp", params["Wp"], (L, 2 * K, HID))
    _check("bp", params["bp"], (L, HID))
    _check("out", out, (n, 3) if grad else (n,))
    dev = x.device
    bands, D = emb._device_consts(model.min_deg, model.max_deg, dev)
    grid = min(-(-n // TM), _resident(dev.index)[grad])
    scratch = WT = None
    if grad:
        scratch = torch.empty(grid * (L - 1) * HID * TM, device=dev)
        WT = params["Wp"].transpose(1, 2).contiguous()
    nvcc.call(nvcc.load("query_mlp"), "isdf_" + key,
              [x, transform, params["Wp"], params["bp"], D, bands, out,
               scratch, WT, zout],
              [M._scale(model), model.scale_output],
              [n, L, model.cat_idx, K, model.embedding_size,
               emb.n_freqs(model.min_deg, model.max_deg), grid], dev)
    if key in LAUNCHES:
        nvcc.count_launch(LAUNCHES, key)
