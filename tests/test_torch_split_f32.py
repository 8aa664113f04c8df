"""The split arithmetic of the MLP kernels' f32-product mode, on the CPU.

In the f32 mode (tpu.mm_precision other than "default", isdf_tpu's
mm_dtype = float32) the kernels (csrc/mlp_tile.cuh with MLP_F32) compute
each hidden product on the tensor cores: every f32 operand is split
exactly into three bf16 parts, x = hi + mid + lo, and the product sums
six of the nine cross terms (hh, hm, mh, hl, lh, mm), each a bf16 product
with f32 accumulation. The three terms left out (ml, lm, ll) are below
2^-24 of the product, f32's own rounding; a TPU's Precision.HIGHEST runs
its f32 products as the same six bf16 passes.

``split_bf16`` below is the kernel's split3 in torch (the kernel applies
it in registers to the f32 weights and activations as the fragments are
read), ``split_matmul`` a plain replay of the split product over
models/cuda_mlp.py's SPLIT_TERMS. Held here:

* the split is exact, bit for bit, over normal magnitudes from 1e-30 to
  1e30 of both signs and for zeros;
* the six-term replay of an [N, 256] x [256, 256] product lies within
  SPLIT_TOL of the f64 product (max error over max |product|), as the
  nine-term one does, and the three- and four-term replays lie outside it:
  why six;
* the kernel's fragment reads (replayed) follow PTX's m16n8k16 layout,
  and the replay's terms are the kernel's, in its order;
* the whole fused train op with its hidden products replayed by six split
  terms agrees with isdf_tpu's Pallas train kernel in its f32 mode
  (interpret mode, force_f32) within tests/test_torch_train_op.py's
  tolerances.

The kernel itself is held against the plain version with f32 products on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest
import torch

from isdf_tpu_torch.models import cuda_mlp as K
from isdf_tpu_torch.models import fused_vjp as FV

# max |replay - f64| / max |f64| of a product: six split terms read
# 2.5e-7 here, nine 3.2e-7 (IEEE f32 products 6.9e-7); three terms 4.8e-6
# and four 3.8e-6
SPLIT_TOL = 1e-6



def split_bf16(x):
    """The exact split of an f32 tensor into three bf16 parts (hi, mid,
    lo), x == hi + mid + lo: each part rounds (to nearest even) what the
    larger ones leave, and each residual is exact in f32; csrc/
    mlp_tile.cuh::split3 in torch."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_matmul(a, b, terms=K.SPLIT_TERMS):
    """Plain replay of the f32-product mode's split product a @ b: the
    sum of the split parts' products over ``terms``, in order, each an f32
    product of bf16 values (exact products, f32 sums; the tensor cores
    round their sums in their own way)."""
    pa, pb = split_bf16(a), split_bf16(b)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for x, y in terms:
        out = out + pa[x].float() @ pb[y].float()
    return out


TERMS = {
    "six": K.SPLIT_TERMS,
    "nine": tuple((x, y) for x in range(3) for y in range(3)),
    "three": ((0, 1), (1, 0), (0, 0)),
    "four": ((1, 1), (0, 1), (1, 0), (0, 0)),
}


def _values(case, n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    if case == "zeros":
        return np.array([0.0, -0.0, 1.0, -1.0], np.float32)
    lo, hi = {"tiny": (1e-30, 1e-10), "unit": (1e-10, 1e10),
              "huge": (1e10, 1e30), "all": (1e-30, 1e30)}[case]
    mag = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return (sign * mag).astype(np.float32)


@pytest.mark.parametrize("case", ["tiny", "unit", "huge", "all", "zeros"])
def test_split_is_exact(case):
    x = torch.as_tensor(_values(case))
    hi, mid, lo = split_bf16(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # exact in f64, and in f32 in the order the parts are made
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    # each part is the bf16 rounding of what the larger ones leave
    assert torch.equal(mid, (x - hi.float()).to(torch.bfloat16))
    if case != "zeros":
        assert (hi.float().abs() >= 2.0 ** 8 * mid.float().abs()).all()
        assert (mid.float().abs() >= 2.0 ** 8 * lo.float().abs()).all()
        assert bool((torch.sign(hi.float()) == torch.sign(x)).all())


@pytest.mark.parametrize("terms,within", [
    ("six", True), ("nine", True), ("three", False), ("four", False)])
@pytest.mark.parametrize("N", [64, 512])
def test_split_product_against_f64(terms, within, N):
    rng = np.random.default_rng(N)
    a = torch.as_tensor(rng.normal(size=(N, 256)).astype(np.float32))
    b = torch.as_tensor((rng.normal(size=(256, 256)) / 16).astype(
        np.float32))
    ref = a.double() @ b.double()
    err = ((split_matmul(a, b, TERMS[terms]).double() - ref).abs().max()
           / ref.abs().max()).item()
    assert (err <= SPLIT_TOL) == within, (terms, err)


# PTX's m16n8k16 bf16 fragments: (row, column) of half e of register r of
# lane (g, q), g = lane // 4, q = lane % 4
def _ptx_a(g, q, r, e):      # A, 16 x 16 (m, k)
    return g + 8 * (r & 1), 2 * q + e + 8 * (r >> 1)


def _ptx_b(g, q, r, e):      # B, 16 x 8 (k, n)
    return 2 * q + e + 8 * r, g


LDX, LDT, LDW = 264, 40, 260  # csrc/mlp_tile.cuh's f32-mode strides


def _kernel_a(X, m0row, k0, i, g, q, r, e):
    """split_a: the f32 X tile read at p + (r & 1) 8 LDX + (r >> 1) 8, p =
    (m0row + 16 i + g) LDX + k0 + 2q, element e of the float2."""
    flat = X.reshape(-1)
    p = (m0row + 16 * i + g) * LDX + k0 + 2 * q
    return flat[p + (r & 1) * 8 * LDX + (r >> 1) * 8 + e]


def _kernel_b(S, trans, k16, n0, jn, g, q, h, e):
    """split_b: n = n0 + 8 jn + g, k = k16 + 2q + 8h; a [n][k] slab read
    as a float2 at n LDT + k, a [k][n] slab at k LDW + n and (k + 1) LDW
    + n."""
    flat = S.reshape(-1)
    n, k = n0 + 8 * jn + g, k16 + 2 * q + 8 * h
    return flat[n * LDT + k + e] if trans else flat[(k + e) * LDW + n]


@pytest.mark.parametrize("operand", ["a", "b_nk", "b_kn"])
def test_fragment_reads_are_the_ptx_layout(operand):
    """The f32 mode's fragment reads (split_a, split_b in csrc/
    mlp_tile.cuh, replayed here) put into each lane's registers the matrix
    elements PTX's m16n8k16 layout assigns them: A = rows m0row + 16 i ..
    of X at columns k0 .., B = W (a [k][n] slab) or W^T (a [n][k] slab)
    at k-rows k16 .. of the slab and the warp's columns n0 + 8 jn .. The
    split of each value then feeds the same position of every part."""
    rng = np.random.default_rng(7)
    if operand == "a":
        X = rng.normal(size=(64, LDX)).astype(np.float32)
        for m0row, MT, k0 in ((0, 4, 48), (32, 2, 16)):
            for i in range(MT):
                want = X[m0row + 16 * i:m0row + 16 * i + 16, k0:k0 + 16]
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for r in range(4):
                        for e in range(2):
                            m, k = _ptx_a(g, q, r, e)
                            assert _kernel_a(X, m0row, k0, i, g, q, r,
                                             e) == want[m, k]
        return
    trans = operand == "b_nk"
    W = rng.normal(size=(256, 256)).astype(np.float32)   # a 256x256 block
    k0 = 64                                              # the slab's rows
    if trans:  # the ring slab [256 n][KS k] of W read as W^T
        S = np.zeros((256, LDT), np.float32)
        S[:, :32] = W[:, k0:k0 + 32]
        B = W.T[k0:k0 + 32]                              # B[k][n]
    else:      # the plain slab [KS k][256 n]
        S = np.zeros((32, LDW), np.float32)
        S[:, :256] = W[k0:k0 + 32]
        B = W[k0:k0 + 32]
    for n0 in (0, 224):                                  # warps 0 and 7
        for k16 in (0, 16):
            for jn in range(4):
                want = B[k16:k16 + 16, n0 + 8 * jn:n0 + 8 * jn + 8]
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for h in range(2):
                        for e in range(2):
                            k, n = _ptx_b(g, q, h, e)
                            assert _kernel_b(S, trans, k16, n0, jn, g, q, h,
                                             e) == want[k, n]


def test_replay_terms_are_the_kernels():
    """The replay's terms are mma_split's, in its order: the six cross
    terms at least 2^-16 of the product (parts x + y <= 2), smallest
    first, hh last; the three left out are below 2^-24."""
    import os
    path = os.path.join(os.path.dirname(K.__file__), "..", "csrc",
                        "mlp_tile.cuh")
    with open(path) as f:
        text = f.read()
    body = text[text.index("__device__ __forceinline__ void mma_split("):]
    body = body[:body.index("\n}\n")]
    six = tuple((int(x), int(y)) for x, y in
                re.findall(r"split_term<(\d), (\d)>", body))
    assert six == K.SPLIT_TERMS
    assert sorted(six) == sorted((x, y) for x, y in TERMS["nine"]
                                 if x + y <= 2)
    assert six[-1] == (0, 0)
    assert [x + y for x, y in six] == sorted((x + y for x, y in six),
                                             reverse=True)


@pytest.mark.parametrize("variant", ["pc", "ray"])
def test_split_train_op_matches_pallas_f32(variant, monkeypatch):
    """The slice as a whole: the port's plain train op with every hidden
    product (forward, v-chain, tangent and backward chains, dW) replayed
    by six split terms against isdf_tpu's kernel in its f32 mode."""
    import test_torch_train_op as T
    calls = []

    def split_mm(a, w, mm_dtype):
        assert mm_dtype == torch.float32
        calls.append(tuple(a.shape))
        return split_matmul(a, w)

    monkeypatch.setattr(FV, "_mm", split_mm)
    b = T._batch()
    j, t, tm = T._run_both(variant == "pc", b)
    T._assert_close(j, t, tm)
    nh = tm.n_layers - 1
    # forward (+1 skip), v-chain (+1), tangent (+1), backward 2 (nh - 1),
    # dW 2 nh (+2 skip)
    assert len(calls) == 3 * (nh + 1) + 2 * (nh - 1) + 2 * (nh + 1)
