#!/usr/bin/env python
"""Time variants of the fused train kernel (K1) on the card, by device
kernel, beside the sources as shipped.

    python -m tools.k1_variants [NAME ...]     (from the repo's root)
    python -m tools.k1_variants f32_NAME ...  (the f32-product mode)

Each variant is a copy of isdf_tpu_torch/csrc with a few text edits
(VARIANTS: the ring's slab depth and stage count, blocks per SM, the
loads in flight of the per-row passes, and a build that prints the SM
clock at k_train_tile's stage boundaries, inserted before the lines of
STAGE_STARTS); all are
built at once, one nvcc each. Then each is called on the same 27,000
random points of the ray variant (train/configs/synthetic.json's model and
loss, random weights from seed 0), in turns "shipped, variants...,
shipped", and the script prints per variant: the registers and spills
ptxas reports for k_train_tile, the resident blocks per SM, the device ms
of k_train_tile, k_dw and k_reduce (torch.profiler trace over 20 calls),
and the largest gap of its dW, db and loss sums to the shipped sources'
(each relative to the block's largest magnitude).

Variants named f32_* (VARIANTS_F32) edit the f32-product mode and are
timed on train_mlp_f32 with mm_precision "highest" beside the shipped f32
sources. Some compute wrong bits on purpose, to time one part of the
design by leaving another out: f32_nomma (no tensor-core products),
f32_nosplit (no split arithmetic), f32_nowait (no wait for the weight
slabs and no barrier between them), f32_halfw (half of each weight slab
loaded), f32_hh (one split term instead of six), and a pair of these.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "isdf_tpu_torch", "train", "configs", "synthetic.json")
# name -> [(file, text, replacement)]
ONE_BLOCK = ("train_mlp.cu", "__launch_bounds__(NTHR, MIN_BLOCKS)\n    k_train",
             "__launch_bounds__(NTHR, 1)\n    k_train")
# The stage boundaries of k_train_tile: (file, first line of the stage),
# and the end of tile_param_vjp, which closes the last stage.
STAGE_STARTS = (
    ("train_mlp.cu", "  // ---- per-row inputs ----\n"),
    ("train_mlp.cu", "  tile_forward(a, t, true, true);\n"),
    ("train_mlp.cu", "  tile_head(a, t, raw);\n"),
    ("train_mlp.cu", "  tile_spatial_grad(a, t, g0, g1, g2);\n"),
    ("train_mlp.cu", "  tile_param_vjp(a, t, draw, dg0, dg1, dg2);\n"),
    ("mlp_tile.cuh", "  // ---- output-layer gradient partials (f32) ----\n"),
    ("mlp_tile.cuh", "  // ---- backward chain: dh = dz_l W_l^T"),
    ("mlp_tile.cuh", "}\n\n// Phase 2: split-K dW GEMMs"),
)
# the SM clock at a stage boundary, printed for every 53rd block
MARK = ("if (threadIdx.x == 0 && blockIdx.x % 53 == 0) printf(\"mark %d {k} "
        "%lld\\n\", (int)blockIdx.x, clock64());\n")
VARIANTS = {
    "ks16_s3": [("mlp_tile.cuh", "#define KS 32", "#define KS 16"),
                ("mlp_tile.cuh", "#define NSTAGE 2", "#define NSTAGE 3")],
    "ks32_s3_1blk": [("mlp_tile.cuh", "#define NSTAGE 2", "#define NSTAGE 3"),
                     ONE_BLOCK],
    "rows16": [("mlp_tile.cuh", "#define ROWS_IN_FLIGHT 8",
                "#define ROWS_IN_FLIGHT 16")],
    # the stage marks, in one call; not timed
    "marks": [("mlp_tile.cuh", "#pragma once\n",
               "#pragma once\n#include <stdio.h>\n")] + [
        (f, s, MARK.format(k=k) + s) for k, (f, s) in enumerate(STAGE_STARTS)],
}
# the f32-product mode's variants: (file, text, replacement) edits of
# csrc/mlp_tile.cuh, timed on train_mlp_f32
SPLIT_MMA = "      mma_bf16(acc[i][jn], a[i][X], b[Y][jn][0], b[Y][jn][1]);"
NO_MMA = "      acc[i][jn][0] += __uint_as_float(a[i][X][0] ^ b[Y][jn][0]);"
SLAB_WAIT = ("    cp_async_wait<NSTAGE - 2>();  // slab s has landed for this "
             "thread\n    __syncthreads();              // ... for all; slab "
             "s - 1's stage is free\n")
VARIANTS_F32 = {
    "f32_mg1": [("mlp_tile.cuh", "#define MG 2 ", "#define MG 1 ")],
    "f32_mg4": [("mlp_tile.cuh", "#define MG 2 ", "#define MG 4 ")],
    "f32_ks16_s3": [("mlp_tile.cuh", "#define KS 32", "#define KS 16"),
                    ("mlp_tile.cuh", "#define NSTAGE 2", "#define NSTAGE 3")],
    "f32_nomma": [("mlp_tile.cuh", SPLIT_MMA, NO_MMA)],
    "f32_nosplit": [("mlp_tile.cuh",
                     "  const bf162 h = __floats2bfloat162_rn(x, y);",
                     "  r[0] = __float_as_uint(x); r[1] = __float_as_uint(y);"
                     "\n  r[2] = r[0] ^ r[1];\n  return;\n"
                     "  const bf162 h = __floats2bfloat162_rn(x, y);")],
    "f32_nowait": [("mlp_tile.cuh", SLAB_WAIT, "")],
    "f32_nomma_nowait": [("mlp_tile.cuh", SPLIT_MMA, NO_MMA),
                         ("mlp_tile.cuh", SLAB_WAIT, "")],
    # half of each weight slab loaded (the rest stale): the weight
    # stream's share of the time
    "f32_halfw": [("mlp_tile.cuh",
                   "    for (int c = t.tid; c < HID * KS / WCHUNK; c += NTHR) {",
                   "    for (int c = t.tid; c < HID * KS / WCHUNK / 2; "
                   "c += NTHR) {")],
    "f32_hh": [("mlp_tile.cuh", "  split_term<1, 1>(acc, a, b);                "
                "                // mm\n", ""),
               ("mlp_tile.cuh", "  split_term<0, 2>(acc, a, b); split_term<2, "
                "0>(acc, a, b);  // hl, lh\n", ""),
               ("mlp_tile.cuh", "  split_term<0, 1>(acc, a, b); split_term<1, "
                "0>(acc, a, b);  // hm, mh\n", "")],
}
VARIANTS_F32["f32_marks"] = VARIANTS["marks"]
MARKS = ("per-row inputs, PE, bounds", "forward", "head, v-chain",
         "spatial gradient, loss", "m0, tangent chain",
         "output-layer partials, last backward layer", "backward chain")


def _inputs(N=27000, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = dict(pts=rng.uniform(-1.5, 1.5, (N, 3)),
             bounds=rng.uniform(-0.3, 1.0, N),
             valid=(rng.random(N) > 0.1), noise=rng.normal(size=N) * 0.04,
             gt=d)
    out = {k: torch.as_tensor(np.asarray(v, np.float32), device="cuda")
           .contiguous() for k, v in f.items()}
    out["inv_count"] = torch.tensor(1.0 / float(out["valid"].sum()),
                                    device="cuda")
    return out


def _ptxas(log, kernel="k_train_tile"):
    """The ptxas lines of the first instance of a kernel in nvcc's log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return " | ".join(x.strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x)
    return "not found"


def _device_ms(fn, reps=20):
    """Device ms per call by device kernel, with chip_smoke.py's rule
    (one traced launch of each a call, short traces taken again)."""
    import chip_smoke
    return chip_smoke.device_ms(torch, "K1-ray", fn, reps)[1]


def _captured_stdout(fn):
    """Runs fn and returns what the process wrote to file descriptor 1
    meanwhile (the device's printf goes there, flushed at a synchronize)."""
    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            fn()
            torch.cuda.synchronize()
            libc.fflush(None)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return f.read().decode()


def _mark_shares(text):
    """Mean share of each stage (between consecutive marks) in the
    sampled blocks' clock from the first mark to the last."""
    blocks = {}
    for line in text.splitlines():
        if line.startswith("mark "):
            _, b, k, clk = line.split()
            blocks.setdefault(int(b), {})[int(k)] = int(clk)
    n = len(MARKS) + 1
    shares = [0.0] * len(MARKS)
    full = [m for m in blocks.values() if len(m) == n]
    for m in full:
        total = m[n - 1] - m[0]
        for k in range(len(MARKS)):
            shares[k] += (m[k + 1] - m[k]) / total / len(full)
    cycles = sum(m[n - 1] - m[0] for m in full) / max(len(full), 1)
    return len(full), cycles, shares


def main(argv=None):
    from isdf_tpu_torch.models import cuda_mlp as K
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.utils import nvcc
    from isdf_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        sys.exit("k1_variants: needs a CUDA device")
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    f32 = names[0].startswith("f32_")
    assert all(n.startswith("f32_") == f32 for n in names), \
        "f32_* variants and the others go in separate calls"
    table = VARIANTS_F32 if f32 else VARIANTS
    source = "train_mlp_f32" if f32 else "train_mlp"
    base = os.path.join(nvcc.build_dir(), "variants")
    dirs = {"shipped": nvcc.CSRC}
    for name in names:
        d = os.path.join(base, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(nvcc.CSRC, d)
        for fname, text, new in table[name]:
            path = os.path.join(d, fname)
            with open(path) as f:
                src = f.read()
            assert src.count(text) == 1, f"{name}: {text!r} not found once"
            with open(path, "w") as f:
                f.write(src.replace(text, new))
        dirs[name] = d
    nvcc.build([(d, source) for d in dirs.values()])

    cfg = load_config(CONFIG)
    model = M.SDFModel(mm_precision="highest" if f32 else cfg.mm_precision)
    params = {k: v.cuda() for k, v in M.init_params(
        torch.Generator().manual_seed(0), model).items()}
    T = torch.eye(4, device="cuda")
    x = _inputs()
    op = K.make_train_op(
        model, loss_type=cfg.loss_type, trunc_distance=cfg.trunc_distance,
        trunc_weight=cfg.trunc_weight, eik_apply_dist=cfg.eik_apply_dist,
        eik_weight=cfg.eik_weight, grad_weight=cfg.grad_weight,
        orien_loss=cfg.orien_loss)
    args = (params, T, x["pts"], x["bounds"], x["valid"], x["noise"],
            x["gt"], x["inv_count"])

    print(f"card: {torch.cuda.get_device_name(0)}; N = {x['pts'].shape[0]}")
    ref = None
    for name in ["shipped", *names, "shipped"]:
        with nvcc.sources_from(dirs[name]):
            lib = nvcc.load(source)
            occ = (ctypes.c_int * 4)()
            lib.isdf_train_mlp_occupancy.argtypes = [ctypes.c_void_p]
            rc = lib.isdf_train_mlp_occupancy(occ)
            assert rc == 0, rc
            sums, _, (dW, db) = op(*args)
            torch.cuda.synchronize()
            if ref is None:
                ref = (sums.clone(), dW.clone(), db.clone())
            gap = max(((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
                      .item() for a, r in zip((sums, dW, db), ref))
            if name.endswith("marks"):
                nb, cyc, shares = _mark_shares(_captured_stdout(
                    lambda: op(*args)))
                print(f"marks: {nb} blocks, {cyc:.0f} SM clocks a block on "
                      f"average; share of each stage: " + ", ".join(
                          f"{m} {v:.3f}" for m, v in zip(MARKS, shares)),
                      flush=True)
                continue  # its printing would flood the output and the time
            ms = _device_ms(lambda: op(*args))
        log = nvcc.BUILD_INFO.get((dirs[name], source), {}).get(
            "nvcc_log", "")
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                      ms.items())
              + f"; K1 {sum(ms.values()):.4f} ms; blocks/SM k_train_tile "
              f"{occ[1]}, k_dw {occ[3]}; gap to shipped {gap:.3e}; ptxas: "
              f"{_ptxas(log)}; k_dw {_ptxas(log, 'k_dw')}", flush=True)


if __name__ == "__main__":
    main()
