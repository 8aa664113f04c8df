#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (isdf_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --kernels-only

Phases (any failure is an uncaught exception and a non-zero exit):
  1. build the five kernel libraries from isdf_tpu_torch/csrc with nvcc,
     one nvcc per source, all started together (the *_f32 sources are the
     MLP kernels' f32-product mode);
  2. hold each kernel against its plain PyTorch version at the trainer's
     shapes (N = 27,000 points, R = 1,000 surface points, full-width random
     weights from a seed, a non-identity scene transform) and time both:
     K1-pc, K1-ray, K1-stream (the fused train op), K4 (nearest surface
     point), K2 and K3 (the reverse-fused op, forward and backward), then
     K1-pc, K1-ray, K1-stream, K2 and K3 in their f32-product mode
     (tpu.mm_precision other than "default": split-bf16 tensor-core
     products, six cross terms) against the plain versions with IEEE f32
     products; each is also called twice on the same inputs and must give
     the same bits.
     K4 is held on five inputs (the trainer's, exact ties, ragged M and R,
     one valid surface point, none), must be one launch a call with no
     other device kernel, and is timed beside the port's matmul route for
     the same indices (a yardstick); --kernels-only also times K4 at other
     launch geometries (K4_VARIANTS). A kernel's time is the device time
     of its launches in a torch.profiler trace of the card (the time of its
     wrapper's calls back to back, by CUDA events, is printed beside it);
     the plain version's is taken with CUDA events;
  3. plant one fault per kernel added by the second slice (K1-stream, K4,
     K2, K3), two in K1's staged products (accumulator rows g and g + 8
     swapped in the forward epilogue; k_dw dropping the last slab of each
     split), a second in K4 (its merge of the groups preferring the later
     group on equal minima) and two in the f32 mode's split products (the
     hm and mh terms dropped; the hl and lh terms dropped, which shows that
     TOL_F32 tells six terms from four) in copies of the sources, build
     the copies, and require each check to fail on its faulty kernel;
  4. drive the online trainer through its entry points (Trainer +
     train_loop) on isdf_tpu_torch/train/configs/synthetic.json with the
     simulated clock pinned, per path: as shipped (pc bounds -> K1-pc);
     loss.bounds_method=ray (-> K1-ray); tpu.pe_in_kernel=false with
     tpu.use_pallas=true (-> K1-stream and K4); tpu.grad_mode=
     reverse_fused with tpu.use_pallas=true (the non-fused step -> K4);
     the first three again with tpu.mm_precision=highest (-> the f32
     mode); model.embedding.gauss_embed=1 (autograd, no kernel). Each run
     starts with the launch counts at 0, must launch its kernels once per
     step and no other, lower its loss, promote keyframes, and lower both
     the reference protocol's av_l1 (eval/protocol.py, visible region)
     and the SDF error against the scene's analytic SDF over the room;
  5. drive the reverse-fused op's own path (no trainer reaches K2/K3 on one
     card): 200 AdamW steps on 27,000 fixed points, once through K2/K3 and
     once through the plain op, in both product modes; K2 and K3 launch
     once per step, both loss curves fall, the first step agrees within
     the K2/K3 limits;
  6. run the CLI (train/train.py) on the shipped config: as shipped, its
     res.json must hold the protocol's "rays" entries; then batch mode with
     the per-step loop (-ni --per_step);
  7. checkpoints, meshing, serving and pose tracking at full width: the CLI
     on the shipped config with save.save_checkpoints, save.save_meshes
     and eval.mesh_eval (checkpoints and .ply meshes at every mark, mesh
     accuracy and completion falling from the first timed mark to the
     last); a fresh trainer from the last checkpoint (sdf_fn bit-equal to
     the live trainer's at that save, on 20,000 points; then 50 resumed
     steps); the query service (serve.py) from that checkpoint, its HTTP
     /sdf and /grad held to the trainer's sdf_fn and grad_fn and timed at
     65,536 points a request; the sparse 200^3 grid's mesh equal to the
     dense grid's, both through the native marching-tets library (which
     must build); then pose tracking: isdf_tpu's anchored tracking test at
     full width (a misposed frame against a map trained at the true pose:
     one burst must cut its pose error below 0.7x), and the trainer under
     random-walk pose noise with and without model.refine_poses (bursts on
     ingested frames, billed by CUDA events; the arena pose errors
     printed). Each run counts K1-pc once a step. Two pose bursts on the
     same inputs (the anchored map's two frames, the same draws) must give
     the same bits;
  8. the real-data formats, through the port's own image codec (whose
     native library must build and serve every read) and fixture writer:
     (a) a ReplicaCAD-format fixture at replicaCAD.json's camera (1200x680,
     90 frames, GT grid, mesh.obj, eval_pts masks at 1.0 and 2.0 s of
     200,000 points) and the CLI on the shipped replicaCAD.json pointed at
     it, 660 steps: K1-ray once a step and no other kernel, the scene frame
     from mesh.obj, vox_res.json at both times with the four regions, the
     last visible-region av_l1 below 0.30; (b) the same for a ScanNet
     export at 640x480 (45 frames, 0.5 and 1.4 s, 450 steps) on
     scannet.json, the camera read from the scene info txt and |grid| as
     the GT; (c) record_frames of the synthetic scene at
     realsense_franka_offline.json's camera, then that config on the
     recording, 300 steps; (d) realsense.json with
     model.embedding.n_embed_funcs=5 on frames a writer thread drops into
     its live_dir (a forked watcher process, closed at the end), 300
     steps. (c) and (d) launch K1-ray once a step and lower the loss. It
     prints the per-frame read ms, the fixture write seconds and each
     run's device ms per step;
  9. multi-scene training, its CLI, SDF slices, the batch runner and the
     figure readers, the clock pinned: multi_scene_loop on one trainer
     per synthetic room at K = 1 (300 steps), 2 (600 steps a scene) and
     4 (300 steps, two scenes joining later): K1-pc once per active
     scene-step and no other kernel, no bundle for a scene with no active
     steps, each round billing every active scene the same joint time,
     each scene's loss and protocol av_l1 falling; the joint device ms per
     step, per-scene and aggregate steps/s, host wall per round and peak
     memory printed. Scene A stepped beside B with uneven step counts must
     give the same bits as a copy of A stepped alone. train_multi on two
     rooms: config.json, res.json with "rays" and final.ckpt per scene,
     the checkpoint's query engine held to the trainer's sdf_fn. The CLI
     with save.save_slices=1: six PNGs per save mark, the last equal to
     sdf_colormap of sdf_fn on the planes, then gt and diff slices from
     the analytic GT. batch.run_jobs on two seeded jobs over the
     ReplicaCAD fixture of phase 8 (K1-ray): no job None, config.json,
     res.json and vox_res.json in each run directory, figs' readers on
     them, a two-row slice comparison;
 10. print the card, the kernels' JSON line, and the result line.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of kernel vs plain version, both with bf16 hidden products on
# the same bf16 operands: about 10x the largest gap read on the card
# (PERF.md, section 6). Gradients and per-point outputs are
# compared per block: max |kernel - plain| over the block's own max |plain|.
TOL_SUMS_REL = 3e-5     # K1: |k - p| / |p| per loss sum; the count is exact
TOL_PLOSS = 5e-3        # K1: per-point loss
TOL_GRAD = 5e-4         # K1, K3: each gradient block (grad_blocks)
TOL_RAW = 7e-2          # K2: raw sdf and each column of d raw / dx
TOL_RAW_RMS = 1e-2      # K2: the same as ||kernel - plain||_2 / ||plain||_2
TOL_BOUNDS = 1e-6       # K4: bounds and gradient targets at equal indices
TOL_LOSS_REL = 3e-6     # K2/K3 op path: the first step's loss
# K2/K3 op path, the 200th step's loss: not a kernel error but how far two
# AdamW runs drift apart when their bf16 roundings differ (read: 3.3e-2);
# it holds both runs to the same training outcome (PERF.md, section 6)
TOL_LAST_REL = 1e-1
# The f32-product mode against the plain version with IEEE f32 products:
# the kernels sum six split-bf16 terms of each product on the tensor
# cores, an f32-grade product with other roundings. About 10x the largest
# gap that the mode's first design (IEEE f32 FMAs) read on the card
# (PERF.md, section 6): sums 8.4e-8, per-point loss 5.3e-7, gradient blocks
# 2.2e-6, K2 2.7e-6 (max) and 1.4e-6 (norm); the op path's first loss read
# 0 (limit: a few float32 ulps), its 200th 2.6e-3. The split design reads
# 8.4e-8, 9.5e-7, 1.2e-6, 2.9e-6 and 1.5e-6; 1.2e-7 and 9.1e-3.
TOL_F32 = dict(sums=1e-6, ploss=5e-6, grad=2e-5, raw=3e-5, raw_rms=1.5e-5,
               loss=1e-6, last=3e-2)
# traces of one measurement, taken again while one comes back short of
# a kernel's launches (device_ms), and the host time between the traced
# calls and either edge of the trace
TRACE_TRIES = 3
TRACE_PAD_S = 0.02

PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s

CONFIG = os.path.join(ROOT, "isdf_tpu_torch", "train", "configs",
                      "synthetic.json")
SOURCES = ("train_mlp", "bounds_pc", "reverse_fused", "train_mlp_f32",
           "reverse_fused_f32")
REPLACES = {
    "K1-pc": "isdf_tpu/models/pallas_mlp.py:726",
    "K1-ray": "isdf_tpu/models/pallas_mlp.py:685",
    "K1-stream": "isdf_tpu/models/pallas_mlp.py:782",
    "K2": "isdf_tpu/models/pallas_mlp.py:849",
    "K3": "isdf_tpu/models/pallas_mlp.py:884",
    "K4": "isdf_tpu/ops/pallas/bounds_pc.py:43",
}
# the f32-product mode of the MLP kernels: the same Pallas call sites,
# built with mm_dtype = float32 (pallas_mlp.py:618-620, 836-838)
F32 = ("K1-pc-f32", "K1-ray-f32", "K1-stream-f32", "K2-f32", "K3-f32")
REPLACES.update((k, REPLACES[k[:-4]]) for k in F32)
# the device kernels each kernel's wrapper launches, as the trace names them
KERNEL_NAMES = {"K1-pc": ("k_train_tile", "k_dw", "k_reduce"),
                "K1-ray": ("k_train_tile", "k_dw", "k_reduce"),
                "K1-stream": ("k_train_tile", "k_dw", "k_reduce"),
                "K2": ("k_rf_forward",),
                "K3": ("k_rf_vjp_tile", "k_dw", "k_reduce"),
                "K4": ("k_closest_surface",)}
KERNEL_NAMES.update((k, KERNEL_NAMES[k[:-4]]) for k in F32)
SOURCE_OF = {"K1-pc": "train_mlp", "K1-ray": "train_mlp",
             "K1-stream": "train_mlp", "K4": "bounds_pc",
             "K2": "reverse_fused", "K3": "reverse_fused"}
SOURCE_OF.update((k, SOURCE_OF[k[:-4]] + "_f32") for k in F32)
# planted faults, one per kernel of the second slice, two in K1's staged
# products and a second in K4's group merge: (label, kernel whose check
# must fail, file, text, faulty)
PLANTED = (
    ("K1-stream", "K1-stream", "mlp_tile.cuh", "(row < a.N && j < a.E) ?",
     "(row < a.N && j < a.E - 1) ?"),
    # K4 without the factor 2 on the staged coordinates
    ("K4", "K4", "bounds_pc.cu",
     "__fmul_rn(-2.f, sx), __fmul_rn(-2.f, sy), __fmul_rn(-2.f, sz)",
     "-sx, -sy, -sz"),
    # K4's group merge prefers the later group on equal minima
    ("K4 merge ties", "K4", "bounds_pc.cu",
     "if (mg < b) {", "if (mg <= b) {"),
    ("K2", "K2", "reverse_fused.cu", "a.graw_out[3 * r + 1] = g1[t.tid];",
     "a.graw_out[3 * r + 1] = g2[t.tid];"),
    ("K3", "K3", "reverse_fused.cu", "a.dg_in[3 * r + 1]",
     "a.dg_in[3 * r + 2]"),
    # accumulator rows g and g + 8 swapped in the forward epilogue
    ("K1 epilogue rows", "K1-pc", "mlp_tile.cuh",
     "const int r = 16 * i + t.g + 8 * h;  // forward epilogue row",
     "const int r = 16 * i + t.g + 8 * (1 - h);  // forward epilogue row"),
    # k_dw drops the last slab of each split
    ("k_dw last slab", "K1-pc", "mlp_tile.cuh",
     "const int nslab = max(re - rb, 0) / DW_KS;",
     "const int nslab = max(re - rb, 0) / DW_KS - 1;"),
    # the f32 mode's split products without their hm and mh terms
    ("f32 split hm mh", "K1-pc-f32", "mlp_tile.cuh",
     "split_term<0, 1>(acc, a, b); split_term<1, 0>(acc, a, b);  // hm, mh",
     "// hm, mh dropped"),
    # ... without their hl and lh terms: four terms, not six
    ("f32 split hl lh", "K1-pc-f32", "mlp_tile.cuh",
     "split_term<0, 2>(acc, a, b); split_term<2, 0>(acc, a, b);  // hl, lh",
     "// hl, lh dropped"),
)


class Mismatch(AssertionError):
    """A kernel disagrees with its plain version."""


def expect(cond, msg):
    if not cond:
        raise Mismatch(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def all_launches():
    from isdf_tpu_torch.models import cuda_mlp, cuda_reverse_fused
    from isdf_tpu_torch.ops import cuda_bounds
    return (cuda_mlp.LAUNCHES, cuda_bounds.LAUNCHES,
            cuda_reverse_fused.LAUNCHES)


# the device kernels of each MLP library's occupancy query, in its order
OCCUPANCY = {
    "train_mlp": ("isdf_train_mlp_occupancy", (
        "k_train_tile<pc>", "k_train_tile<ray>", "k_train_tile<stream>",
        "k_dw")),
    "reverse_fused": ("isdf_rf_occupancy", ("k_rf_forward", "k_rf_vjp_tile",
                                            "k_dw")),
}


def occupancy(lib, source):
    """Resident blocks per SM of the device kernels of an MLP library in
    its product mode (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes
    fn_name, names = OCCUPANCY[source.removesuffix("_f32")]
    out = (ctypes.c_int * len(names))()
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(out)
    assert rc == 0, f"occupancy query failed, CUDA error {rc}"
    return dict(zip(names, out))


def ptxas_usage(log):
    """{mangled entry function: "R registers, S B spilled, M B static
    shared"} from nvcc's -Xptxas -v report."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = f"{int(m.group(1)) + int(m.group(2))} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            out[name] = (f"{m.group(1)} registers, " + out.get(name, "")
                         + f", {sm.group(1) if sm else 0} B static shared")
    return out


def reset_launches():
    for d in all_launches():
        for k in d:
            d[k] = 0


def read_launches():
    return {k: v for d in all_launches() for k, v in d.items()}


def make_inputs(torch, N_rays=1000, S=27, R=1000, seed=0):
    """A ray batch shaped like the trainer's: rays from points near the
    room centre, surface sample first, 90% valid rays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (N_rays, 3)).astype(np.float32)
    d = rng.normal(size=(N_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = rng.uniform(0.8, 3.0, N_rays).astype(np.float32)
    z = np.sort(rng.uniform(0.07, 1.0, (N_rays, S)).astype(np.float32)
                * (depth[:, None] + 0.1), axis=1)
    z[:, 0] = depth
    pc = o[:, None] + d[:, None] * z[..., None]
    valid = rng.random(N_rays) > 0.1
    normals = rng.normal(size=(N_rays, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    N = N_rays * S
    f = dict(
        pc=pc, z=z, depth=depth, ray_valid=valid,
        pts=pc.reshape(N, 3),
        surf=pc[:R, 0].copy(),
        surf_valid=valid[:R].astype(np.float32),
        zd=(z - depth[:, None]).reshape(N),
        normals_pt=np.repeat(normals, S, axis=0),
        is_surf=np.tile(np.eye(1, S, dtype=np.float32)[0], N_rays),
        valid=np.repeat(valid, S).astype(np.float32),
        noise=(rng.normal(size=N) * 0.04).astype(np.float32),
        bounds=(depth[:, None] - z).reshape(N),
        gt=np.repeat(-d, S, axis=0),
    )
    out = {k: torch.as_tensor(v).cuda().contiguous() for k, v in f.items()}
    out["inv_count"] = torch.tensor(1.0 / max(float(f["valid"].sum()), 1.0),
                                    device="cuda")
    return out


def grad_blocks(model, dW, db):
    """The gradient by block: each layer's weight rows (the skip layer's
    main rows and pe rows apart) and each layer's bias, so a wrong block
    with small gradients is not hidden by the largest one."""
    from isdf_tpu_torch.models.sdf_mlp import unpack
    H = model.hidden_size
    out = {}
    for l, (w, b) in enumerate(unpack({"Wp": dW, "bp": db}, model)):
        if l == model.cat_idx:
            out[f"dW{l}"], out[f"dW{l}.pe"] = w[:H], w[H:]
        else:
            out[f"dW{l}"] = w
        out[f"db{l}"] = b
    return out


def flop_count(name, model, N, R):
    """(bf16, f32) operations of one call, recounted from the kernel's
    code. Products with a 256x256 matrix per point: K1 3(nh+1) forward,
    v-chain and tangent chain (the skip layer twice), 2(nh-1) backward
    chain, 2(nh+1) dW; K2 2(nh+1) forward and v-chain; K3 (nh+1) forward,
    (nh+1) tangent chain, 2(nh-1) backward chain, 2(nh+1) dW. f32: the
    PE build (K1-pc/ray, 7 per lane), the scores (7 per surface point),
    the tangent contractions and the output head. In the f32-product mode
    ("-f32") the first count is of f32-grade products, each SPLIT_N bf16
    products on the tensor cores (or one IEEE f32 FMA chain)."""
    name = name.removesuffix("-f32")
    nh = model.n_layers - 1
    H = model.hidden_size
    mm = N * 2 * H * H
    if name.startswith("K1"):
        f32 = N * (2 * 3 * 256 + (7 * 256 if name != "K1-stream" else 0)
                   + (7 * R if name == "K1-pc" else 0))
        return (3 * (nh + 1) + 2 * (nh - 1) + 2 * (nh + 1)) * mm, f32
    if name == "K2":
        return 2 * (nh + 1) * mm, N * (2 * 256 + 2 * 3 * 256)
    if name == "K3":
        return ((nh + 1) * 2 + 2 * (nh - 1) + 2 * (nh + 1)) * mm, \
            N * (2 * 3 * 256 + 2 * 2 * 256)
    return 0, 7 * N * R + 5 * R  # K4: 6 and a compare a pair, 5 a bias


def byte_count(name, model, N, R):
    """Each input read once, each output written once."""
    name = name.removesuffix("-f32")
    L, E = model.n_layers, model.embedding_size
    w = L * 512 * 256 * 4 + L * 256 * 4
    if name == "K4":  # points, surf, valid (one byte each), int64 out
        return N * 3 * 4 + R * 3 * 4 + R + N * 8
    if name == "K2":
        return N * E * 4 + w + 3 * 256 * 4 + N * 4 * 4
    if name == "K3":
        return N * E * 4 + N * 4 * 4 + w + 3 * 256 * 4 + w
    per_pt = {"K1-pc": 3 + 1 + 1 + 1 + 3 + 1, "K1-ray": 3 + 1 + 1 + 1 + 3,
              "K1-stream": E + 1 + 1 + 1 + 3}[name]
    ins = N * 4 * per_pt + w + (R * 4 * 4 if name == "K1-pc" else 0)
    return ins + N * 4 + 5 * 4 + w


def stash_bytes(name, model, N):
    """Bytes K1 or K3 moves through its global scratch in one call, as the
    code reads and writes it (per row of 256 lanes): phase 1 writes pe32,
    peb, sig, hb, h5, u, tb, m0b, dzb, dub; reads sig back three times in
    K1 (v-chain, tangent and backward chains; twice in K3), u, h5 and pe32
    (twice in K1); k_dw reads the four operands of each of its nh + 1
    GEMMs once; the split-K partials are written and read once. The
    three-phase design cannot take less than these bytes over the memory
    rate: its floor, beside the bound of byte_count and flop_count. The
    operand planes (peb, hb, tb, m0b, dzb, dub) are bf16, or f32 in the
    f32-product mode."""
    from isdf_tpu_torch.models.cuda_mlp import k1_geometry
    f32 = name.endswith("-f32")
    geo = k1_geometry(N, model.n_layers, f32=f32)
    nh, H = model.n_layers - 1, model.hidden_size
    o = 4 if f32 else 2  # bytes of an operand
    write = 4 + o + 4 * nh + o * (nh - 1) + 4 + 4 * nh + o * (nh - 1) + o \
        + o * nh + o * nh
    if name.startswith("K1"):
        read = 4 * 3 * nh + 4 * nh + 4 + 4 * 2
    else:
        read = 4 * 2 * nh + 4 * nh + 4 + 4
    read_dw = 2 * o * (2 * nh + 2)
    partials = 2 * geo["S"] * (nh + 1) * H * H * 4
    return geo["NP"] * H * (write + read + read_dw) + partials


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def traced_kernels(torch, fn, reps):
    """[(start_us, dur_us, name)] of the device kernels of ``reps`` calls
    of ``fn`` (after one untraced call) in a torch.profiler trace of the
    card, the calls TRACE_PAD_S of host time inside either edge of the
    trace (the profiler loses launches at the edges; PERF.md, section 6)."""
    from torch.profiler import ProfilerActivity, profile

    from isdf_tpu_torch.train.profile_step import kernel_intervals
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return kernel_intervals(path)


def device_ms(torch, name, fn, reps):
    """Device ms per call of ``fn`` spent in the kernel's own launches,
    read from a torch.profiler trace of the card, in all and by device
    kernel (KERNEL_NAMES): the traced durations of each summed over
    ``reps`` calls, over ``reps``. Every call launches each device kernel
    once. A trace that holds fewer launches of one (the profiler lost
    events; PERF.md, section 6) is taken again, up to TRACE_TRIES traces;
    a trace with more, or none that holds them all, fails."""
    names = KERNEL_NAMES[name]
    for attempt in range(TRACE_TRIES):
        ivs = traced_kernels(torch, fn, reps)
        parts = {k: [dur for _, dur, n in ivs if k in n] for k in names}
        counts = {k: len(durs) for k, durs in parts.items()}
        expect(max(counts.values()) <= reps, f"{name}: {counts} traced "
               f"launches in {reps} calls")
        if min(counts.values()) == reps:
            return (sum(sum(d) for d in parts.values()) / 1e3 / reps,
                    {k: sum(d) / 1e3 / reps for k, d in parts.items()})
        print(f"{name}: trace {attempt + 1} holds {counts} launches in "
              f"{reps} calls", flush=True)
    raise Mismatch(f"{name}: no trace of {TRACE_TRIES} held every launch of "
                   f"{reps} calls")


def rel_err(a, b):
    d = (a - b).abs().max().item()
    return d, d / max(b.abs().max().item(), 1e-30)


def rms_err(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def same_bits(torch, x, y):
    return all(torch.equal(a, b) for a, b in zip(x, y))


class Setup:
    """The shared inputs of the kernel checks."""

    def __init__(self, torch):
        from isdf_tpu_torch.models import cuda_mlp as K
        from isdf_tpu_torch.models import sdf_mlp as M
        from isdf_tpu_torch.utils.config import load_config
        self.cfg = cfg = load_config(CONFIG)
        self.model = M.SDFModel(mm_precision=cfg.mm_precision)
        self.params = {k: v.cuda() for k, v in M.init_params(
            torch.Generator().manual_seed(0), self.model).items()}
        T = torch.eye(4)
        T[:3, 3] = torch.tensor([0.1, -0.2, 0.3])
        self.T = T.cuda()
        self.x = make_inputs(torch)
        self.N, self.R = self.x["pts"].shape[0], self.x["surf"].shape[0]
        self.model32 = M.SDFModel(mm_precision="highest")
        self.lk = K._loss_knobs(self.model, cfg.loss_type, cfg.trunc_distance,
                                cfg.trunc_weight, cfg.eik_apply_dist,
                                cfg.eik_weight, cfg.grad_weight,
                                cfg.orien_loss, 5.0)
        self.pe, self.cos_b, self.dxs, self.dproj2 = M._pe_factored(
            self.x["pts"], self.model, self.T)

    def row(self, torch, name, max_abs, fn, plain):
        call_ms = time_ms(torch, fn, 20)
        ms, parts = device_ms(torch, name, fn, 20)
        plain_ms = time_ms(torch, plain, 3)
        from isdf_tpu_torch.models.cuda_mlp import SPLIT_TERMS
        fb, ff = flop_count(name, self.model, self.N, self.R)
        nbytes = byte_count(name, self.model, self.N, self.R)
        t_bytes = nbytes / PEAK_BYTES
        extra = {}
        if name.endswith("-f32"):
            # the least time for the same f32-grade products: their split
            # terms at the bf16 rate (IEEE f32 FMAs beside it)
            t_ops = len(SPLIT_TERMS) * fb / PEAK_BF16 + ff / PEAK_F32
            extra = dict(split_terms=len(SPLIT_TERMS), fma_bound_ms=1e3 * max(
                (fb + ff) / PEAK_F32, t_bytes))
        else:
            t_ops = fb / PEAK_BF16 + ff / PEAK_F32
        bound_ms = 1e3 * max(t_ops, t_bytes)
        print(f"{name}: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms "
              f"per wrapper call back to back, CUDA events), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({(fb + ff) / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)" + (
                  f"; {extra['split_terms']} split terms a product, IEEE "
                  f"f32 FMA bound {extra['fma_bound_ms']:.4f} ms"
                  if extra else ""), flush=True)
        print(f"{name}: device ms by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
        if name.startswith(("K1", "K3")):
            sb = stash_bytes(name, self.model, self.N)
            print(f"{name}: design floor {1e3 * sb / PEAK_BYTES:.4f} ms "
                  f"(stash {sb / 1e9:.3f} GB at {PEAK_BYTES / 1e12} TB/s)",
                  flush=True)
        return dict(name=name, route="cuda",
                    source=f"isdf_tpu_torch/csrc/{SOURCE_OF[name]}.cu",
                    replaces=REPLACES[name], launches=0, max_abs_err=max_abs,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    library_ms=None, parts=parts, **extra)


def tolerances(name):
    """(sums, ploss, grad) limits of a K1 or K3 check."""
    if name.endswith("-f32"):
        return TOL_F32["sums"], TOL_F32["ploss"], TOL_F32["grad"]
    return TOL_SUMS_REL, TOL_PLOSS, TOL_GRAD


def check_k1(torch, s, name, timed=True):
    from isdf_tpu_torch.models import cuda_mlp as K
    from isdf_tpu_torch.models.sdf_mlp import _pe_consts
    cfg, x, params = s.cfg, s.x, s.params
    f32 = name.endswith("-f32")
    model = s.model32 if f32 else s.model
    base = name.removesuffix("-f32")
    tol_sums, tol_ploss, tol_grad = tolerances(name)
    op = K.make_train_op(
        model, loss_type=cfg.loss_type, trunc_distance=cfg.trunc_distance,
        trunc_weight=cfg.trunc_weight, eik_apply_dist=cfg.eik_apply_dist,
        eik_weight=cfg.eik_weight, grad_weight=cfg.grad_weight,
        orien_loss=cfg.orien_loss, pc_bounds=base == "K1-pc",
        pe_in_kernel=base != "K1-stream")
    common = (x["valid"], x["noise"])
    if base == "K1-pc":
        args = (params, s.T, x["pts"], x["surf"], x["surf_valid"], x["zd"],
                x["normals_pt"], x["is_surf"], *common, x["inv_count"])
        kw = dict(surf=x["surf"], surf_valid=x["surf_valid"], zd=x["zd"],
                  normals_pt=x["normals_pt"], is_surf=x["is_surf"])
    elif base == "K1-ray":
        args = (params, s.T, x["pts"], x["bounds"], *common, x["gt"],
                x["inv_count"])
        kw = dict(bounds=x["bounds"], gt=x["gt"])
    else:
        args = (params, s.pe, s.dxs, s.dproj2, x["bounds"], *common, x["gt"],
                x["inv_count"])
        kw = dict(bounds=x["bounds"], gt=x["gt"], pe=s.pe)
    k_out = op(*args)
    k_again = op(*args)
    torch.cuda.synchronize()
    M_, dxs, dproj2 = _pe_consts(model, s.T, device="cuda")
    Tc = K.tangent_rows(model, dxs, dproj2)

    def plain():
        return K.train_op_plain(params, model, s.lk, M_, Tc, x["pts"],
                                x["valid"], x["noise"], x["inv_count"],
                                mm_dtype=torch.float32 if f32
                                else torch.bfloat16, **kw)

    p_out = plain()
    torch.cuda.synchronize()
    ks, kp, (kdw, kdb) = k_out
    ps, pp, (pdw, pdb) = p_out
    for t in (ks, kp, kdw, kdb):
        expect(torch.isfinite(t).all(), f"{name}: non-finite output")
    deterministic = same_bits(torch, (ks, kp, kdw, kdb),
                              (k_again[0], k_again[1], *k_again[2]))
    sums_rel = ((ks - ps).abs() / ps.abs().clamp(min=1e-12)).tolist()
    errs = {"ploss": (kp, pp)}
    kb, pb = grad_blocks(model, kdw, kdb), grad_blocks(model, pdw, pdb)
    errs.update((k, (kb[k], pb[k])) for k in kb)
    norm = {key: rel_err(a, b) for key, (a, b) in errs.items()}
    max_abs = max(v[0] for v in norm.values())
    print(f"{name}: sums kernel {ks.tolist()} plain {ps.tolist()}")
    print(f"{name}: sums rel err {sums_rel} (tol {tol_sums})")
    print(f"{name}: max abs err / max abs of the block (tol ploss "
          f"{tol_ploss}, others {tol_grad}): " + ", ".join(
              f"{k} {v[1]:.3e}" for k, v in norm.items()))
    print(f"{name}: run-to-run identical: {deterministic}", flush=True)
    expect(max(sums_rel[:4]) <= tol_sums and sums_rel[4] == 0.0,
           f"{name}: loss sums disagree with the plain version")
    for key, (d, rel) in norm.items():
        tol = tol_ploss if key == "ploss" else tol_grad
        expect(rel <= tol, f"{name}: {key} disagrees ({rel:.3e} > {tol})")
    expect(deterministic, f"{name}: two calls gave different bits")
    if not timed:
        return None
    return s.row(torch, name, max_abs, lambda: op(*args), plain)


def k4_cases(torch, x):
    """K4's inputs on the card, (name, points, surf, valid): the trainer's
    (its surface set the strided view pc[:, 0]); exact ties (every surface
    point twice, at k and k + 500, so in other groups of the kernel, most
    also at r and r + 8, in one group's consecutive runs, and +-pairs on
    the axes with points on the orthogonal axes); a ragged one;
    one valid surface point; none valid."""
    import numpy as np
    rng = np.random.default_rng(5)

    def cuda(a):
        return torch.as_tensor(a).cuda()

    pts, ray_valid = x["pts"], x["ray_valid"]
    surf = x["pc"][:, 0]
    axes = np.array([[2, 0, 0], [-2, 0, 0], [0, 2, 0], [0, -2, 0],
                     [0, 0, 2], [0, 0, -2]], np.float32)
    # rows r and r + 8 equal: the same group, consecutive runs of rows
    u = rng.normal(size=(31, 8, 3)).astype(np.float32)
    half = np.concatenate([np.concatenate([u, u], 1).reshape(-1, 3)[:494],
                           axes])
    on_axes = np.zeros((6000, 3), np.float32)
    on_axes[np.arange(6000), rng.integers(0, 3, 6000)] = \
        rng.integers(-4, 5, 6000) * 0.25
    tie_valid = np.ones(1000, bool)
    tie_valid[[494, 995]] = False
    one = torch.zeros_like(ray_valid)
    one[737] = True
    rag = x["pc"][:199].reshape(-1, 3)  # 5,373 points
    return [
        ("trainer", pts, surf, ray_valid),
        ("ties", cuda(np.concatenate([
            on_axes, rng.normal(size=(21000, 3)).astype(np.float32)])),
         cuda(np.concatenate([half, half])), cuda(tie_valid)),
        ("ragged", rag, surf[3:].contiguous(), ray_valid[3:].contiguous()),
        ("one valid", pts, surf, one),
        ("none valid", pts, surf, torch.zeros_like(ray_valid)),
    ]


K4_VARIANTS = ((256, 8, 7), (512, 16, 7), (384, 12, 7), (128, 4, 7),
               (256, 8, 8), (256, 8, 4), (512, 16, 4), (256, 8, 2),
               (256, 8, 1), (512, 16, 1))


def k4_variants(torch, x):
    """K4 at other launch geometries (threads, splits, points a thread) on
    the trainer's inputs: indices against the plain version, device ms."""
    from isdf_tpu_torch.ops import cuda_bounds as CB
    pts, surf, sv = x["pts"], x["pc"][:, 0], x["ray_valid"]
    want = CB.closest_surface_ix_plain(pts, surf, sv)
    M, R = pts.shape[0], surf.shape[0]
    for threads, splits, ppt in K4_VARIANTS:
        g = CB.k4_geometry(M, R, threads, splits, ppt)

        def fn():
            return CB.closest_surface_ix_cuda(pts, surf, sv, geometry=g)

        same = torch.equal(fn(), want)
        ms, _ = device_ms(torch, "K4", fn, 50)
        print(f"K4 variant threads {threads} splits {splits} ppt {ppt}: "
              f"{g['points']} points a block, {g['blocks']} blocks, fill "
              f"{g['fill']:.3f}: {ms:.4f} ms on the device, indices equal "
              f"to the plain version's: {same}", flush=True)


def check_k4(torch, s, timed=True):
    from isdf_tpu_torch.ops import bounds as B
    from isdf_tpu_torch.ops import cuda_bounds as CB
    x = s.x
    for case, pts, surf, sv in k4_cases(torch, x):
        k_ix = CB.closest_surface_ix(pts, surf, sv)
        k_again = CB.closest_surface_ix(pts, surf, sv)
        p_ix = CB.closest_surface_ix_plain(pts, surf, sv)
        torch.cuda.synchronize()
        n_diff = int((k_ix != p_ix).sum())
        same = torch.equal(k_ix, k_again)
        print(f"K4 [{case}]: M {pts.shape[0]}, R {surf.shape[0]}: indices "
              f"differing from the plain version: {n_diff}; run-to-run "
              f"identical: {same}", flush=True)
        expect(n_diff == 0, f"K4 [{case}]: {n_diff} indices disagree")
        expect(same, f"K4 [{case}]: two calls gave different bits")
    # the bounds and gradient targets the step builds from the indices
    args = (x["pc"], x["z"], x["depth"], x["ray_valid"])
    kb = B.bounds_pc(*args, use_kernel=True)
    pb = B.bounds_pc(*(a.cpu() for a in args), use_kernel=True)
    b_err = rel_err(kb.bounds.cpu(), pb.bounds)[0]
    g_err = rel_err(kb.grad.cpu(), pb.grad)[0]
    print(f"K4: bounds max abs err {b_err:.3e}, gradient targets "
          f"{g_err:.3e} (tol {TOL_BOUNDS})", flush=True)
    expect(b_err <= TOL_BOUNDS and g_err <= TOL_BOUNDS,
           "K4: bounds disagree with the plain version's")
    expect(torch.equal(kb.grad_valid.cpu(), pb.grad_valid),
           "K4: gradient validity disagrees")
    if not timed:
        return None
    pts, surf, sv = x["pts"], x["pc"][:, 0], x["ray_valid"]
    geo = CB.k4_geometry(pts.shape[0], surf.shape[0])
    print("K4: geometry " + json.dumps(
        {k: v for k, v in geo.items() if k != "rows"})
        + f", group 0 scans {geo['rows'][0]}", flush=True)
    # one call is one launch of k_closest_surface and nothing else (a
    # trace that lost the call's events is taken again, as in device_ms)
    for _ in range(TRACE_TRIES):
        names = [n for _, _, n in traced_kernels(
            torch, lambda: CB.closest_surface_ix(pts, surf, sv), 1)]
        if names:
            break
    print(f"K4: device kernels of one call: {names}", flush=True)
    expect(len(names) == 1 and "k_closest_surface" in names[0],
           f"K4: one call launched {names}")

    def matmul_route():  # ops/bounds.py's search without use_kernel
        sc = -2.0 * (pts @ surf.T) + (surf * surf).sum(-1)[None, :]
        return torch.where(sv[None, :], sc, torch.inf).argmin(dim=-1)

    print(f"K4: yardstick, the port's matmul route (ops/bounds.py, a "
          f"[M, R] score matrix): {time_ms(torch, matmul_route, 20):.4f} ms "
          f"(CUDA events)", flush=True)
    return s.row(torch, "K4", 0.0,
                 lambda: CB.closest_surface_ix(pts, surf, sv),
                 lambda: CB.closest_surface_ix_plain(pts, surf, sv))


def _rf_test_loss(torch, raw, graw):
    """tests/test_pallas_kernels.py's loss through the op."""
    eik = (graw.norm(dim=-1) - 1.0).abs().mean()
    gsum = (graw * torch.tensor([0.2, -0.5, 1.0], device=graw.device)
            ).sum(-1).mean()
    return raw.abs().mean() + 0.3 * eik + 0.1 * gsum


def check_k2_k3(torch, s, which, timed=True):
    """K2 (raw, graw) or K3 (the per-block gradient of a loss through the
    op by .backward()) against the plain op on the same inputs."""
    from isdf_tpu_torch.models import cuda_reverse_fused as CRF
    from isdf_tpu_torch.models import cuda_mlp as K
    from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp
    f32 = which.endswith("-f32")
    model = s.model32 if f32 else s.model
    tol_raw, tol_rms = ((TOL_F32["raw"], TOL_F32["raw_rms"]) if f32
                        else (TOL_RAW, TOL_RAW_RMS))
    args = (s.pe, s.cos_b, s.dxs, s.dproj2)
    ops = {"kernel": CRF.make_cuda_reverse_fused(model),
           "plain": make_reverse_fused_mlp(model)}
    out = {}
    for kind, op in ops.items():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in s.params.items()}
        raw, graw = op(p, *args)
        loss = _rf_test_loss(torch, raw, graw)
        draw, dgraw = torch.autograd.grad(loss, (raw, graw),
                                          retain_graph=True)
        loss.backward(retain_graph=True)
        out[kind] = dict(raw=raw.detach(), graw=graw.detach(), loss=loss,
                         grads=(p["Wp"].grad, p["bp"].grad), p=p,
                         draw=draw.contiguous(), dgraw=dgraw.contiguous(),
                         graph=(raw, graw))
    torch.cuda.synchronize()
    k, pl = out["kernel"], out["plain"]
    Tc = K.tangent_rows(model, s.dxs, s.dproj2).contiguous()
    if which.startswith("K2"):
        again = CRF.rf_forward_cuda(s.params, model, s.pe, Tc)
        errs = {"raw": rel_err(k["raw"], pl["raw"])}
        errs.update((f"graw{c}", rel_err(k["graw"][:, c], pl["graw"][:, c]))
                    for c in range(3))
        det = same_bits(torch, (k["raw"], k["graw"]), again)
        tol = tol_raw
        rms = {"raw": rms_err(k["raw"], pl["raw"])}
        rms.update((f"graw{c}", rms_err(k["graw"][:, c], pl["graw"][:, c]))
                   for c in range(3))
        print(f"{which}: ||kernel - plain|| / ||plain|| (tol {tol_rms}): "
              + ", ".join(f"{key} {v:.3e}" for key, v in rms.items()))
        for key, v in rms.items():
            expect(v <= tol_rms, f"{which}: {key} disagrees in norm "
                   f"({v:.3e} > {tol_rms})")
    else:
        again = CRF.rf_backward_cuda(s.params, model, s.pe, Tc, k["draw"],
                                     k["dgraw"])
        kb, pb = grad_blocks(model, *k["grads"]), grad_blocks(model,
                                                              *pl["grads"])
        errs = {key: rel_err(kb[key], pb[key]) for key in kb}
        # K3 alone: both backward passes on the kernel's cotangents
        same = torch.autograd.grad(pl["graph"], (pl["p"]["Wp"],
                                                 pl["p"]["bp"]),
                                   (k["draw"], k["dgraw"]), retain_graph=True)
        kb, pb = grad_blocks(model, *again), grad_blocks(model, *same)
        errs.update((f"{key}|same-cot", rel_err(kb[key], pb[key]))
                    for key in kb)
        det = same_bits(torch, k["grads"], again)
        tol = tolerances(which)[2]
    torch.cuda.synchronize()
    loss_rel = abs(k["loss"].item() - pl["loss"].item()) / abs(
        pl["loss"].item())
    print(f"{which}: loss kernel {k['loss'].item()} plain "
          f"{pl['loss'].item()} (rel {loss_rel:.3e}); max abs err / max abs "
          f"of the block (tol {tol}): " + ", ".join(
              f"{key} {v[1]:.3e}" for key, v in errs.items()))
    print(f"{which}: run-to-run identical: {det}", flush=True)
    for key, (_, rel) in errs.items():
        expect(rel <= tol, f"{which}: {key} disagrees ({rel:.3e} > {tol})")
    expect(det, f"{which}: two calls gave different bits")
    if not timed:
        return None
    max_abs = max(v[0] for v in errs.values())
    if which.startswith("K2"):
        return s.row(torch, which, max_abs, lambda: CRF.rf_forward_cuda(
            s.params, model, s.pe, Tc), lambda: ops["plain"](s.params, *args))
    p = pl["p"]
    return s.row(torch, which, max_abs, lambda: CRF.rf_backward_cuda(
        s.params, model, s.pe, Tc, k["draw"], k["dgraw"]),
        lambda: torch.autograd.grad(pl["graph"], (p["Wp"], p["bp"]),
                                    (pl["draw"], pl["dgraw"]),
                                    retain_graph=True))


def check(torch, s, name, timed=True):
    if name.startswith("K1"):
        return check_k1(torch, s, name, timed)
    if name == "K4":
        return check_k4(torch, s, timed)
    return check_k2_k3(torch, s, name, timed)


def planted_faults(torch, s):
    """Each check must fail on a copy of the sources with one fault
    planted."""
    from isdf_tpu_torch.utils import nvcc
    base = os.path.join(nvcc.build_dir(), "planted")
    dirs = {}
    for label, _, fname, text, faulty in PLANTED:
        d = os.path.join(base, label.replace(" ", "_"))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(nvcc.CSRC, d)
        path = os.path.join(d, fname)
        with open(path) as f:
            src = f.read()
        assert src.count(text) == 1, f"{label}: planted text not found once"
        with open(path, "w") as f:
            f.write(src.replace(text, faulty))
        dirs[label] = d
    t0 = time.perf_counter()
    nvcc.build([(dirs[p[0]], SOURCE_OF[p[1]]) for p in PLANTED])
    print(f"planted faults: built {len(PLANTED)} copies in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for label, name, fname, _, _ in PLANTED:
        with nvcc.sources_from(dirs[label]):
            try:
                check(torch, s, name, timed=False)
            except Mismatch as e:
                print(f"planted fault {label} ({fname}): the {name} check "
                      f"fails as it must: {e}", flush=True)
            else:
                raise AssertionError(
                    f"{label}: the {name} check passed on a planted fault")


def run_trainer(torch, overrides, max_steps, sim_dt):
    """One run of the online trainer through its entry points. Returns
    (summary dict, launch counts of this run). Its evals: the reference
    protocol's entry (eval/protocol.py, "rays", as train_loop makes it)
    and the SDF error over the room (SyntheticDataset.sdf_mae)."""
    from isdf_tpu_torch.engine.loop import _timed_eval, train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, overrides=overrides)
    trainer = Trainer(cfg, seed=1)
    assert trainer.device.type == "cuda"
    trainer._per_step_device_s = sim_dt
    trainer._bill_exact = True
    trainer.dataset[0]
    mae0 = trainer.dataset.sdf_mae(trainer.sdf_fn)
    l1_0 = _timed_eval(trainer, None)["rays"]["av_l1"]
    losses = []
    run_steps = trainer.run_steps

    def recording_run_steps(n):
        out = run_steps(n)
        losses.extend(out["total_loss"].tolist())
        return out

    trainer.run_steps = recording_run_steps
    maes, l1s, eval_s = [], [], [0.0]

    def hook(tr):
        t = time.perf_counter()
        entry = _timed_eval(tr, None)
        maes.append(tr.dataset.sdf_mae(tr.sdf_fn))
        l1s.append(entry["rays"]["av_l1"])
        eval_s[0] += time.perf_counter() - t
        return {**entry, "sdf_mae": maes[-1]}

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_loop(trainer, max_steps=max_steps, eval_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = max(len(losses) // 10, 1)
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    summary = dict(steps=res.steps, keyframes=len(res.kf_indices) + 1,
                   frames_seen=int(trainer.frames[-1].frame_id) + 1,
                   loss_first=first, loss_last=last, sdf_mae_before=mae0,
                   sdf_mae_after=maes[-1], av_l1_before=l1_0,
                   av_l1_after=l1s[-1], wall_s=wall,
                   eval_s=eval_s[0], steps_per_s_wall=res.steps / wall,
                   steps_per_s_wall_no_eval=res.steps / (wall - eval_s[0]),
                   device_ms_per_step=1e3 * trainer.measured_s
                   / max(res.steps, 1))
    return summary, launches


def rf_op_path(torch, steps=200, f32=False):
    """The reverse-fused op's own path (experiments/profile_step.py::
    mlp_variant): value and gradient of mean |raw| + 0.3 eikonal through
    the op, then AdamW, over fixed points; once through K2/K3, once through
    the plain op; ``f32``: both in the f32-product mode."""
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.models.cuda_reverse_fused import \
        make_cuda_reverse_fused
    from isdf_tpu_torch.models.fused_adamw import init_state, \
        make_fused_adamw
    from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG)
    model = M.SDFModel(mm_precision="highest" if f32 else cfg.mm_precision)
    sfx = "-f32" if f32 else ""
    tol_loss, tol_grad, tol_last = ((TOL_F32["loss"], TOL_F32["grad"],
                                     TOL_F32["last"]) if f32 else
                                    (TOL_LOSS_REL, TOL_GRAD, TOL_LAST_REL))
    N = cfg.window_size * cfg.n_rays * cfg.n_samples_per_ray
    g = torch.Generator(device="cuda").manual_seed(0)
    pts = torch.rand((N, 3), generator=g, device="cuda") * 4.0 - 2.0
    args = M._pe_factored(pts, model, torch.eye(4, device="cuda"))
    runs = {}
    for kind in ("kernel", "plain"):
        op = (make_cuda_reverse_fused(model) if kind == "kernel"
              else make_reverse_fused_mlp(model))
        params = {k: v.cuda() for k, v in M.init_params(
            torch.Generator().manual_seed(0), model).items()}
        opt = init_state(params)
        adamw = make_fused_adamw(cfg.lr, cfg.weight_decay)
        losses, first = [], None
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(steps):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            raw, graw = op(p, *args)
            loss = raw.abs().mean() + 0.3 * (graw.norm(dim=-1) - 1.0).abs(
            ).mean()
            dW, db = torch.autograd.grad(loss, (p["Wp"], p["bp"]))
            if step == 0:
                first = (loss.detach(), dW.clone(), db.clone())
            adamw(params, {"Wp": dW, "bp": db}, opt)
            losses.append(loss.detach())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        losses = torch.stack(losses).tolist()
        runs[kind] = dict(losses=losses, first=first, launches=launches,
                          ms_per_step=1e3 * wall / steps)
        print(f"rf op path{sfx} [{kind}]: loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f} in {steps} steps, {1e3 * wall / steps:.3f} "
              f"ms per step (host clock); launches {launches}", flush=True)
    k, pl = runs["kernel"], runs["plain"]
    mine = ("K2" + sfx, "K3" + sfx)
    expect(all(k["launches"][kk] == steps for kk in mine),
           f"rf op path: K2/K3 launches {k['launches']} in {steps} steps")
    expect(all(v == 0 for kk, v in k["launches"].items() if kk not in mine),
           "rf op path: other kernels ran")
    expect(all(v == 0 for v in pl["launches"].values()),
           "rf op path: the plain run launched a kernel")
    n = 20
    for kind, r in runs.items():
        expect(sum(r["losses"][-n:]) < sum(r["losses"][:n]),
               f"rf op path [{kind}]: the loss did not fall")
    loss0_rel = abs(k["losses"][0] - pl["losses"][0]) / abs(pl["losses"][0])
    kb = grad_blocks(model, *k["first"][1:])
    pb = grad_blocks(model, *pl["first"][1:])
    blocks = {key: rel_err(kb[key], pb[key])[1] for key in kb}
    last_rel = abs(k["losses"][-1] - pl["losses"][-1]) / abs(
        pl["losses"][-1])
    print(f"rf op path{sfx}: first step loss rel err {loss0_rel:.3e} (tol "
          f"{tol_loss}), largest gradient block err "
          f"{max(blocks.values()):.3e} (tol {tol_grad}); last step loss rel "
          f"err {last_rel:.3e} (tol {tol_last})", flush=True)
    expect(loss0_rel <= tol_loss, "rf op path: first losses disagree")
    for key, rel in blocks.items():
        expect(rel <= tol_grad, f"rf op path: first step {key} disagrees "
               f"({rel:.3e} > {tol_grad})")
    expect(last_rel <= tol_last, "rf op path: last losses disagree")
    return k["launches"]


def run_cli(torch, args, max_steps, sim_dt):
    """The trainer CLI in this process, saving to a temporary directory.
    Returns (LoopResult, res.json, launch counts of the run)."""
    from isdf_tpu_torch.train.train import main as cli
    with tempfile.TemporaryDirectory() as d:
        reset_launches()
        res = cli(["--config", CONFIG, "--save_path", d, "--max_steps",
                   str(max_steps), "--sim_dt", str(sim_dt), *args])
        torch.cuda.synchronize()
        launches = read_launches()
        with open(os.path.join(d, "res.json")) as f:
            saved = json.load(f)
    return res, saved, launches


def _post(port, route, obj):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200, f"{route}: HTTP {r.status}"
        return json.loads(r.read())


# the persistence phase: the CLI with its save hooks and the mesh eval;
# marks every SAVE_PERIOD sim-seconds (the shipped 10 s is longer than the
# run); timed evals (the protocol's and the mesh's) every 0.2 s instead of
# the shipped 1 s, with bundles of at most 20 steps, so that the first
# falls on a map of 60 steps, and at the end
PERSIST_STEPS = 900
GRID_DIM = 200           # the CLI's default meshing grid
SAVE_PERIOD = 1.0
PERSIST_SET = ["save.save_checkpoints=1", "save.save_meshes=1",
               "eval.mesh_eval=1", f"save.save_period={SAVE_PERIOD}",
               "eval.eval_freq_s=0.2", "tpu.steps_per_bundle=20"]
RESUMED_STEPS = 50
QUERY_POINTS = 65536     # points a request in the service's readings
TOL_HTTP_SDF = 1e-5      # service vs trainer: the same f32 MLP in other
TOL_HTTP_GRAD = 1e-4     # chunks (cuBLAS may pick other kernels)


def persistence_phase(torch):
    """Checkpoints, meshing, the mesh eval and the query service at full
    width: the CLI on the shipped config with the save hooks and
    eval.mesh_eval; a fresh trainer from its last checkpoint (sdf_fn
    bit-equal to the live trainer's when it saved, then RESUMED_STEPS
    steps through train_loop); the query service from that checkpoint over
    HTTP; the sparse 200^3 mesh against the dense one, through the native
    marching-tets library. Returns its readings; K1-pc launch counts of
    the CLI and the resumed run are checked here."""
    import numpy as np

    from isdf_tpu_torch import serve
    from isdf_tpu_torch.engine import loop as LOOP
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.train.train import main as cli
    from isdf_tpu_torch.utils import checkpoint as CK
    from isdf_tpu_torch.utils import mesh3d, native
    from isdf_tpu_torch.utils.config import load_config

    out = {}
    live, saved, save_s = {}, {}, []
    orig_loop, orig_save = LOOP.train_loop, CK.save_checkpoint

    def loop_spy(trainer, **kw):
        live["tr"] = trainer
        return orig_loop(trainer, **kw)

    def save_spy(path, trainer, step=0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig_save(path, trainer, step=step)
        save_s.append(time.perf_counter() - t)
        saved[path] = (M.copy_params(trainer.params),
                       trainer.transform_dev.clone())

    assert native.load("marching_tets") is not None, \
        "the native marching-tets library did not build"
    n_native = native.CALLS["marching_tets"]
    LOOP.train_loop, CK.save_checkpoint = loop_spy, save_spy
    d = tempfile.mkdtemp(prefix="persist_")
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = cli(["--config", CONFIG, "--save_path", d, "--max_steps",
                   str(PERSIST_STEPS), "--sim_dt", str(1.0 / 300),
                   "--grid_dim", str(GRID_DIM),
                   *[a for kv in PERSIST_SET for a in ("--set", kv)]])
        torch.cuda.synchronize()
        out["cli_wall_s"] = time.perf_counter() - t0
        launches = read_launches()
        assert launches["K1-pc"] == res.steps == PERSIST_STEPS, \
            f"persistence cli: K1-pc {launches['K1-pc']} in {res.steps}"
        assert all(v == 0 for k, v in launches.items() if k != "K1-pc")
    finally:
        LOOP.train_loop, CK.save_checkpoint = orig_loop, orig_save
    try:
        tr = live["tr"]
        cks = sorted(os.listdir(os.path.join(d, "checkpoints")))
        meshes = sorted(os.listdir(os.path.join(d, "meshes")))
        with open(os.path.join(d, "res.json")) as f:
            res_json = json.load(f)
        print(f"persistence cli: {res.steps} steps, {res.tot_step_time:.3f} "
              f"s simulated, checkpoints {cks}, meshes {meshes}, mesh_eval "
              f"{json.dumps(res_json.get('mesh_eval'))}", flush=True)
        n_marks = sum(1 for k in range(1, 1000)
                      if res.tot_step_time > k * SAVE_PERIOD)
        assert len(cks) == n_marks >= 2, "checkpoints missing"
        assert len(meshes) == n_marks, "meshes missing"
        for m in meshes:
            v, fc = mesh3d.read_ply(os.path.join(d, "meshes", m))
            assert len(fc) > 1000 and np.isfinite(v).all(), f"mesh {m}"
        assert native.CALLS["marching_tets"] > n_native, \
            "meshing did not run the native marching tets"
        ev = [res_json["mesh_eval"][k] for k in
              sorted(res_json["mesh_eval"], key=int)]
        assert len(ev) >= 2, "too few mesh evals"
        out["mesh_eval"] = ev
        assert ev[-1]["acc"] < ev[0]["acc"], "mesh accuracy did not fall"
        assert ev[-1]["comp"] < ev[0]["comp"], \
            "mesh completion did not fall"
        out["ckpt_save_s"] = save_s
        out["ckpt_mb"] = os.path.getsize(os.path.join(
            d, "checkpoints", cks[-1])) / 1e6

        # ---- a fresh trainer from the last checkpoint ----
        last = os.path.join(d, "checkpoints", cks[-1])
        cfg = load_config(CONFIG, overrides=PERSIST_SET)
        tr2 = Trainer(cfg, seed=7, grid_dim=GRID_DIM)
        tr2._per_step_device_s, tr2._bill_exact = 1.0 / 300, True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = tr2.load_checkpoint(last)
        torch.cuda.synchronize()
        out["ckpt_load_s"] = time.perf_counter() - t0
        assert "opt_state_reinitialised" not in meta
        g = torch.Generator(device="cuda").manual_seed(3)
        lo = torch.as_tensor(tr2.bounds_transform_np[:3, 3], device="cuda")
        half = torch.as_tensor(tr2.scene_extents_np / 2, device="cuda")
        pts = lo + (torch.rand((20000, 3), generator=g, device="cuda")
                    * 2 - 1) * half
        params_then, tf_then = saved[last]
        now = (tr.params, tr.transform_dev)
        tr.params, tr.transform_dev = params_then, tf_then
        try:
            want = tr.sdf_fn(pts)
        finally:
            tr.params, tr.transform_dev = now
        got = tr2.sdf_fn(pts)
        assert np.array_equal(got, want), \
            "the loaded trainer's sdf_fn differs from the live one's"
        print(f"checkpoint: {cks[-1]} ({out['ckpt_mb']:.1f} MB) saved in "
              f"{save_s[-1]:.3f} s, loaded in {out['ckpt_load_s']:.3f} s; "
              "sdf_fn bit-equal to the live trainer's on 20,000 points",
              flush=True)

        # ---- the query service from the checkpoint ----
        eng = serve.SDFQueryEngine.from_checkpoint(last)
        srv = serve.SDFQueryServer(eng, port=0).start()
        try:
            p = pts.cpu().numpy()
            r_sdf = np.asarray(_post(srv.port, "/sdf",
                                     {"points": p.tolist()})["sdf"])
            r_grad = np.asarray(_post(srv.port, "/grad",
                                      {"points": p.tolist()})["grad"])
            e_sdf = np.abs(r_sdf - got).max()
            e_grad = np.abs(r_grad - tr2.grad_fn(p)).max()
            print(f"service: /sdf max |http - trainer.sdf_fn| {e_sdf:.3e} "
                  f"(tol {TOL_HTTP_SDF}), /grad {e_grad:.3e} (tol "
                  f"{TOL_HTTP_GRAD}); healthz {_healthz(srv.port)}",
                  flush=True)
            assert e_sdf <= TOL_HTTP_SDF and e_grad <= TOL_HTTP_GRAD
            q = (lo + (torch.rand((QUERY_POINTS, 3), generator=g,
                                  device="cuda") * 2 - 1) * half).cpu()
            body = {"points": q.numpy().tolist()}
            for route in ("/sdf", "/grad"):
                _post(srv.port, route, body)                  # warm
                t0 = time.perf_counter()
                for _ in range(3):
                    _post(srv.port, route, body)
                dt = (time.perf_counter() - t0) / 3
                out[f"http{route[1:]}_pts_per_s"] = QUERY_POINTS / dt
                fn = eng.sdf if route == "/sdf" else eng.grad
                fn(q.numpy())
                t0 = time.perf_counter()
                for _ in range(3):
                    fn(q.numpy())
                out[f"engine{route[1:]}_pts_per_s"] = (
                    QUERY_POINTS * 3 / (time.perf_counter() - t0))
        finally:
            srv.stop()

        # ---- the sparse and the dense 200^3 grids, meshed ----
        tr2.get_sdf_grid_sparse()                                # warm
        t0 = time.perf_counter()
        sparse, frac = tr2.get_sdf_grid_sparse()
        out["grid_sparse_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = tr2.get_sdf_grid()
        out["grid_dense_s"] = time.perf_counter() - t0
        out["grid_fraction_evaluated"] = frac
        n0 = native.CALLS["marching_tets"]
        t0 = time.perf_counter()
        v_s, f_s = mesh3d.marching_tetrahedra(sparse)
        out["marching_tets_s"] = time.perf_counter() - t0
        v_d, f_d = mesh3d.marching_tetrahedra(dense)
        assert native.CALLS["marching_tets"] == n0 + 2
        assert len(f_d) > 1000 and np.array_equal(f_s, f_d), \
            "the sparse grid's mesh differs from the dense grid's"
        assert np.abs(v_s - v_d).max() <= 1e-5
        t0 = time.perf_counter()
        tr2.mesh_rec()
        out["mesh_rec_s"] = time.perf_counter() - t0
        print(f"meshing at {tr2.grid_dim}^3: sparse grid "
              f"{out['grid_sparse_s']:.3f} s ({frac:.3f} of the points), "
              f"dense {out['grid_dense_s']:.3f} s, marching tets "
              f"{out['marching_tets_s']:.3f} s (native), mesh_rec "
              f"{out['mesh_rec_s']:.3f} s; {len(f_s)} faces, equal meshes",
              flush=True)

        # ---- the resumed run ----
        tr = None
        live.clear()
        saved.clear()
        reset_launches()
        r2 = LOOP.train_loop(tr2, max_steps=RESUMED_STEPS)
        torch.cuda.synchronize()
        launches = read_launches()
        assert launches["K1-pc"] == r2.steps == RESUMED_STEPS, \
            f"resumed run: K1-pc {launches['K1-pc']} in {r2.steps} steps"
        assert np.isfinite(r2.losses_last["total_loss"])
        assert tr2.steps_taken == meta["steps_taken"] + RESUMED_STEPS
        print(f"resumed run: {r2.steps} steps from step "
              f"{meta['steps_taken']}, loss "
              f"{r2.losses_last['total_loss']:.5f}, launches {launches}",
              flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def _healthz(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as r:
        info = json.loads(r.read())
    return {k: info[k] for k in ("param_count", "device", "step")}


# the data phase: the shipped reference-schema configs on data written in
# their own formats (data/fixtures.py, data/live.py::record_frames) and on
# live frames; the clock pinned at 1/300 s a step, as in every trainer run
CONFIG_DIR = os.path.dirname(CONFIG)
DATA_SIM_DT = 1.0 / 300
DATA_AV_L1 = 0.30   # the last visible-region av_l1 of the fixture runs
#                     (isdf_tpu's own fixture test, tests/
#                     test_fixture_e2e.py:122)
LIVE_FRAMES = 60    # frames pre-rendered for the live and recorded runs


def _spy_trainer(fn):
    """fn() with the loop's train_loop wrapped: (fn's result, the trainer
    the loop ran)."""
    from isdf_tpu_torch.engine import loop as LOOP
    seen, orig = {}, LOOP.train_loop

    def spy(trainer, **kw):
        seen["tr"] = trainer
        return orig(trainer, **kw)

    LOOP.train_loop = spy
    try:
        return fn(), seen["tr"]
    finally:
        LOOP.train_loop = orig


def _read_ms(ds, n=10):
    """Mean host ms to read one frame of a reader (images decoded by the
    port's codec)."""
    t = time.perf_counter()
    for i in range(n):
        ds[i]
    return 1e3 * (time.perf_counter() - t) / n


def _fixture_cli(torch, label, config, sets, steps, times):
    """The CLI on a shipped config pointed at a fixture by ``sets``. Checks
    K1-ray once a step and no other kernel, the scene frame from mesh.obj
    and vox_res.json at ``times`` with the regions; returns (summary,
    vox_res, the trainer)."""
    from isdf_tpu_torch.train.train import main as cli
    with tempfile.TemporaryDirectory() as d:
        args = ["--config", os.path.join(CONFIG_DIR, config), "--save_path",
                d, "--max_steps", str(steps), "--sim_dt", str(DATA_SIM_DT)]
        for item in sets:
            args += ["--set", item]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, tr = _spy_trainer(lambda: cli(args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(d, "vox_res.json")) as f:
            vox = json.load(f)
    summary = dict(steps=res.steps, keyframes=len(res.kf_indices) + 1,
                   frames_seen=int(tr.frames[-1].frame_id) + 1,
                   camera=[tr.H, tr.W, tr.fx, tr.fy, tr.cx, tr.cy],
                   wall_s=wall, steps_per_s_wall=res.steps / wall,
                   device_ms_per_step=1e3 * tr.measured_s / res.steps,
                   vis_av_l1={k: v["rays"]["vis"]["av_l1"]
                              for k, v in vox.items()},
                   surf_av_l1={k: v["visible_surf"]["vis"]["av_l1"]
                               for k, v in vox.items()})
    print(f"data[{label}]: {json.dumps(summary)}", flush=True)
    print(f"data[{label}]: launches {launches}", flush=True)
    assert launches["K1-ray"] == res.steps == steps, \
        f"{label}: {launches['K1-ray']} K1-ray launches in {res.steps} steps"
    assert all(v == 0 for k, v in launches.items() if k != "K1-ray"), \
        f"{label}: other kernels ran"
    assert tr.gt_scene, f"{label}: the scene frame is not from mesh.obj"
    assert sorted(float(k) for k in vox) == list(times), \
        f"{label}: vox_res.json has {sorted(vox)}"
    for entry in vox.values():
        assert {"rays", "visible_surf", "vol"} <= set(entry), label
        for split in ("vis", "vox"):
            assert all(float("-inf") < entry[r][split]["av_l1"] < 10.0
                       for r in ("rays", "visible_surf")), label
    return summary, vox, tr


def _run_cfg(torch, label, cfg, dataset, steps):
    """The trainer through its entry points (Trainer + train_loop) on
    ``dataset``, the clock pinned; K1-ray once a step, no other kernel,
    the loss falling. Returns the summary."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    tr = Trainer(cfg, dataset=dataset, seed=1)
    assert tr.device.type == "cuda"
    tr._per_step_device_s, tr._bill_exact = DATA_SIM_DT, True
    losses, run_steps = [], tr.run_steps

    def recording_run_steps(n):
        out = run_steps(n)
        losses.extend(out["total_loss"].tolist())
        return out

    tr.run_steps = recording_run_steps
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_loop(tr, max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = max(len(losses) // 10, 1)
    summary = dict(steps=res.steps, keyframes=len(res.kf_indices) + 1,
                   camera=[tr.H, tr.W], loss_first=sum(losses[:n]) / n,
                   loss_last=sum(losses[-n:]) / n, wall_s=wall,
                   steps_per_s_wall=res.steps / wall,
                   device_ms_per_step=1e3 * tr.measured_s / res.steps)
    print(f"data[{label}]: {json.dumps(summary)}", flush=True)
    print(f"data[{label}]: launches {launches}", flush=True)
    assert launches["K1-ray"] == res.steps == steps, \
        f"{label}: {launches['K1-ray']} K1-ray launches in {res.steps} steps"
    assert all(v == 0 for k, v in launches.items() if k != "K1-ray"), \
        f"{label}: other kernels ran"
    assert summary["loss_last"] < summary["loss_first"], \
        f"{label}: the loss did not fall"
    return summary


def _camera_frames(torch, cam, n):
    """n frames of the synthetic room at a config's camera, rendered on
    the card: (depth in mm as uint16, camera pose, a colour image)."""
    import numpy as np

    from isdf_tpu_torch.data.synthetic import SyntheticDataset, make_scene
    hfov = float(2 * np.degrees(np.arctan(cam.w / (2 * cam.fx))))
    ds = SyntheticDataset(make_scene("room_a"), n_frames=n, H=cam.h,
                          W=cam.w, hfov_deg=hfov, device="cuda")
    out = []
    for i in range(n):
        s = ds[i]
        d = s["depth"]
        shade = np.clip(d / 6.0, 0.0, 1.0)
        img = (np.stack([shade, 1.0 - shade, 0.5 * shade + 0.25], -1)
               * 255).astype(np.uint8)
        out.append((np.clip(np.round(d * 1000.0), 0, 65535).astype(
            np.uint16), s["T"], img))
    return out


def data_phase(torch, root):
    """The real-data formats at full width (phase 8), their files written
    under ``root``. Returns its readings and the ReplicaCAD fixture's
    config path (phase 9 runs the batch runner on it)."""
    import threading

    import numpy as np

    from isdf_tpu_torch.data import fixtures as FX
    from isdf_tpu_torch.data.datasets import (ReplicaDataset,
                                              ScanNetDataset, StreamDataset,
                                              make_dataset)
    from isdf_tpu_torch.data.live import record_frames
    from isdf_tpu_torch.utils import native
    from isdf_tpu_torch.utils.config import load_config

    assert native.load("image_codec") is not None, \
        "the image codec's native library did not build"
    calls0 = dict(native.CALLS)
    out = {}
    # (a) ReplicaCAD at replicaCAD.json's camera
    t = time.perf_counter()
    rc_cfg = FX.write_replicaCAD_fixture(
        os.path.join(root, "rc"), n_frames=90, H=680, W=1200,
        hfov_deg=90.0, eval_times=(1.0, 2.0), eval_samples=200000,
        device="cuda")
    out["replicaCAD_write_s"] = time.perf_counter() - t
    fc = load_config(rc_cfg)
    out["replicaCAD_read_ms"] = _read_ms(ReplicaDataset(fc.seq_dir, fc))
    print(f"data[replicaCAD fixture]: written in "
          f"{out['replicaCAD_write_s']:.2f} s, a 1200x680 frame (depth "
          f"+ colour PNG) read in {out['replicaCAD_read_ms']:.2f} ms",
          flush=True)
    summary, vox, tr = _fixture_cli(
        torch, "replicaCAD", "replicaCAD.json",
        [f"dataset.seq_dir={fc.seq_dir}",
         f"dataset.gt_sdf_dir={fc.gt_sdf_dir}",
         f"eval.eval_pts_root={fc.eval_pts_root}",
         "eval.do_vox_comparison=1"], 660, (1.0, 2.0))
    assert (tr.H, tr.W) == (680, 1200)
    last = vox[max(vox, key=float)]
    assert "objects" in last and len(last["objects"]["l1"]) == 4
    assert last["rays"]["vis"]["av_l1"] < DATA_AV_L1, \
        f"replicaCAD: final visible av_l1 {last['rays']['vis']}"
    out["replicaCAD"] = summary
    del tr

    # (b) a ScanNet export at 640x480
    t = time.perf_counter()
    fx_cfg = FX.write_scannet_fixture(
        os.path.join(root, "sn"), n_frames=45, H=480, W=640,
        eval_times=(0.5, 1.4), eval_samples=200000, device="cuda")
    out["ScanNet_write_s"] = time.perf_counter() - t
    fc = load_config(fx_cfg)
    out["ScanNet_read_ms"] = _read_ms(ScanNetDataset(fc.scannet_dir, fc))
    print(f"data[ScanNet fixture]: written in {out['ScanNet_write_s']:.2f}"
          f" s, a 640x480 frame (depth PNG + colour JPEG) read in "
          f"{out['ScanNet_read_ms']:.2f} ms", flush=True)
    summary, vox, tr = _fixture_cli(
        torch, "ScanNet", "scannet.json",
        [f"dataset.seq_dir={fc.seq_dir}",
         f"dataset.scannet_dir={fc.scannet_dir}",
         f"dataset.intrinsics_file={fc.intrinsics_file}",
         f"dataset.gt_sdf_dir={fc.gt_sdf_dir}",
         f"eval.eval_pts_root={fc.eval_pts_root}",
         "eval.do_vox_comparison=1"], 450, (0.5, 1.4))
    with open(fc.intrinsics_file) as f:
        fx_txt = float(f.readline().split("=")[1])
    assert (tr.H, tr.W) == (480, 640) and tr.fx == fx_txt, \
        "ScanNet: the camera is not the scene info txt's"
    probe = np.random.default_rng(0).uniform(-3, 3, (20000, 3))
    assert np.nanmin(tr.gt_sdf_fn(probe)) >= 0.0, "ScanNet: GT not |grid|"
    last = vox[max(vox, key=float)]
    assert last["rays"]["vis"]["av_l1"] < DATA_AV_L1, \
        f"ScanNet: final visible av_l1 {last['rays']['vis']}"
    out["ScanNet"] = summary
    del tr

    # (c) a recording in the Franka offline format, then the offline
    # config on it
    cfg = load_config(os.path.join(CONFIG_DIR,
                                   "realsense_franka_offline.json"))
    frames = _camera_frames(torch, cfg.camera, LIVE_FRAMES)

    class Camera:
        """A live camera's frames: depth in mm, as a RealSense gives
        it."""

        def __len__(self):
            return len(frames)

        def __getitem__(self, i):
            d, T, img = frames[i]
            return {"depth": d.astype(np.float32), "T": T, "image": img}

    rec = os.path.join(root, "franka")
    t = time.perf_counter()
    record_frames(StreamDataset(Camera(), fps=cfg.fps), rec,
                  n_frames=LIVE_FRAMES, fps=cfg.fps)
    out["franka_record_s"] = time.perf_counter() - t
    # the shipped eval.do_eval = 1 needs a GT SDF, which a recording
    # lacks: isdf_tpu raises at the first timed eval there too
    # (ROADMAP C)
    cfg = load_config(os.path.join(CONFIG_DIR,
                                   "realsense_franka_offline.json"),
                      overrides=[f"dataset.seq_dir={rec}",
                                 "eval.do_eval=0"])
    out["franka_offline"] = _run_cfg(torch, "realsense_franka_offline",
                                     cfg, make_dataset(cfg), 300)

    # (d) live frames dropped into realsense.json's live_dir
    live_dir = os.path.join(root, "live")
    os.makedirs(live_dir)
    cfg = load_config(os.path.join(CONFIG_DIR, "realsense.json"),
                      overrides=[f"dataset.live_dir={live_dir}",
                                 "model.embedding.n_embed_funcs=5"])
    frames = _camera_frames(torch, cfg.camera, LIVE_FRAMES)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            d, T, img = frames[i % len(frames)]
            tmp = os.path.join(live_dir, f".tmp{i}.npz")
            np.savez(tmp, depth=d, T=T, image=img)
            os.replace(tmp, os.path.join(live_dir, f"frame{i:06d}.npz"))
            i += 1
            stop.wait(1.0 / cfg.fps)

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    ds = make_dataset(cfg)
    try:
        out["realsense_live"] = _run_cfg(torch, "realsense live", cfg,
                                         ds, 300)
    finally:
        stop.set()
        th.join(timeout=10)
        ds.source.close()
    assert not ds.source.proc.is_alive(), "the live watcher is alive"
    assert not th.is_alive(), "the frame writer is alive"

    served = native.CALLS["image_codec"] - calls0["image_codec"]
    fallback = native.CALLS["image_codec_numpy"] - calls0["image_codec_numpy"]
    print(f"data: the image codec's native library served {served} images,"
          f" numpy {fallback}", flush=True)
    assert served > 0 and fallback == 0, \
        "the native image codec did not serve every read and write"
    out["codec_native_images"] = served
    return out, rc_cfg


POSE_STEPS = 1200
POSE_SET = ["dataset.pose_noise_std=0.006", "dataset.pose_noise_mode=walk"]
# the anchored tracking test: isdf_tpu's tests/test_engine.py:284-336 at
# full width (a map trained on frame 0 at its true pose, frame 1 with iid
# pose noise of std 0.03, one 60-iteration burst)
ANCHOR_SET = ["dataset.pose_noise_std=0.03", "dataset.pose_noise_mode=iid",
              "model.refine_poses=1", "pose_refine.min_rel_improve=0.05"]
ANCHOR_GAIN = 0.7        # the refined error must be below 0.7 x the first


def pose_errors(trainer):
    """Per arena row: (frame id, translation error in metres, rotation
    error in degrees) of its pose against the dataset's GT pose."""
    import numpy as np
    n = trainer.buffer.count
    T = trainer.buffer.T_WC[:n].cpu().numpy().astype(np.float64)
    fids = trainer.buffer.frame_id[:n].cpu().numpy()
    out = []
    for i, f in enumerate(fids):
        G = trainer.dataset[int(f)]["T_gt"].astype(np.float64)
        c = (np.trace(T[i, :3, :3].T @ G[:3, :3]) - 1.0) / 2.0
        out.append((int(f), float(np.linalg.norm(T[i, :3, 3] - G[:3, 3])),
                    float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))))
    return out


def pose_phase(torch):
    """Pose tracking on the card at full width. (1) The anchored test: a
    map trained 450 steps on frame 0 at its true pose, frame 1 ingested at
    a pose with iid noise, one 60-iteration burst folded into the arena:
    frame 1's pose error must fall below ANCHOR_GAIN of its first value.
    (2) The trainer under random-walk pose noise with and without
    model.refine_poses, POSE_STEPS steps each through train_loop with the
    bursts billed by their CUDA events: bursts run on ingested frames,
    K1-pc once a step; the arena pose errors of both runs are readings
    (under walk noise the map drifts with the frames, and the absolute
    error moves within its run-to-run spread either way). Returns the
    readings."""
    import dataclasses

    import numpy as np

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    out = {}
    tr = Trainer(load_config(CONFIG, overrides=ANCHOR_SET), seed=0)
    ds = tr.dataset
    tr.last_is_keyframe = True
    tr.add_frame(dataclasses.replace(tr.get_data([0])[0], T_WC=ds.poses[0]))
    for _ in range(15):
        tr.run_steps(30)
    tr.last_is_keyframe = True
    tr.add_frame(tr.get_data([1])[0])
    err0 = float(np.abs(tr.buffer.T_WC[1].cpu().numpy() - ds.poses[1]).max())
    # two bursts over both frames on the same draws: the same bits (the
    # segment sums add in a fixed order)
    rows = torch.arange(2, device="cuda")
    draws = tr._pose_step.draw(torch.Generator(device="cuda").manual_seed(3),
                               2, tr.H, tr.W, "cuda")
    bursts = [tr._pose_step.solve(
        tr.params, torch.zeros_like(tr.pose_state.twists),
        tr.buffer.depth[rows], tr.buffer.T_WC[rows], rows, tr.fns.dirs,
        tr.transform_dev, draws, n_steps=10) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*bursts))
    out["repeat"] = dict(same_bits=same, max_twist=float(
        bursts[0][0].abs().max()), loss=bursts[0][1].tolist())
    print(f"pose [repeat]: two 10-iteration bursts over frames 0 and 1 on "
          f"the same draws: the same bits {same} (max |twist| "
          f"{out['repeat']['max_twist']:.3e})", flush=True)
    assert same, "two pose bursts on the same inputs gave different bits"
    tr.refine_poses_step(n_steps=60)
    tr.apply_pose_corrections()
    err1 = float(np.abs(tr.buffer.T_WC[1].cpu().numpy() - ds.poses[1]).max())
    out["anchored"] = dict(err_before=err0, err_after=err1,
                           burst_ms_60_iters=1e3 * tr._last_burst_s)
    print(f"pose [anchored]: frame 1's pose error {err0:.4f} -> {err1:.4f} "
          f"(max abs entry of T_WC - T_gt; must fall below {ANCHOR_GAIN} x) "
          f"in one 60-iteration burst of {1e3 * tr._last_burst_s:.1f} ms",
          flush=True)
    assert np.isfinite(err1) and err1 < ANCHOR_GAIN * err0, \
        "the anchored pose burst did not reduce the pose error"
    assert float(tr.pose_state.twists.abs().max()) == 0.0
    del tr
    torch.cuda.empty_cache()

    for refine in (0, 1):
        cfg = load_config(CONFIG, overrides=POSE_SET + [
            f"model.refine_poses={refine}"])
        tr = Trainer(cfg, seed=1)
        tr._per_step_device_s, tr._bill_exact = 1.0 / 300, True
        bursts, folds = [], []
        if refine:
            step = tr.refine_poses_step

            def timed(*a, **k):
                r = step(*a, **k)
                bursts.append(tr._last_burst_s)
                folds.append(tr._last_burst_rel_improve
                             >= tr.cfg.pose_min_rel_improve)
                return r

            tr.refine_poses_step = timed
        reset_launches()
        res = train_loop(tr, max_steps=POSE_STEPS)
        torch.cuda.synchronize()
        launches = read_launches()
        assert launches["K1-pc"] == res.steps == POSE_STEPS, \
            f"pose run: K1-pc {launches['K1-pc']} in {res.steps} steps"
        assert all(v == 0 for k, v in launches.items() if k != "K1-pc")
        errs = pose_errors(tr)
        assert all(np.isfinite(e[1]) for e in errs)
        key = "refine" if refine else "no_refine"
        out[key] = dict(mean_err_m=sum(e[1] for e in errs) / len(errs),
                        max_err_m=max(e[1] for e in errs),
                        mean_rot_deg=sum(e[2] for e in errs) / len(errs),
                        rows=errs, keyframes=tr.buffer.count,
                        bursts=len(bursts), folded=sum(folds),
                        loss_last=res.losses_last["total_loss"])
        if refine:
            assert bursts, "no pose burst ran"
            assert float(tr.pose_state.twists.abs().max()) == 0.0
            out[key]["burst_ms_mean"] = 1e3 * sum(bursts) / len(bursts)
            out[key]["burst_ms_max"] = 1e3 * max(bursts)
        print(f"pose run [{key}]: {json.dumps(out[key])}", flush=True)
        del tr
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: multi-scene lockstep training, its CLI, SDF slices, the batch
# runner and the figure readers, at full width with the clock pinned
# ---------------------------------------------------------------------------

MULTI_SIM_DT = 1.0 / 300
# (label, synthetic rooms, steps per scene, start times in s of fleet clock)
LOCKSTEP_RUNS = (
    ("K=1", ("room_a",), 300, None),
    ("K=2", ("room_a", "room_b"), 600, None),
    # the late scenes join while the first two still run: rounds 8 and 15
    # of their 30
    ("K=4", ("room_a", "room_b", "room_c", "room_a"), 300,
     (0.0, 0.0, 0.25, 0.5)),
)
# uneven per-round step counts of scene A beside B, for solo equivalence
SOLO_ROUNDS = ((7, 3), (0, 10), (10, 4), (10, 10), (3, 0))
SLICE_STEPS, SLICE_PERIOD = 600, 0.5
BATCH_STEPS, BATCH_SIM_DT = 220, 0.01   # 2.2 s of sim time: both vox marks


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _room_cfg(room, sets):
    from isdf_tpu_torch.utils.config import load_config
    return load_config(CONFIG, overrides=[f"dataset.seq_dir=/synthetic/{room}",
                                          *sets])


def _lockstep(torch, label, rooms, steps, start_times, sets, dev):
    """multi_scene_loop on one trainer per room (seeds 1, 2, ...), the
    stepper's clock pinned. Checks K1-pc once per active scene-step and no
    other kernel; no train_bundle call for a scene with no active steps;
    every round billing each active scene the same joint time and idle
    scenes nothing; each scene's loss and protocol av_l1 falling. Returns
    its readings."""
    import numpy as np

    from isdf_tpu_torch.engine.loop import _timed_eval
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.parallel.multi_scene import (MultiSceneStepper,
                                                     multi_scene_loop)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        # the last run's trainers sit in reference cycles (the spies)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainers = [Trainer(_room_cfg(r, sets), seed=1 + i, device=dev)
                for i, r in enumerate(rooms)]
    resident = torch.cuda.memory_allocated() / 1e9 if cuda else None
    K = len(trainers)
    l1_0 = []
    for tr in trainers:
        tr.dataset[0]
        l1_0.append(_timed_eval(tr, None)["rays"]["av_l1"])
    stepper = MultiSceneStepper(trainers)
    stepper._per_step_device_s, stepper._bill_exact = MULTI_SIM_DT, True
    called = []
    for i, tr in enumerate(trainers):
        def spy(*a, _f=tr.fns.train_bundle, _i=i, **k):
            called[-1].append(_i)
            return _f(*a, **k)
        tr.fns.train_bundle = spy
    rounds, losses = [], [[] for _ in trainers]
    run_steps = stepper.run_steps

    def recording_run_steps(n, n_actives=None):
        called.append([])
        t_before = [tr.tot_step_time for tr in trainers]
        dev0, t0 = stepper.measured_s, time.perf_counter()
        out = run_steps(n, n_actives=n_actives)
        wall = time.perf_counter() - t0
        rounds.append(dict(
            n_actives=list(n_actives), wall_s=wall,
            device_s=stepper.measured_s - dev0,
            billed=[tr.tot_step_time - t for tr, t in zip(trainers,
                                                          t_before)]))
        for i, sc in enumerate(out):
            v = sc["total_loss"]
            losses[i].extend(v[~np.isnan(v)].tolist())
        return out

    stepper.run_steps = recording_run_steps
    reset_launches()
    _sync(torch, dev)
    t0 = time.perf_counter()
    out = multi_scene_loop(trainers, max_steps=steps,
                           start_times=start_times, stepper=stepper)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    total = sum(o["steps"] for o in out)
    assert [o["steps"] for o in out] == [steps] * K, f"{label}: {out}"
    assert launches["K1-pc"] == total, \
        f"{label}: {launches['K1-pc']} K1-pc launches in {total} steps"
    assert all(v == 0 for k, v in launches.items() if k != "K1-pc"), \
        f"{label}: other kernels ran: {launches}"
    for r, c in zip(rounds, called):
        assert c == [i for i, n in enumerate(r["n_actives"]) if n > 0], \
            f"{label}: scenes {c} ran in a round of {r['n_actives']}"
        billed = {round(b, 12) for b, n in zip(r["billed"], r["n_actives"])
                  if n > 0}
        assert len(billed) == 1, f"{label}: uneven joint billing {r}"
        assert all(b == 0.0 for b, n in zip(r["billed"], r["n_actives"])
                   if n == 0), f"{label}: an idle scene was billed"
    if start_times:
        for i, s in enumerate(start_times):
            if s > 0:
                assert rounds[0]["n_actives"][i] == 0, \
                    f"{label}: scene {i} ran before its start"
    summary = dict(scenes=K, steps=[o["steps"] for o in out],
                   rounds=len(rounds), wall_s=wall,
                   keyframes=[o["n_keyframes"] for o in out])
    for i, (tr, ls) in enumerate(zip(trainers, losses)):
        n = max(len(ls) // 10, 1)
        first, last = sum(ls[:n]) / n, sum(ls[-n:]) / n
        l1 = _timed_eval(tr, None)["rays"]["av_l1"]
        summary[f"scene{i}"] = dict(loss_first=first, loss_last=last,
                                    av_l1_before=l1_0[i], av_l1_after=l1)
        assert last < first, f"{label}: scene {i}'s loss did not fall"
        assert l1 < l1_0[i], f"{label}: scene {i}'s av_l1 did not fall"
    full = [r for r in rounds if all(n > 0 for n in r["n_actives"])]
    ms = [1e3 * r["device_s"] / max(r["n_actives"]) for r in full]
    round_s = sum(r["device_s"] for r in full) / len(full)
    steps_round = sum(max(r["n_actives"]) for r in full) / len(full)
    summary.update(
        full_rounds=len(full),
        joint_device_ms_per_step=sum(ms) / len(ms),
        scene_steps_per_s_device=steps_round / round_s,
        aggregate_steps_per_s_device=K * steps_round / round_s,
        host_wall_ms_per_round=1e3 * sum(r["wall_s"] for r in full)
        / len(full),
        aggregate_steps_per_s_wall=total / wall,
        memory_allocated_after_setup_gb=resident,
        max_memory_allocated_gb=(torch.cuda.max_memory_allocated() / 1e9
                                 if cuda else None))
    print(f"multi[{label}]: {json.dumps(summary)}", flush=True)
    print(f"multi[{label}]: launches {launches}", flush=True)
    return summary


def _solo_equivalence(torch, sets, dev):
    """Scene A stepped by MultiSceneStepper beside B with uneven step
    counts against a copy of A stepped alone by the same counts: the same
    bits in every parameter, optimiser moment and arena priority."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.parallel.multi_scene import MultiSceneStepper
    trs = [Trainer(_room_cfg(r, sets), seed=s, device=dev)
           for r, s in (("room_a", 1), ("room_b", 2), ("room_a", 1))]
    for tr in trs:
        for fid in (0, 40, 80):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
    a, b, solo = trs
    stepper = MultiSceneStepper([a, b])
    for na, nb in SOLO_ROUNDS:
        stepper.run_steps(10, n_actives=[na, nb])
        if na:
            solo.run_steps(na)
    _sync(torch, dev)

    def state(t):
        return dict(
            [(f"params.{k}", t.params[k]) for k in t.params]
            + [(f"opt.{m}.{k}", t.opt_state[m][k]) for m in ("mu", "nu")
               for k in t.params]
            + [("frame_avg_loss", t.buffer.frame_avg_loss),
               ("loss_approx", t.buffer.loss_approx)])

    sa, ss = state(a), state(solo)
    differ = [k for k in sa if not torch.equal(sa[k], ss[k])]
    steps = sum(na for na, _ in SOLO_ROUNDS)
    print(f"multi[solo equivalence]: scene A {a.steps_taken} steps beside "
          f"B ({b.steps_taken}) against alone ({solo.steps_taken}): "
          f"{len(sa) - len(differ)} of {len(sa)} tensors the same bits",
          flush=True)
    assert a.steps_taken == solo.steps_taken == steps
    assert not differ, f"scene A beside B differs from A alone in {differ}"


def _train_multi_cli(torch, root, sets, dev):
    """The multi-scene CLI on two rooms, its loop's stepper pinned. Checks
    each scene_<i>/ (config.json, res.json with the protocol's "rays",
    final.ckpt), and the checkpoint in the query engine against the
    trainer's sdf_fn."""
    import numpy as np

    from isdf_tpu_torch import serve
    from isdf_tpu_torch.parallel import multi_scene as MS
    from isdf_tpu_torch.train.train_multi import main as cli
    second = os.path.join(root, "room_b.json")
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["dataset"]["seq_dir"] = "/synthetic/room_b"
    with open(second, "w") as f:
        json.dump(cfg, f)
    seen, orig = {}, MS.multi_scene_loop

    def pinned(trainers, **kw):
        seen["trainers"] = trainers
        st = MS.MultiSceneStepper(trainers)
        st._per_step_device_s, st._bill_exact = MULTI_SIM_DT, True
        return orig(trainers, stepper=st, **kw)

    out_dir = os.path.join(root, "train_multi")
    args = ["--config", CONFIG, "--config", second, "--save_path", out_dir,
            "--max_steps", "300", "--seed", "1"]
    for s in sets:
        args += ["--set", s]
    if dev == "cpu":
        args += ["--device", "cpu"]
    MS.multi_scene_loop = pinned
    reset_launches()
    t0 = time.perf_counter()
    try:
        out = cli(args)
    finally:
        MS.multi_scene_loop = orig
    wall = time.perf_counter() - t0
    launches = read_launches()
    assert launches["K1-pc"] == sum(o["steps"] for o in out) == 600, \
        f"train_multi: launches {launches}"
    pts = np.random.default_rng(0).uniform(-2.0, 2.0, (20000, 3)).astype(
        np.float32)
    errs, l1s = [], []
    for i, tr in enumerate(seen["trainers"]):
        sdir = os.path.join(out_dir, f"scene_{i}")
        assert sorted(os.listdir(sdir)) == ["config.json", "final.ckpt",
                                            "res.json"], os.listdir(sdir)
        with open(os.path.join(sdir, "res.json")) as f:
            res = json.load(f)
        (entry,) = res["sdf_eval"].values()
        assert set(entry["rays"]) == {"av_l1", "binned_l1",
                                      "l1_chomp_costs"}
        assert res["steps"] == 300
        l1s.append(entry["rays"]["av_l1"])
        eng = serve.SDFQueryEngine.from_checkpoint(
            os.path.join(sdir, "final.ckpt"), device=dev)
        errs.append(float(np.abs(eng.sdf(pts) - tr.sdf_fn(pts)).max()))
    print(f"multi[train_multi]: {wall:.1f} s wall with two checkpoints, "
          f"launches {launches}; final av_l1 {l1s}; engine vs sdf_fn max "
          f"err {errs} (tol {TOL_HTTP_SDF})", flush=True)
    assert max(errs) <= TOL_HTTP_SDF, "train_multi: engine != sdf_fn"
    return dict(wall_s=wall, engine_err=errs, av_l1=l1s)


def _slices_cli(torch, root, sets, dev):
    """The trainer CLI with save.save_slices: six pred PNGs per save mark,
    read back through image_io; the last mark's equal to sdf_colormap of
    the trainer's sdf_fn on the planes; then gt and diff slices once from
    the analytic GT."""
    import numpy as np

    from isdf_tpu_torch.train.train import main as cli
    from isdf_tpu_torch.utils import image_io as IO
    from isdf_tpu_torch.vis import slices as SL
    seen, orig = [], SL.write_slices

    def spy(trainer, path, prefix="", **kw):
        planes = SL.slice_planes(trainer, 6)
        img = SL.sdf_colormap(trainer.sdf_fn(planes.reshape(-1, 3)).reshape(
            planes.shape[:-1]))
        seen.append((prefix, [np.take(img, s, axis=1) for s in range(6)],
                     trainer))
        return orig(trainer, path, prefix=prefix, **kw)

    d = os.path.join(root, "slices_run")
    args = ["--config", CONFIG, "--save_path", d, "--max_steps",
            str(SLICE_STEPS), "--sim_dt", str(MULTI_SIM_DT), "--set",
            "save.save_slices=1", "--set", f"save.save_period={SLICE_PERIOD}"]
    for s in sets:
        args += ["--set", s]
    if dev == "cpu":
        args += ["--device", "cpu"]
    SL.write_slices = spy
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = cli(args)
    finally:
        SL.write_slices = orig
    wall = time.perf_counter() - t0
    launches = read_launches()
    assert launches["K1-pc"] == res.steps, f"slices: launches {launches}"
    marks = [p for p, _, _ in seen]
    # the loop's marks: every multiple of the period the clock passed
    n_marks = sum(1 for k in range(1, 1000)
                  if res.tot_step_time > k * SLICE_PERIOD)
    assert len(marks) == n_marks >= 2, f"slices: marks {marks}"
    names = sorted(os.listdir(os.path.join(d, "slices")))
    assert names == sorted(f"{p}pred_{s}.png" for p in marks
                           for s in range(6)), names
    for p, imgs, _ in seen:
        for s in range(6):
            back = IO.imread(os.path.join(d, "slices", f"{p}pred_{s}.png"))
            assert back.shape == (imgs[s].shape[0], imgs[s].shape[1], 3)
    p, imgs, tr = seen[-1]
    for s in range(6):
        back = IO.imread(os.path.join(d, "slices", f"{p}pred_{s}.png"))
        assert np.array_equal(back[..., ::-1], imgs[s]), \
            f"slices: {p}pred_{s}.png is not the colormap of sdf_fn"
    # gt and diff once, from the analytic GT of the synthetic room
    gdir = os.path.join(root, "slices_gt")
    t1 = time.perf_counter()
    SL.write_slices(tr, gdir, include_gt=True, include_diff=True)
    gt_s = time.perf_counter() - t1
    planes = SL.slice_planes(tr, 6)
    gt = SL.sdf_colormap(tr.gt_sdf_fn(planes.reshape(-1, 3).cpu().numpy()
                                      ).reshape(planes.shape[:-1]))
    assert sorted(os.listdir(gdir)) == sorted(
        f"{k}_{s}.png" for k in ("pred", "gt", "diff") for s in range(6))
    for s in range(6):
        back = IO.imread(os.path.join(gdir, f"gt_{s}.png"))[..., ::-1]
        assert np.array_equal(back, np.take(gt, s, axis=1)), \
            f"slices: gt_{s}.png is not the colormap of the analytic SDF"
    out = dict(marks=marks, wall_s=wall, gt_diff_write_s=gt_s,
               steps=res.steps)
    print(f"slices: {json.dumps(out)}", flush=True)
    return out


def _batch(torch, root, fixture_cfg, dev):
    """batch.run_jobs over nruns_per_seq on the ReplicaCAD fixture: two
    seeded jobs on K1-ray, each loop's clock pinned; every job's result
    and run files; figs' readers on the run directories; a two-row slice
    comparison."""
    import numpy as np

    from isdf_tpu_torch.engine import loop as LOOP
    from isdf_tpu_torch.eval import figs
    from isdf_tpu_torch.train import batch
    from isdf_tpu_torch.utils import image_io as IO
    with open(fixture_cfg) as f:
        base = json.load(f)
    seq_dir, gt_dir = base["dataset"]["seq_dir"], base["dataset"][
        "gt_sdf_dir"]
    jobs = batch.nruns_per_seq(base, [seq_dir], 2, gt_sdf_dirs=[gt_dir])
    seen, orig = [], LOOP.train_loop

    def pinned(trainer, **kw):
        trainer._per_step_device_s, trainer._bill_exact = BATCH_SIM_DT, True
        seen.append(trainer)
        return orig(trainer, **kw)

    out_root = os.path.join(root, "batch")
    LOOP.train_loop = pinned
    reset_launches()
    t0 = time.perf_counter()
    try:
        results = batch.run_jobs(jobs, out_root, max_steps=BATCH_STEPS,
                                 retries=0, device=dev)
    finally:
        LOOP.train_loop = orig
    wall = time.perf_counter() - t0
    launches = read_launches()
    assert all(r is not None for r in results.values()), \
        f"batch: a job failed: {results}"
    assert launches["K1-ray"] == 2 * BATCH_STEPS and all(
        v == 0 for k, v in launches.items() if k != "K1-ray"), \
        f"batch: launches {launches}"
    for name in results:
        have = set(os.listdir(os.path.join(out_root, name)))
        assert {"config.json", "res.json", "vox_res.json"} <= have, have
    by_seq = figs.runs_by_sequence(out_root)
    seq = [x for x in seq_dir.split("/") if x][-1]
    assert list(by_seq) == [seq] and len(by_seq[seq]) == 2, by_seq.keys()
    t, mean, std = figs.mean_std_curve(by_seq[seq])
    final = figs.final_values(by_seq[seq])
    assert np.isfinite(mean).all() and np.isfinite(final).all()
    cmp_file = os.path.join(root, "slice_comparison.png")
    figs.slice_comparison([seen[0], seen[0].gt_sdf_fn], cmp_file)
    img = IO.imread(cmp_file)
    dim = seen[0].grid_dim
    assert img.shape == (2 * dim, 3 * dim, 3), img.shape
    out = dict(jobs=sorted(results), wall_s=wall,
               vis_av_l1_final_mean_std=final,
               curve_times=[float(t[0]), float(t[-1])])
    print(f"batch: {json.dumps(out)}; launches {launches}", flush=True)
    return out


def multi_phase(torch, root, fixture_cfg, sets=(), dev="cuda"):
    """Phase 9. ``sets`` and ``dev`` cut it down for a rehearsal on the
    CPU. Returns its readings."""
    out = {}
    for label, rooms, steps, starts in LOCKSTEP_RUNS:
        out[label] = _lockstep(torch, label, rooms, steps, starts, sets, dev)
    _solo_equivalence(torch, sets, dev)
    out["train_multi"] = _train_multi_cli(torch, root, sets, dev)
    out["slices"] = _slices_cli(torch, root, sets, dev)
    out["batch"] = _batch(torch, root, fixture_cfg, dev)
    return out


F32_SET = "tpu.mm_precision=highest"
# (label, overrides, kernels launched once a step, steps)
TRAINER_PATHS = (
    ("K1-pc", None, ("K1-pc",), 600),
    ("K1-ray", ["loss.bounds_method=ray"], ("K1-ray",), 400),
    ("K1-stream+K4", ["tpu.pe_in_kernel=false", "tpu.use_pallas=true"],
     ("K1-stream", "K4"), 400),
    ("reverse_fused+K4", ["tpu.grad_mode=reverse_fused",
                          "tpu.use_pallas=true"], ("K4",), 400),
    ("K1-pc-f32", [F32_SET], ("K1-pc-f32",), 600),
    ("K1-ray-f32", [F32_SET, "loss.bounds_method=ray"], ("K1-ray-f32",),
     400),
    ("K1-stream-f32+K4", [F32_SET, "tpu.pe_in_kernel=false",
                          "tpu.use_pallas=true"], ("K1-stream-f32", "K4"),
     400),
    ("gauss_embed", ["model.embedding.gauss_embed=1"], (), 300),
)


def main():
    kernels_only = "--kernels-only" in sys.argv[1:]
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from isdf_tpu_torch.utils import nvcc

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    nvcc.load_all(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s for {SOURCES}",
          flush=True)
    for (_, name), info in nvcc.BUILD_INFO.items():  # csrc/ only so far
        for fn, usage in ptxas_usage(info["nvcc_log"]).items():
            print(f"ptxas [{name}]: {fn}: {usage}")

    for lib in ("train_mlp", "train_mlp_f32", "reverse_fused",
                "reverse_fused_f32"):
        occ = occupancy(nvcc.load(lib), lib)
        print(f"occupancy [{lib}], resident blocks per SM: " + ", ".join(
            f"{k} {v}" for k, v in occ.items()), flush=True)

    # ---- phase 2: kernels vs plain versions ----
    s = Setup(torch)
    rows = [check(torch, s, name) for name in REPLACES]
    if kernels_only:
        k4_variants(torch, s.x)
        print(json.dumps({"kernels": rows}))
        return

    # ---- phase 3: planted faults ----
    planted_faults(torch, s)
    del s
    torch.cuda.empty_cache()

    # ---- phase 4: the trainer, once per path ----
    by_name = {r["name"]: r for r in rows}
    for label, overrides, expected, steps in TRAINER_PATHS:
        summary, launches = run_trainer(torch, overrides, max_steps=steps,
                                        sim_dt=1.0 / 300)
        print(f"trainer[{label}]: {json.dumps(summary)}", flush=True)
        print(f"trainer[{label}]: launches {launches}", flush=True)
        for name in expected:
            assert launches[name] == summary["steps"], \
                f"{label}: {launches[name]} {name} launches in " \
                f"{summary['steps']} steps"
            if by_name[name]["launches"] == 0:
                by_name[name]["launches"] = launches[name]
        assert all(v == 0 for k, v in launches.items() if k not in expected)
        assert summary["loss_last"] < summary["loss_first"], \
            f"{label}: loss did not fall"
        assert summary["keyframes"] >= 3, f"{label}: too few keyframes"
        assert summary["sdf_mae_after"] < summary["sdf_mae_before"], \
            f"{label}: the SDF error did not fall"
        assert summary["av_l1_after"] < summary["av_l1_before"], \
            f"{label}: the protocol's av_l1 did not fall"

    # ---- phase 5: the reverse-fused op path (K2/K3), both modes ----
    for f32 in (False, True):
        launches = rf_op_path(torch, f32=f32)
        for name in ("K2", "K3"):
            name += "-f32" if f32 else ""
            by_name[name]["launches"] = launches[name]

    # ---- phase 6: the CLI ----
    res, saved, launches = run_cli(torch, [], 600, 1.0 / 300)
    entries = list(saved["sdf_eval"].values())
    print(f"cli [shipped config]: {res.steps} steps, launches {launches}, "
          f"res.json sdf_eval {json.dumps(saved['sdf_eval'])}", flush=True)
    assert launches["K1-pc"] == res.steps, "cli: K1-pc not once a step"

    def protocol_entries(entries):
        return len(entries) >= 2 and all(
            set(e["rays"]) == {"av_l1", "binned_l1", "l1_chomp_costs"}
            and len(e["rays"]["binned_l1"]) == 6
            and len(e["rays"]["l1_chomp_costs"]) == 3
            and 0.0 < e["rays"]["av_l1"] < 10.0 for e in entries)

    assert protocol_entries(entries), \
        "cli: res.json lacks the protocol's rays entries"
    res, saved, launches = run_cli(
        torch, ["-ni", "--per_step", "--set", "dataset.n_views=20"], 600,
        1.0 / 300)
    entries = list(saved["sdf_eval"].values())
    print(f"cli [-ni --per_step]: {res.steps} steps in {res.rounds} rounds, "
          f"launches {launches}, av_l1 "
          f"{[e['rays']['av_l1'] for e in entries]}", flush=True)
    assert res.rounds == res.steps == 600 and launches["K1-pc"] == 600
    assert len(res.kf_indices) + 1 == 20, "cli -ni: not the 20 views"
    assert protocol_entries(entries), "cli -ni: no protocol entries"

    # ---- phase 7: checkpoints, meshing, the mesh eval, the query
    # service, then pose tracking ----
    readings = persistence_phase(torch)
    readings["pose"] = pose_phase(torch)

    with tempfile.TemporaryDirectory() as work:
        # ---- phase 8: the real-data formats ----
        readings["data"], rc_cfg = data_phase(torch, work)
        # ---- phase 9: multi-scene training, its CLI, slices, the batch
        # runner and the figure readers ----
        t9 = time.perf_counter()
        readings["multi"] = multi_phase(torch, work, rc_cfg)
        readings["multi"]["wall_s"] = time.perf_counter() - t9
    readings["wall_s"] = time.perf_counter() - t_main
    print(f"phase 9: {readings['multi']['wall_s']:.1f} s wall; the script "
          f"to here: {readings['wall_s']:.1f} s wall", flush=True)
    print(f"readings: {json.dumps(readings)}", flush=True)

    # ---- phase 10: report ----
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
