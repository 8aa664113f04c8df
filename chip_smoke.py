#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (isdf_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --graphs-only    # build, then phase 10 only
    python3 chip_smoke.py --vis-only       # build, then phase 11 only
    python3 chip_smoke.py --serve-only     # build, then phase 12 only
    python3 chip_smoke.py --plots-only     # build, then phase 13 only
    python3 chip_smoke.py --parallel-only  # build, then phase 14 only

Phases (any failure is an uncaught exception and a non-zero exit):
  1. build the six kernel libraries from isdf_tpu_torch/csrc with nvcc,
     one nvcc per source, all started together (the *_f32 sources are the
     MLP kernels' f32-product mode; query_mlp the serve engine's query
     kernel);
  2. hold each kernel against its plain PyTorch version at the trainer's
     shapes (N = 27,000 points, R = 1,000 surface points, full-width random
     weights from a seed, a non-identity scene transform) and time both:
     K1-pc, K1-ray, K1-stream (the fused train op), K4 (nearest surface
     point), K2 and K3 (the reverse-fused op, forward and backward), then
     K1-pc, K1-ray, K1-stream, K2 and K3 in their f32-product mode
     (tpu.mm_precision other than "default": split-bf16 tensor-core
     products, six cross terms) against the plain versions with IEEE f32
     products; each is also called twice on the same inputs and must give
     the same bits. Then the query kernel, the port's own (isdf_tpu's query
     is one XLA-fused program): Q-sdf and Q-grad at 65,536 points, a scene
     frame turned about two axes, against the eager apply / sdf_and_grad in
     float32 (sdf_gap, grad_gap within TOL_Q), one engine request of each
     being one launch and one query kernel in its trace, timed beside the
     eager chain (the yardstick) and the FMA bound.
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
     TOL_F32 tells six terms from four) and one in the query kernel (the
     skip layer reading zeros for its pe rows, held in both modes) in
     copies of the sources, build the copies, and require each check to
     fail on its faulty kernel;
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
     recording, 300 steps; (d) realsense.json as shipped (E = 381, K1's
     384-lane build) on frames a writer thread drops into its live_dir (a
     forked watcher process, closed at the end), 300 steps. (c) launches
     K1-ray once a step, (d) K1-ray-384, and both lower the loss. It
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
 10. the CUDA-graph route (engine/step.py, engine/pose.py) against the
     eager loop (Trainer(eager=True)): on every trainer path of phase 4,
     the op path of phase 5 in both modes (its step captured by
     utils/graphs.py) and K = 2 scenes in lockstep, a keyed schedule of 60
     steps a scene (nine keyframes into a 7-row arena: the window branch
     switches, two evictions, then the refinement tail) eagerly in bundles
     of 6 and on graphs in bundles of 2 + 4 must give the same bits in
     the parameters, moments, step count, priority rows and per-step
     scalars, each kernel launched once a step either way (a replay counts
     its captured launches); so must six 10-iteration pose bursts; a
     bundle of a captured key runs under
     torch.cuda.set_sync_debug_mode("error"); then graph against eager in
     turns (train/profile_step.profile, 100 warm-up and 100 timed steps):
     billed device ms a step (the graph route's must not be higher), bare
     and traced host wall, kernel ms, device kernels and replays a step,
     idle share, peak memory, captures and their seconds, on the pc, ray,
     streamed + K4 and pc-f32 paths and at K = 2 and 4; the 600-step
     run's wall both ways and the burst's ms;
 11. train_vis (train/train_vis.py) through its main() on the shipped
     synthetic.json at full width (K1-pc on CUDA graphs), the clock pinned
     at 0.02 s a step through _spy_trainer, 600 steps, a monitor cycle at
     each of the shipped 1-s evals: K1-pc once a step and no other
     kernel; every cycle's keyframe strip, latest panel and four slices
     and the eight turntable views there, non-empty, decoding with the
     port's codec; the parameters bit for bit, and the captures, those of
     the same run under train_loop with a hook that draws nothing (a
     first such run before it takes the process's warm-up); the
     rasteriser (host C++, vis/raster.py) on an analytic ellipsoid's
     marching-tets mesh: its silhouette within 1% of the convex hull of
     the projected vertices, two renders the same bytes; it prints the
     monitor's seconds a cycle by part, the vis share of perf_summary(),
     the turntable's triangles and ms a view, the billed device ms a
     step with and without the monitor, and the phase's wall (under 90 s);
 12. the HTTP viewer (vis/server.py) beside the loop, the loop's live
     controls and device work off the loop's thread: (a) train_vis
     --serve --serve-queries through its main() as in phase 11, with a
     client process of four threads from the first step to the end (two
     cycling through every GET route of the viewer, one POSTing control
     toggles, one planner POSTing 65,536-point /sdf requests): every
     response 200 but the keyframe strip before the first frame, at least
     one refresh on the loop's thread and no map evaluation on any other,
     K1-pc once a step, the query kernel once a chunk of the planner's
     requests and no other kernel, the parameters' bits and the captures
     of a plain run; three such runs, each after a plain run, their median billed
     device ms a step less the graphs' set-up (each key's eager first
     step and its capture, 0.03-0.43 s of host work billed with its
     bundle) within 3% of the plain runs' median (the full bills, the
     warm-ups and the captures are printed beside), and each loop's wall,
     less its own monitor and refresh seconds, at most twice its plain
     run's; (b) the
     capture stress run: phase 10's keyed schedule (and a 4-row arena's)
     on graphs with planner threads querying the engine in a tight loop,
     every capture overlapping a query, no error, the eager loop's bits
     (the run's seconds printed);
     (c) a pause over HTTP at about step 200 for 2 s: two status reads 1 s
     apart the same steps and sim time, then the plain run's bits and
     clock; (d) iters_per_step 5 through the viewer's controls: no bundle
     over 5 steps, 600 in all. It prints the median ms per route, the
     refresh s at grid_dim 200, the planner's points/s while training,
     the bills and walls with and without clients, and the phase's wall
     (under 120 s); --serve-only runs it alone after the
     build;
 13. the 2-D plot kit (vis/plot.py, host C++ csrc/plot2d.cpp), the three
     figures of eval/figs.py and the debug oracles: the shipped
     synthetic.json at full width on the graph route for 300 steps
     (K1-pc once a step and nothing else; res.json with its timed
     evals); ray_oracle and check_gt_sdf on the card, their curves held
     to the same functions on CPU copies of the same draws (atol 1e-5,
     pred through the same sdf_fn); check_gt_sdf's and ray_oracle's
     figures, vis_embedding (bands, and a random-Fourier matrix on the
     card), plot_per_seq on the run with the dataset's thumbnails, and
     plot_all_seq and plot_fig8 on run directories the phase writes in
     isdf_tpu's layout from the run's entries (fig8's stats checked);
     every PNG read back through utils/image_io.py, its size and that it
     is not blank checked; it prints the seconds per figure, the oracles'
     gaps, the billed device ms/step and the phase's wall (under 90 s);
     --plots-only runs it alone after the build;
 14. data parallelism and fleet mode on shards of the one card, at full
     width (synthetic.json, 27,000 points a step): the first 4 steps of a
     dp = 2 and a dp = 4 trainer (devices ["cuda:0"] * N) against dp = 1
     from the same seed (losses rtol 2e-4 / atol 1e-5 and parameters 5e-5,
     isdf_tpu's own bounds, every parameter after the first step; that
     step's gradient by block within 5e-4), K1-pc N times a step and
     nothing else; the
     pose burst on the dp = 2 trainer, then a finite step; 300 steps at
     dp = 2 on graphs with loss, av_l1 and SDF MAE falling; the route
     without the fused op (tpu.pe_in_kernel=false on the mesh): its first
     step through K2/K3 against the same step through the plain op on the
     same draws (loss 3e-6, K2 7e-2 max / 1e-2 norm, the parameter
     gradient through K3 against the plain VJP on the step's own
     cotangents by block 5e-4), then 200 steps with
     K2 and K3 each twice a step, loss and av_l1 falling; fleet mode with
     K = 2 and 4 scenes on a 2-shard "scene" mesh of the card, each scene
     its solo bits, each round's bill within 5% of the lockstep
     stepper's; billed device ms/step, kernels a step, the traced idle
     share and peak memory at dp = 1, 2, 4 and on the K2/K3 route
     (profile_step.profile). Under 90 s; --parallel-only runs it alone
     after the build. K2's and K3's launches in the kernels' line are this
     phase's trainer's;
 15. print the card, the kernels' JSON line, and the result line.
"""

from __future__ import annotations

import gc
import json
import math
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
# The query kernel (Q-sdf, Q-grad) against the eager chain in float32 (TF32
# off) at the serve engine's chunk of 65,536 points: max |kernel - eager|
# over the request's max |eager|, both IEEE f32 with other sum orders
Q_POINTS = 65536
TOL_Q = 1e-5
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
           "reverse_fused_f32", "query_mlp", "train_mlp_384")
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
# K1's 384-lane build (n_embed_funcs 8: E = 381, the live configs), the
# same call sites with a wider embedding
W384 = ("K1-pc-384", "K1-ray-384", "K1-stream-384")
REPLACES.update((k, REPLACES[k[:-4]]) for k in W384)
# the port's own kernel: isdf_tpu answers a query with one XLA-fused
# program, no pl.pallas_call
REPLACES.update((k, "none (isdf_tpu/serve.py:53-70, XLA-fused)")
                for k in ("Q-sdf", "Q-grad"))
# the device kernels each kernel's wrapper launches, as the trace names them
KERNEL_NAMES = {"K1-pc": ("k_train_tile", "k_dw", "k_reduce"),
                "K1-ray": ("k_train_tile", "k_dw", "k_reduce"),
                "K1-stream": ("k_train_tile", "k_dw", "k_reduce"),
                "K2": ("k_rf_forward",),
                "K3": ("k_rf_vjp_tile", "k_dw", "k_reduce"),
                "K4": ("k_closest_surface",),
                "Q-sdf": ("k_query_sdf",), "Q-grad": ("k_query_grad",)}
KERNEL_NAMES.update((k, KERNEL_NAMES[k[:-4]]) for k in F32 + W384)
SOURCE_OF = {"K1-pc": "train_mlp", "K1-ray": "train_mlp",
             "K1-stream": "train_mlp", "K4": "bounds_pc",
             "K2": "reverse_fused", "K3": "reverse_fused",
             "Q-sdf": "query_mlp", "Q-grad": "query_mlp"}
SOURCE_OF.update((k, SOURCE_OF[k[:-4]] + "_f32") for k in F32)
SOURCE_OF.update((k, "train_mlp_384") for k in W384)
# planted faults, one per kernel of the second slice, two in K1's staged
# products, two in its 384-lane build's own paths and a second in K4's
# group merge: (label, kernel whose check must fail, file, text, faulty)
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
    # the 384-lane build: the A slab of the PE's lanes past 256 read from
    # lanes 0..127 of the stash
    ("K1-384 tail slab", "K1-ray-384", "mlp_tile.cuh",
     "p.tail + (size_t)(t.r0 + r) * LANES + k0 + h * CHUNK",
     "p.tail + (size_t)(t.r0 + r) * LANES + k0 - HID + h * CHUNK"),
    # ... a lane keeping another m-tile's spatial-gradient partials
    ("K1-384 contraction rows", "K1-ray-384", "mlp_tile.cuh",
     "        if (t.q == i) out[3 * h + k] = v;",
     "        if (t.q == (i ^ 1)) out[3 * h + k] = v;"),
    # the query kernel's skip layer reads zeros in place of its pe rows
    ("Q skip pe rows", "Q-sdf", "query_mlp.cu",
     "tile_pe(a, sh, act, p0, tid, false);  // the skip layer's pe rows",
     "tile_fill_rows(act, 0, QH, 0.f, tid);  // the skip layer's pe rows"),
    ("Q-grad skip pe rows", "Q-grad", "query_mlp.cu",
     "tile_pe(a, sh, act, p0, tid, false);  // the skip layer's pe rows",
     "tile_fill_rows(act, 0, QH, 0.f, tid);  // the skip layer's pe rows"),
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
    from isdf_tpu_torch.models import cuda_mlp, cuda_query, cuda_reverse_fused
    from isdf_tpu_torch.ops import cuda_bounds
    return (cuda_mlp.LAUNCHES, cuda_bounds.LAUNCHES,
            cuda_reverse_fused.LAUNCHES, cuda_query.LAUNCHES)


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
    fn_name, names = OCCUPANCY[source.removesuffix("_f32")
                               .removesuffix("_384")]
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
    code. The 384-lane rows ("-384") count at the model's fan-ins
    (benchmark/counts_fanin.py). Products with a 256x256 matrix per
    point: K1 3(nh+1) forward,
    v-chain and tangent chain (the skip layer twice), 2(nh-1) backward
    chain, 2(nh+1) dW; K2 2(nh+1) forward and v-chain; K3 (nh+1) forward,
    (nh+1) tangent chain, 2(nh-1) backward chain, 2(nh+1) dW. f32: the
    PE build (K1-pc/ray, 7 per lane), the scores (7 per surface point),
    the tangent contractions and the output head. In the f32-product mode
    ("-f32") the first count is of f32-grade products, each SPLIT_N bf16
    products on the tensor cores (or one IEEE f32 FMA chain). Q: all f32,
    the benchmark's count of a query (the PE, the MLP's products, for a
    gradient the input gradient's chain through them)."""
    if name.startswith("Q"):
        E, H, B = (model.embedding_size, model.hidden_size,
                   model.hidden_layers_block)
        nf = model.max_deg - model.min_deg + 1
        mlp = 2 * (E * H + 2 * B * H * H + (H + E) * H + H)
        pe = 2 * 9 + 2 * 21 * 3 + 21 * nf * 2
        return 0, N * (pe + (2 if name == "Q-grad" else 1) * mlp)
    if name.endswith("-384"):
        from benchmark import counts_fanin as CF
        return CF.k1_flops(name[:-4], model.n_layers, model.hidden_size,
                           model.embedding_size, N, R)
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
    if name.endswith("-384"):
        from benchmark import counts_fanin as CF
        return CF.k1_bytes(name[:-4], model.n_layers, model.hidden_size,
                           model.embedding_size, N, R)
    name = name.removesuffix("-f32")
    L, E = model.n_layers, model.embedding_size
    w = L * 512 * 256 * 4 + L * 256 * 4
    if name.startswith("Q"):  # points and the transform in, the answer out
        return N * 12 + 64 + w + N * (12 if name == "Q-grad" else 4)
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
    f32-product mode. In the 384-lane build ("-384") pe32, peb and m0b
    are P = 384 lanes wide, and so are the A sides of k_dw's GEMMs of
    layer 0 and of the skip layer's pe rows and their partials."""
    from isdf_tpu_torch.models.cuda_mlp import k1_geometry
    f32 = name.endswith("-f32")
    P = 384 if name.endswith("-384") else 256
    geo = k1_geometry(N, model.n_layers, f32=f32, lanes=P)
    nh, H = model.n_layers - 1, model.hidden_size
    o = 4 if f32 else 2  # bytes of an operand
    # pe32, peb, m0b at P lanes; sig, hb, h5, u, tb, dzb, dub at H
    write = (4 + o + o) * P + H * (4 * nh + o * (nh - 1) + 4 + 4 * nh
                                   + o * (nh - 1) + o * nh + o * nh)
    if name.startswith("K1"):
        read = H * (4 * 3 * nh + 4 * nh + 4) + 4 * 2 * P
    else:
        read = H * (4 * 2 * nh + 4 * nh + 4) + 4 * P
    # the four operands of each GEMM once: A and TA P wide in GEMMs 0 and
    # nh
    read_dw = 2 * 2 * o * (P + H) + (nh - 1) * 4 * o * H
    partials = 2 * geo["S"] * ((nh - 1) * H + 2 * P) * H * 4
    return geo["NP"] * (write + read + read_dw) + partials


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
        # the live configs' map: n_embed_funcs 8, E = 381 (K1's 384-lane
        # build)
        self.model384 = M.SDFModel(embedding_size=381, max_deg=8,
                                   mm_precision=cfg.mm_precision)
        self.params384 = {k: v.cuda() for k, v in M.init_params(
            torch.Generator().manual_seed(0), self.model384).items()}
        self.pe384, _, self.dxs384, self.dproj2_384 = M._pe_factored(
            self.x["pts"], self.model384, self.T)

    def of(self, name):
        """(model, params, streamed pe, dxs, dproj2) of a kernel row."""
        if name.endswith("-384"):
            return (self.model384, self.params384, self.pe384, self.dxs384,
                    self.dproj2_384)
        return (self.model32 if name.endswith("-f32") else self.model,
                self.params, self.pe, self.dxs, self.dproj2)

    def row(self, torch, name, max_abs, fn, plain, n=None):
        call_ms = time_ms(torch, fn, 20)
        ms, parts = device_ms(torch, name, fn, 20)
        plain_ms = time_ms(torch, plain, 3)
        from isdf_tpu_torch.models.cuda_mlp import SPLIT_TERMS
        n = n or self.N
        model = self.of(name)[0]
        fb, ff = flop_count(name, model, n, self.R)
        nbytes = byte_count(name, model, n, self.R)
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
            sb = stash_bytes(name, model, self.N)
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
    cfg, x = s.cfg, s.x
    f32 = name.endswith("-f32")
    model, params, pe, dxs, dproj2 = s.of(name)
    base = name.removesuffix("-f32").removesuffix("-384")
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
        args = (params, pe, dxs, dproj2, x["bounds"], *common, x["gt"],
                x["inv_count"])
        kw = dict(bounds=x["bounds"], gt=x["gt"], pe=pe)
    k_out = op(*args)
    k_again = op(*args)
    torch.cuda.synchronize()
    M_, dxs_, dproj2_ = _pe_consts(model, s.T, device="cuda")
    Tc = K.tangent_rows(model, dxs_, dproj2_)

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


def query_inputs(torch, s):
    """The query checks' inputs, made once: a scene frame turned about two
    axes and shifted, Q_POINTS points uniform in a 6 x 4 x 3 m room."""
    if not hasattr(s, "q_x"):
        import math
        a, b = 0.4, -0.3
        Rz = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                           [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
        Rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, math.cos(b), -math.sin(b)],
                           [0.0, math.sin(b), math.cos(b)]])
        T = torch.eye(4)
        T[:3, :3] = Rx @ Rz
        T[:3, 3] = torch.tensor([-0.4, 0.25, 0.6])
        s.q_T = T.cuda()
        g = torch.Generator().manual_seed(7)
        s.q_x = ((torch.rand((Q_POINTS, 3), generator=g) - 0.5)
                 * torch.tensor([6.0, 4.0, 3.0])).cuda().contiguous()
    return s.q_x, s.q_T


def check_query(torch, s, which, timed=True):
    """The query kernel in one mode (Q-sdf: values; Q-grad: spatial
    gradients) against the eager chain on the same inputs; timed, also one
    engine request: one launch, one query kernel in its trace."""
    import numpy as np

    from isdf_tpu_torch.models import cuda_query as CQ
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.serve import SDFQueryEngine
    grad = which == "Q-grad"
    model, params = s.model, s.params
    x, T = query_inputs(torch, s)
    out = torch.empty((Q_POINTS, 3) if grad else (Q_POINTS,), device="cuda")

    def fn():
        CQ.query_cuda(params, x, model, T, out, grad)
        return out

    def plain():
        if grad:
            return M.sdf_and_grad(params, x, model, transform=T)[1]
        with torch.no_grad():
            return M.apply(params, x, model, transform=T)

    k1 = fn().clone()
    k2 = fn().clone()
    p = plain()
    torch.cuda.synchronize()
    expect(torch.isfinite(k1).all(), f"{which}: non-finite output")
    max_abs, gap = rel_err(k1, p)
    cols = ([rel_err(k1[:, c], p[:, c])[1] for c in range(3)] if grad
            else [])
    det = torch.equal(k1, k2)
    print(f"{which}: {'grad' if grad else 'sdf'}_gap {gap:.3e} (max abs "
          f"{max_abs:.3e}; tol {TOL_Q})" + (
              ", by column " + ", ".join(f"{c:.3e}" for c in cols)
              if grad else "") + f"; run-to-run identical: {det}",
          flush=True)
    expect(gap <= TOL_Q, f"{which}: disagrees with the eager chain "
           f"({gap:.3e} > {TOL_Q})")
    expect(det, f"{which}: two calls gave different bits")
    if not timed:
        return None
    eng = SDFQueryEngine(params=M.copy_params(params), model=model,
                         transform=T.clone(), chunk_size=Q_POINTS)
    expect(eng.route == "kernel", f"{which}: the engine routes {eng.route}")
    pts = x.cpu().numpy()
    call = eng.grad if grad else eng.sdf
    key = "query_grad" if grad else "query_sdf"
    n0 = CQ.LAUNCHES[key]
    ans = call(pts)
    launches = CQ.LAUNCHES[key] - n0
    eng_gap = float(np.abs(ans - p.cpu().numpy()).max()) / max(
        float(p.abs().max()), 1e-30)
    names = []
    for _ in range(TRACE_TRIES):
        names = [nm for _, _, nm in traced_kernels(
            torch, lambda: call(pts), 1)]
        if any("k_query" in nm for nm in names):
            break
    n_kernels = sum("k_query" in nm for nm in names)
    print(f"{which}: one engine request of {Q_POINTS} points: {launches} "
          f"launch(es), gap {eng_gap:.3e}; its device operations {names}",
          flush=True)
    expect(launches == 1 and n_kernels == 1,
           f"{which}: a request launched {launches} ({n_kernels} traced)")
    expect(eng_gap <= TOL_Q, f"{which}: the engine's answer disagrees")
    row = s.row(torch, which, max_abs, fn, plain, n=Q_POINTS)
    row.update(launches=launches, gap=gap)
    return row


def check(torch, s, name, timed=True):
    if name.startswith("Q"):
        return check_query(torch, s, name, timed)
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


def run_trainer(torch, overrides, max_steps, sim_dt, eager=False,
                device=None):
    """One run of the online trainer through its entry points. Returns
    (summary dict, launch counts of this run). Its evals: the reference
    protocol's entry (eval/protocol.py, "rays", as train_loop makes it)
    and the SDF error over the room (SyntheticDataset.sdf_mae).
    ``device``: the Trainer's (a list: its data-parallel mesh)."""
    from isdf_tpu_torch.engine.loop import _timed_eval, train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, overrides=overrides)
    trainer = Trainer(cfg, seed=1, eager=eager, device=device)
    assert trainer.device.type == "cuda"
    trainer._per_step_device_s = sim_dt
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
    # the step's captures, billed with the bundles they fall in
    stats = getattr(trainer.fns.graphs, "stats", None) or {}
    summary.update(captures=stats.get("captures", 0),
                   capture_s=stats.get("capture_s", 0.0))
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
        tr2._per_step_device_s = 1.0 / 300
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


def _spy_trainer(fn, before=None, after=None):
    """fn() with the loop's train_loop wrapped: (fn's result, the trainer
    the loop ran). ``before(trainer)`` runs as the loop starts,
    ``after(trainer)`` as it returns."""
    from isdf_tpu_torch.engine import loop as LOOP
    seen, orig = {}, LOOP.train_loop

    def spy(trainer, **kw):
        seen["tr"] = trainer
        if before is not None:
            before(trainer)
        try:
            return orig(trainer, **kw)
        finally:
            if after is not None:
                after(trainer)

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


def _run_cfg(torch, label, cfg, dataset, steps, kernel="K1-ray"):
    """The trainer through its entry points (Trainer + train_loop) on
    ``dataset``, the clock pinned; ``kernel`` once a step, no other
    kernel, the loss falling. Returns the summary."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    tr = Trainer(cfg, dataset=dataset, seed=1)
    assert tr.device.type == "cuda"
    tr._per_step_device_s = DATA_SIM_DT
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
    assert launches[kernel] == res.steps == steps, \
        f"{label}: {launches[kernel]} {kernel} launches in {res.steps} steps"
    assert all(v == 0 for k, v in launches.items() if k != kernel), \
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

    # without its library the codec raises, so every read and write below
    # is served by it
    assert native.load("image_codec") is not None, \
        "the image codec's native library did not build"
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
                      overrides=[f"dataset.live_dir={live_dir}"])
    assert cfg.n_embed_funcs == 8, "realsense.json as shipped"
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
                                         ds, 300, kernel="K1-ray-384")
    finally:
        stop.set()
        th.join(timeout=10)
        ds.source.close()
    assert not ds.source.proc.is_alive(), "the live watcher is alive"
    assert not th.is_alive(), "the frame writer is alive"
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
        tr._per_step_device_s = 1.0 / 300
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
    stepper._per_step_device_s = MULTI_SIM_DT
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
        st._per_step_device_s = MULTI_SIM_DT
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
        trainer._per_step_device_s = BATCH_SIM_DT
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



# ---------------------------------------------------------------------------
# phase 10: the CUDA-graph route against the eager loop
# ---------------------------------------------------------------------------

# a 7-row arena, so that 9 keyframes cross the window (5), fill the arena
# and force two evictions; then the refinement tail
GRAPH_ARENA = "tpu.kf_buffer_size=7"
GRAPH_FRAMES = tuple(range(0, 90, 10))
# the bundles of a round: each a tuple of the steps scene i takes in it
# (the bundle's length is the largest); the same steps a scene a round
# either way: 6 for the first scene, 4 for a second
GRAPH_CUTS = {"eager": ((6, 4),), "graph": ((2, 1), (4, 3))}
# the paths timed graph against eager (profile_step), and K scenes
GRAPH_TIMED = (("K1-pc", ()), ("K1-ray", ("loss.bounds_method=ray",)),
               ("K1-stream+K4", ("tpu.pe_in_kernel=false",
                                 "tpu.use_pallas=true")),
               ("K1-pc-f32", (F32_SET,)))
GRAPH_SCENES = (2, 4)
GRAPH_WARMUP, GRAPH_STEPS = 100, 100


def _train_state(tr):
    """The tensors a step updates: params, moments, count, the arena's
    priority rows."""
    return ([tr.params[k] for k in sorted(tr.params)]
            + [tr.opt_state["count"]]
            + [tr.opt_state[m][k] for m in ("mu", "nu")
               for k in sorted(tr.params)]
            + [tr.buffer.frame_avg_loss, tr.buffer.loss_approx])


def _keyed_run(torch, trainers, cuts):
    """The schedule through every key change of the captured step:
    GRAPH_FRAMES added one a round (the window branch switches at the 6th,
    evictions at the 8th and 9th), then the refinement tail; ``cuts`` the
    bundles of a round (GRAPH_CUTS), one trainer through run_steps or K in
    lockstep through MultiSceneStepper. Returns the per-step scalars of
    each trainer."""
    import numpy as np

    from isdf_tpu_torch.parallel.multi_scene import MultiSceneStepper
    stepper = MultiSceneStepper(trainers) if len(trainers) > 1 else None
    logs = [[] for _ in trainers]
    for tr in trainers:
        tr._per_step_device_s = 1.0 / 300

    def steps():
        for na in cuts:
            if stepper is None:
                outs = [trainers[0].run_steps(na[0])]
            else:
                na = na[:len(trainers)]
                outs = stepper.run_steps(max(na), n_actives=na)
                outs = [{k: v[:a] for k, v in o.items()}
                        for o, a in zip(outs, na)]
            for log, o in zip(logs, outs):
                log.append(np.stack([o[k] for k in sorted(o)
                                     if k != "step_time_ms"], axis=1))
    for fid in GRAPH_FRAMES:
        for tr in trainers:
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
        steps()
    for tr in trainers:
        tr.tail_mode, tr.noise_std, tr.lr_scale = True, 0.0, 0.4
    steps()
    return [np.concatenate(log) for log in logs]


def _same_bits(torch, label, make, expected, scenes=1):
    """The keyed schedule eagerly (bundles of 6) and through the graphs
    (bundles of 2 + 4) on trainers made alike: the same bits in the state
    and the per-step scalars; each kernel of the path launched once a
    step either way. Returns (the graph trainers, readings)."""
    import numpy as np
    runs = {}
    for route in ("eager", "graph"):
        trainers = [make(i, route == "eager") for i in range(scenes)]
        reset_launches()
        logs = _keyed_run(torch, trainers, GRAPH_CUTS[route])
        torch.cuda.synchronize()
        runs[route] = (trainers, logs, read_launches())
    (te, le, ke), (tg, lg, kg) = runs["eager"], runs["graph"]
    steps = sum(t.steps_taken for t in tg)
    same = (all(np.array_equal(a, b) for a, b in zip(le, lg))
            and all(torch.equal(x, y) for a, b in zip(te, tg)
                    for x, y in zip(_train_state(a), _train_state(b))))
    stats = [t.fns.graphs.stats for t in tg]
    out = dict(steps=steps, same_bits=same, launches_eager=ke,
               launches_graph=kg,
               captures=sum(s["captures"] for s in stats),
               replays=sum(s["replays"] for s in stats),
               capture_s=sum(s["capture_s"] for s in stats))
    print(f"graphs [{label}]: {json.dumps(out)}", flush=True)
    expect(same, f"graphs [{label}]: the graph route's bits differ from "
           "the eager loop's")
    expect(steps >= 50, f"graphs [{label}]: {steps} steps")
    for k in (ke, kg):
        expect(all(k[n] == steps for n in expected) and all(
            v == 0 for n, v in k.items() if n not in expected),
            f"graphs [{label}]: launches {k} in {steps} steps")
    expect(out["replays"] == steps - out["captures"],
           f"graphs [{label}]: {out['replays']} replays")
    del te
    return tg, out


def _op_path_graph(torch, f32, steps=60):
    """The K2/K3 op path (rf_op_path's step: the op's value and spatial
    gradient, autograd into K3, AdamW) eagerly and as a captured step
    replayed: the same bits in the parameters, moments and losses."""
    from isdf_tpu_torch.models import sdf_mlp as M
    from isdf_tpu_torch.models.cuda_reverse_fused import \
        make_cuda_reverse_fused
    from isdf_tpu_torch.models.fused_adamw import init_state, \
        make_fused_adamw
    from isdf_tpu_torch.utils.config import load_config
    from isdf_tpu_torch.utils.graphs import GraphRunner
    cfg = load_config(CONFIG)
    model = M.SDFModel(mm_precision="highest" if f32 else cfg.mm_precision)
    N = cfg.window_size * cfg.n_rays * cfg.n_samples_per_ray
    g = torch.Generator(device="cuda").manual_seed(0)
    pts = torch.rand((N, 3), generator=g, device="cuda") * 4.0 - 2.0
    args = M._pe_factored(pts, model, torch.eye(4, device="cuda"))
    op = make_cuda_reverse_fused(model)
    adamw = make_fused_adamw(cfg.lr, cfg.weight_decay)
    runs = {}
    for route in ("eager", "graph"):
        params = {k: v.cuda() for k, v in M.init_params(
            torch.Generator().manual_seed(0), model).items()}
        opt = init_state(params)
        loss_out = torch.zeros((), device="cuda")

        def step():
            with torch.enable_grad():
                p = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
                raw, graw = op(p, *args)
                loss = raw.abs().mean() + 0.3 * (
                    graw.norm(dim=-1) - 1.0).abs().mean()
                dW, db = torch.autograd.grad(loss, (p["Wp"], p["bp"]))
            adamw(params, {"Wp": dW, "bp": db}, opt)
            loss_out.copy_(loss.detach())
        reset_launches()
        losses = []
        if route == "eager":
            for _ in range(steps):
                step()
                losses.append(loss_out.clone())
        else:
            runner = GraphRunner("cuda")
            runner.warm(step)
            losses.append(loss_out.clone())
            graph = runner.capture(step)
            for _ in range(steps - 1):
                graph.replay()
                losses.append(loss_out.clone())
        torch.cuda.synchronize()
        runs[route] = (params, opt, torch.stack(losses), read_launches())
    (pe, oe, le, ke), (pg, og, lg, kg) = runs["eager"], runs["graph"]
    same = (torch.equal(le, lg) and all(
        torch.equal(pe[k], pg[k]) and torch.equal(oe["mu"][k], og["mu"][k])
        and torch.equal(oe["nu"][k], og["nu"][k]) for k in pe)
        and torch.equal(oe["count"], og["count"]))
    sfx = "-f32" if f32 else ""
    mine = ("K2" + sfx, "K3" + sfx)
    out = dict(steps=steps, same_bits=same, launches_eager=ke,
               launches_graph=kg)
    print(f"graphs [op path{sfx}]: {json.dumps(out)}", flush=True)
    expect(same, f"graphs [op path{sfx}]: the bits differ")
    for k in (ke, kg):
        expect(all(k[n] == steps for n in mine) and all(
            v == 0 for n, v in k.items() if n not in mine),
            f"graphs [op path{sfx}]: launches {k}")
    return out


def _pose_graph(torch, tr, n_iters=10, reps=5):
    """Pose bursts over the newest two arena rows of a trained map: an
    eager refiner and one on CUDA graphs, each from the same generator
    state and twists; the same bits in every burst, and the ms of a burst
    (CUDA events; after each route's first burst, which the graph route
    spends on its warm-up and capture)."""
    from isdf_tpu_torch.engine import pose as P
    rows = torch.arange(tr.buffer.count - 2, tr.buffer.count, device="cuda")
    out, res = {}, {}
    for route in ("eager", "graph"):
        ref = P.PoseRefiner(tr.model, n_rays=tr.cfg.n_rays,
                            n_surf_samples=tr.cfg.n_surf_samples,
                            min_depth=tr.cfg.min_depth,
                            eager=route == "eager")
        gen = torch.Generator(device="cuda").manual_seed(11)
        state, _ = P.init_pose_state(tr.buffer.capacity, device="cuda")
        outs, ms = [], []
        for i in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, losses = ref(tr.params, state, tr.buffer.depth[rows],
                                tr.buffer.T_WC[rows], rows, tr.fns.dirs,
                                tr.transform_dev, gen, n_steps=n_iters)
            ev[1].record()
            torch.cuda.synchronize()
            if i:
                ms.append(ev[0].elapsed_time(ev[1]))
            outs.append((state.twists.clone(), losses.clone()))
        res[route] = outs
        out[f"burst_ms_{route}"] = sorted(ms)[len(ms) // 2]
    same = all(torch.equal(a, b) for x, y in zip(res["eager"], res["graph"])
               for a, b in zip(x, y))
    out.update(same_bits=same, iterations=n_iters, bursts=reps + 1)
    print(f"graphs [pose burst]: {json.dumps(out)}", flush=True)
    expect(same, "graphs [pose burst]: the bits differ")
    return out


def graph_phase(torch):
    """Phase 10: the captured steps and bursts against the eager loop on
    the card. Same bits on every trainer path of phase 4, the op path of
    phase 5 in both modes, K = 2 scenes in lockstep and a pose burst; no
    host sync inside a bundle; then graph against eager in timings
    (profile_step) on four paths and at K = 2 and 4, a 600-step run's
    wall and the burst's ms. Returns the readings."""
    import gc

    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.train import profile_step
    from isdf_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    out = {"same_bits": {}}
    keep = None
    for label, overrides, expected, _ in TRAINER_PATHS:
        cfg = load_config(CONFIG, overrides=list(overrides or [])
                          + [GRAPH_ARENA])
        tg, out["same_bits"][label] = _same_bits(
            torch, label, lambda i, eager, cfg=cfg: Trainer(
                cfg, seed=1, eager=eager), expected)
        if label == "K1-pc":
            keep = tg[0]
        del tg
        gc.collect()
        torch.cuda.empty_cache()
    for f32 in (False, True):
        out["same_bits"]["op path" + ("-f32" if f32 else "")] = \
            _op_path_graph(torch, f32)
    rooms = ("room_a", "room_b")
    cfgs = [_room_cfg(r, [GRAPH_ARENA]) for r in rooms]
    _, out["same_bits"]["K=2"] = _same_bits(
        torch, "K=2", lambda i, eager: Trainer(cfgs[i], seed=1 + i,
                                               eager=eager),
        ("K1-pc",), scenes=2)
    gc.collect()
    torch.cuda.empty_cache()

    # no host sync inside a bundle of a captured key
    tr = keep
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.fns.train_bundle(tr.params, tr.opt_state, tr.buffer,
                            tr.transform_dev, tr._bundle_seed, 0.0,
                            n_steps=10, lr_scale=0.4, tail=True,
                            step0=tr.steps_taken)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["no_sync_bundle"] = True
    print("graphs [no sync]: a 10-step bundle under "
          "torch.cuda.set_sync_debug_mode('error') ran", flush=True)
    out["pose"] = _pose_graph(torch, tr)
    del tr, keep
    gc.collect()
    torch.cuda.empty_cache()
    out["same_bits_s"] = time.perf_counter() - t0

    # timings, graph against eager in turns
    out["timed"] = {}
    cases = [(label, ov, 1) for label, ov in GRAPH_TIMED] + [
        (f"K{k}-pc", (), k) for k in GRAPH_SCENES]
    for label, ov, k in cases:
        for route in ("eager", "graph"):
            r = profile_step.profile(ov, scenes=k, eager=route == "eager",
                                     warmup=GRAPH_WARMUP, steps=GRAPH_STEPS)
            r.pop("by_kernel")
            out["timed"][f"{label} {route}"] = r
            print(f"graphs [timed {label} {route}]: {json.dumps(r)}",
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        e, g = (out["timed"][f"{label} {x}"] for x in ("eager", "graph"))
        expect(g["billed_device_ms"] <= e["billed_device_ms"],
               f"graphs [{label}]: billed {g['billed_device_ms']:.4f} ms "
               f"a step on graphs, {e['billed_device_ms']:.4f} eager")
    for route in ("eager", "graph"):
        summary, _ = run_trainer(torch, None, max_steps=600,
                                 sim_dt=1.0 / 300, eager=route == "eager")
        out[f"run600_{route}"] = dict(
            wall_s=summary["wall_s"], eval_s=summary["eval_s"],
            device_ms_per_step=summary["device_ms_per_step"],
            captures=summary["captures"], capture_s=summary["capture_s"])
        print(f"graphs [600-step run, {route}]: "
              f"{json.dumps(out[f'run600_{route}'])}", flush=True)
    out["wall_s"] = time.perf_counter() - t0
    return out

# ---------------------------------------------------------------------------
# phase 11: train_vis, its live monitor and the 3-D renders
# ---------------------------------------------------------------------------

VIS_STEPS = 600
# the pinned clock: 0.02 s a step, so that 600 steps span 12 s of simulated
# time (the first frame's 200-step bundle 4 s of it) and the shipped
# eval.eval_freq_s (1 s) calls the monitor about 9 times
VIS_DT = 0.02
VIS_EVERY_S = 1.0
SPHERE_DIM, SPHERE_R = 96, 0.8   # the rasteriser's check: grid, radius


def hull_area(xy):
    """Area of the convex hull of 2-D points (monotone chain)."""
    import numpy as np
    p = sorted(map(tuple, np.asarray(xy, np.float64)))

    def half(pts):
        h = []
        for q in pts:
            while len(h) >= 2 and ((h[-1][0] - h[-2][0]) * (q[1] - h[-2][1])
                                   - (h[-1][1] - h[-2][1])
                                   * (q[0] - h[-2][0])) <= 0:
                h.pop()
            h.append(q)
        return h

    hull = half(p)[:-1] + half(p[::-1])[:-1]
    x, y = np.array(hull).T
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def raster_check():
    """The rasteriser on this host: an analytic sphere's marching-tets
    mesh rendered at a known view. The sphere is convex, so its silhouette
    is the convex hull of its projected vertices: the rendered non-white
    area must be within 1% of the hull's, and two renders the same
    bytes."""
    import numpy as np

    from isdf_tpu_torch.utils import mesh3d, native
    from isdf_tpu_torch.vis import viewer as V

    g = np.linspace(-1, 1, SPHERE_DIM)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + 1.3 * Y ** 2 + Z ** 2) - SPHERE_R
    sp = 2.0 / (SPHERE_DIM - 1)
    verts, faces = mesh3d.marching_tetrahedra(
        sdf, spacing=(sp, sp, sp), origin=(-1.0, -1.0, -1.0))
    expect(native.CALLS["marching_tets"] > 0, "marching tets not native")
    t0 = time.perf_counter()
    expect(native.load("raster") is not None, "raster.cpp did not build")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    view = V.mesh_view(verts, faces, azim=30.0, elev=20.0, size=1280)
    img = view.render()
    ms = 1e3 * (time.perf_counter() - t0)
    img2 = V.render_mesh_image(verts, faces, azim=30.0, elev=20.0,
                               size=1280)
    px, py, _ = view.project(view.proj(), verts)
    area = float((img != 255).any(-1).sum())
    hull = hull_area(np.stack([px, py], 1))
    out = dict(triangles=int(len(faces)), build_s=build_s, render_ms=ms,
               area_px=area,
               hull_px=hull, rel_gap=abs(area - hull) / hull,
               same_bytes=bool(np.array_equal(img, img2)))
    print(f"vis [raster check]: {json.dumps(out)}", flush=True)
    expect(out["rel_gap"] < 0.01, f"raster: silhouette {area:.0f} px "
           f"against the hull's {hull:.0f}")
    expect(out["same_bytes"], "raster: two renders differ")
    return out


def _vis_pin(tr):
    tr._per_step_device_s = VIS_DT


def _plain_vis_run(torch, root, name):
    """The shipped config under train_loop for VIS_STEPS steps, the clock
    pinned at VIS_DT, with a hook that draws nothing: (trainer, result,
    wall s)."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    plain = Trainer(load_config(CONFIG), seed=1)
    _vis_pin(plain)
    os.makedirs(os.path.join(root, name))
    tp = time.perf_counter()
    res = train_loop(plain, max_steps=VIS_STEPS, eval_hook=lambda t: {},
                     save_path=os.path.join(root, name))
    torch.cuda.synchronize()
    return plain, res, time.perf_counter() - tp


def vis_phase(torch, root):
    """Phase 11: train_vis through its main() on the card at full width
    on the shipped synthetic.json (K1-pc on CUDA graphs), the clock pinned
    at VIS_DT through _spy_trainer; its files, its launches, the bits and
    captures of the same run under train_loop with a hook that draws
    nothing; the rasteriser's check; the monitor's seconds by part."""
    import numpy as np

    from isdf_tpu_torch.train import train_vis as TVIS
    from isdf_tpu_torch.utils import image_io as IO
    from isdf_tpu_torch.vis import mesh_export as ME
    from isdf_tpu_torch.vis import raster as RS
    from isdf_tpu_torch.vis import viewer as V

    t0 = time.perf_counter()
    out = {"raster": raster_check()}
    pin, plain_run = _vis_pin, _plain_vis_run

    # a first plain run pays the process's warm-up (lazy CUDA and cuBLAS
    # set-up, the first captures), so the monitored run and the plain run
    # after it are timed alike
    cold, _, wall_cold = plain_run(torch, root, "cold")
    cold_ms = 1e3 * cold.measured_s / VIS_STEPS
    del cold

    times, turn = {}, {"views_ms": []}
    make_hook, turntable = TVIS.make_hook, V.mesh_turntable
    render, reconstruct = RS.View3D.render, ME.reconstruct_mesh

    def timed_render(view):
        t = time.perf_counter()
        img = render(view)
        turn["views_ms"].append(1e3 * (time.perf_counter() - t))
        return img

    def timed_reconstruct(*a, **kw):
        t = time.perf_counter()
        vf = reconstruct(*a, **kw)
        turn["mesh_s"] = time.perf_counter() - t
        return vf

    def timed_turntable(*a, **kw):
        t = time.perf_counter()
        turn["triangles"] = turntable(*a, **kw)
        turn["turntable_s"] = time.perf_counter() - t
        return turn["triangles"]

    save = os.path.join(root, "vis")
    TVIS.make_hook = lambda *a, **kw: make_hook(*a, times=times, **kw)
    V.mesh_turntable, RS.View3D.render = timed_turntable, timed_render
    ME.reconstruct_mesh = timed_reconstruct
    try:
        reset_launches()
        tw = time.perf_counter()
        res, tr = _spy_trainer(lambda: TVIS.main(
            ["--config", CONFIG, "--save_path", save, "--max_steps",
             str(VIS_STEPS), "--monitor_every_s", str(VIS_EVERY_S)]),
            before=pin)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        launches = read_launches()
    finally:
        TVIS.make_hook, V.mesh_turntable = make_hook, turntable
        RS.View3D.render, ME.reconstruct_mesh = render, reconstruct
    expect(res.steps == VIS_STEPS, f"train_vis: {res.steps} steps")
    expect(launches["K1-pc"] == res.steps
           and all(v == 0 for k, v in launches.items() if k != "K1-pc"),
           f"train_vis: launches {launches}")

    # the files: every cycle's six PNGs and the turntable's eight
    mon = os.path.join(save, "monitor")
    n = times.get("cycles", 0)
    expect(n >= 5, f"train_vis: {n} monitor cycles")
    names = [f"{i:04d}_{k}.png" for i in range(n)
             for k in ("keyframes", "latest", "pred_0", "pred_1", "gt_0",
                       "gt_1")]
    names += [os.path.join("final_mesh", f"view_{i:02d}.png")
              for i in range(8)]
    for name in names:
        path = os.path.join(mon, name)
        expect(os.path.exists(path) and os.path.getsize(path) > 0,
               f"train_vis: {name} missing")
        im = IO.imread(path)
        expect(im.ndim == 3 and im.shape[2] == 3 and im.size > 0,
               f"train_vis: {name} does not decode")
    extra = set(os.listdir(mon)) - {os.path.basename(x) for x in names}
    expect(extra == {"final_mesh"}, f"train_vis: unexpected {extra}")

    # the same run with a hook that draws nothing: the same bits, the
    # same captures
    bal = tr.perf_summary()
    plain, res_p, wall_p = plain_run(torch, root, "plain")
    expect(res_p.steps == res.steps, "plain run: steps differ")
    for k in plain.params:
        expect(same_bits(torch, plain.params[k], tr.params[k]),
               f"train_vis: parameter {k} differs from the plain run's")
    caps = [t.fns.graphs.stats["captures"] for t in (tr, plain)]
    expect(caps[0] == caps[1], f"train_vis: captures {caps}")
    total = sum(v for k, v in bal.items() if k != "steps_per_sec")
    views = turn["views_ms"]
    out.update(
        steps=res.steps, cycles=n, launches=launches["K1-pc"],
        captures=caps[0], wall_s=wall, plain_wall_s=wall_p,
        cycle_s={k: times.get(k, 0.0) / max(n, 1)
                 for k in ("latest", "write", "slices")},
        vis_share=bal.get("vis", 0.0) / total if total else 0.0,
        balance=bal, triangles=turn.get("triangles", 0),
        mesh_s=turn.get("mesh_s"), turntable_s=turn.get("turntable_s"),
        view_ms=sum(views) / max(len(views), 1),
        device_ms_per_step=1e3 * tr.measured_s / res.steps,
        device_ms_per_step_plain=1e3 * plain.measured_s / res_p.steps,
        device_ms_per_step_cold=cold_ms, cold_wall_s=wall_cold)
    out["phase_s"] = time.perf_counter() - t0
    print(f"vis: {json.dumps(out)}", flush=True)
    print(f"vis: monitor s a cycle: latest render "
          f"{out['cycle_s']['latest']:.4f}, slices "
          f"{out['cycle_s']['slices']:.4f}, write "
          f"{out['cycle_s']['write']:.4f}; mesh (sparse grid + marching "
          f"tets) {out['mesh_s']:.3f} s; {out['triangles']} triangles, "
          f"{out['view_ms']:.1f} ms a turntable view; vis share "
          f"{out['vis_share']:.4f}; billed device ms/step "
          f"{out['device_ms_per_step']:.4f} with the monitor, "
          f"{out['device_ms_per_step_plain']:.4f} without (a first, "
          f"cold run {cold_ms:.4f}); phase 11 "
          f"{out['phase_s']:.1f} s wall", flush=True)
    expect(out["phase_s"] < 90, f"phase 11: {out['phase_s']:.1f} s wall")
    return out


# ---------------------------------------------------------------------------
# phase 12: the HTTP viewer beside the loop, the loop's live controls, and
# device work off the loop's thread while a step is captured
# ---------------------------------------------------------------------------

# the capture stress run: phase 10's keyed schedule (the 7-row arena) and a
# 4-row arena (smaller than the window, so every fill count is a key of its
# own: more captures), planners querying from other threads throughout
STRESS_ARENAS = (GRAPH_ARENA, "tpu.kf_buffer_size=4")
PLANNER_POINTS = 65536   # points of a planner's /sdf request
PLANNER_BOX = 3.0        # planners' points uniform in [-3, 3]^3 m


class Planners:
    """Threads that query an SDFQueryEngine in a tight loop, as planners
    beside a running trainer do: sdf at PLANNER_POINTS, sdf at sizes drawn
    from 1..PLANNER_POINTS (new shapes, new allocations) and grad at 4,096
    points. Each call's (start, end) on time.perf_counter() goes into
    ``intervals``; an exception ends its thread and goes into
    ``errors``."""

    def __init__(self, engine, seed=0):
        import threading
        self.engine, self.intervals, self.errors = engine, [], []
        self.points = 0
        self.stop_event = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(k, seed + i),
                                         daemon=True)
                        for i, k in enumerate(("sdf", "sdf-any", "grad"))]

    def _run(self, kind, seed):
        import numpy as np
        rng = np.random.default_rng(seed)
        while not self.stop_event.is_set():
            n = {"sdf": PLANNER_POINTS, "grad": 4096}.get(kind) or int(
                rng.integers(1, PLANNER_POINTS + 1))
            pts = rng.uniform(-PLANNER_BOX, PLANNER_BOX,
                              (n, 3)).astype(np.float32)
            t0 = time.perf_counter()
            try:
                v = (self.engine.grad(pts) if kind == "grad"
                     else self.engine.sdf(pts))
                expect(v.shape[0] == n and np.isfinite(v).all(),
                       f"planner {kind}: {v.shape}, non-finite values")
            except Exception as e:   # reported by the phase
                self.errors.append(f"{kind}: {e!r}")
                return
            self.intervals.append((t0, time.perf_counter()))
            self.points += n

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def stop(self):
        self.stop_event.set()
        for t in self.threads:
            t.join(timeout=120)
        expect(not any(t.is_alive() for t in self.threads),
               "planners: a thread did not stop")


def overlaps(caps, queries):
    """For each capture interval, whether some query interval meets it."""
    return [any(q0 < c1 and q1 > c0 for q0, q1 in queries)
            for c0, c1 in caps]


def capture_stress(torch):
    """Phase 10's keyed schedule on the graph route with planners querying
    from other threads throughout: every capture must overlap a query, no
    planner may fail, and the run must keep the eager loop's bits.
    Returns the readings."""
    import numpy as np

    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.serve import SDFQueryEngine
    from isdf_tpu_torch.utils.config import load_config

    out = {}
    for arena in STRESS_ARENAS:
        cfg = load_config(CONFIG, overrides=[arena])
        eager = Trainer(cfg, seed=1, eager=True)
        (le,) = _keyed_run(torch, [eager], GRAPH_CUTS["eager"])
        tr = Trainer(cfg, seed=1)
        planners = Planners(SDFQueryEngine.from_trainer(tr)).start()
        err = None
        t_run = time.perf_counter()
        try:
            (lg,) = _keyed_run(torch, [tr], GRAPH_CUTS["graph"])
            torch.cuda.synchronize()
        except Exception as e:   # reported below
            err, lg = repr(e), None
        finally:
            run_s = time.perf_counter() - t_run
            planners.stop()
        caps = list(tr.fns.graphs.stats["intervals"]) if tr.fns.graphs \
            else []
        hit = overlaps(caps, planners.intervals)
        same = (err is None and np.array_equal(le, lg)
                and all(torch.equal(x, y) for x, y in
                        zip(_train_state(eager), _train_state(tr))))
        out[arena] = r = dict(
            steps=tr.steps_taken, captures=len(caps),
            captures_overlapped=sum(hit), queries=len(planners.intervals),
            planner_points=planners.points, loop_error=err,
            planner_errors=planners.errors, same_bits=same, run_s=run_s,
            capture_ms=[round(1e3 * (b - a), 3) for a, b in caps])
        print(f"serve [capture stress, {arena}]: {json.dumps(r)}",
              flush=True)
        del eager, tr, planners
        torch.cuda.empty_cache()
    return out


SERVE_PAUSE_AT = 200      # steps before the pause run pauses
SERVE_CAP = 5             # iters_per_step of the capped run
SERVE_BILL_TOL = 0.03     # billed ms/step with clients against without
SERVE_REPS = 3            # watched runs, for the bill's spread
# a watched loop's wall, less its own monitor and refresh seconds, against
# the plain loop's: the clients' requests may not hold the loop back more
SERVE_WALL_RATIO = 2.0
CLIENT_PACE_S = 0.05      # a GET cycler's pause between requests
CONTROL_PACE_S = 0.5      # the control poster's
ROUTE_KINDS = ("index", "meta", "status", "control", "query", "slice",
               "render", "scene", "keyframes", "refresh")


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _client_main(vport, qport, stop, results, seed=0):
    """The client process of the watched run: four threads until ``stop``
    is set, then one dict of what they saw into ``results``. Two cycle
    through the viewer's GET routes, one POSTs control toggles, one is a
    planner POSTing PLANNER_POINTS-point /sdf requests. Each request:
    (start s, kind, HTTP code, ms)."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    log, planner = [], {"points": 0, "s": 0.0, "requests": 0, "bad": 0}

    def call(kind, url, body=None):
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url, data=body, method="GET" if body is None
                    else "POST"), timeout=300) as r:
                code, data = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, data = e.code, b""
        except OSError:   # the server is not up yet
            return None
        log.append((t0, kind, code, 1e3 * (time.perf_counter() - t0)))
        return data

    v, q = f"http://127.0.0.1:{vport}", f"http://127.0.0.1:{qport}"
    while call("meta", v + "/api/meta") is None and not stop.is_set():
        time.sleep(0.02)

    def cycler(k):
        rng = np.random.default_rng(seed + k)
        i = 0
        # one whole cycle at least, however short the run
        while not stop.is_set() or i < len(ROUTE_KINDS):
            a = 90 * (i % 4)
            n = rng.integers(0, 200, 3)
            route = {
                "index": "/", "meta": "/api/meta", "status": "/api/status",
                "control": "/api/control",
                "query": "/api/query?i={}&r={}&c={}".format(*n),
                "slice": f"/api/slice/{n[0]}.png",
                "render": f"/api/render.png?azim={a}&elev=25",
                "scene": f"/api/scene.png?azim={a}&elev=25&zoom=1",
                "keyframes": "/api/keyframes.png",
                "refresh": "/api/refresh"}
            kind = ROUTE_KINDS[(i + 5 * k) % len(ROUTE_KINDS)]
            call(kind, v + route[kind])
            i += 1
            time.sleep(CLIENT_PACE_S)

    def controls():
        rng = np.random.default_rng(seed + 7)
        keys = ("do_mesh", "do_slices", "scene_mesh", "scene_frustums",
                "scene_traj", "scene_pc")
        while not stop.is_set():
            d = {k: bool(rng.integers(0, 2)) for k in keys}
            call("post_control", v + "/api/control", json.dumps(d).encode())
            time.sleep(CONTROL_PACE_S)

    def plan():
        rng = np.random.default_rng(seed + 11)
        body = json.dumps({"points": rng.uniform(
            -PLANNER_BOX, PLANNER_BOX, (PLANNER_POINTS, 3)).tolist()}).encode()
        while not stop.is_set():
            t0 = time.perf_counter()
            data = call("sdf", q + "/sdf", body)
            if data is None:
                time.sleep(0.02)
                continue
            sdf = np.asarray(json.loads(data or b'{"sdf": []}').get(
                "sdf", []), np.float32)
            planner["bad"] += int(sdf.shape != (PLANNER_POINTS,)
                                  or not np.isfinite(sdf).all())
            planner["points"] += len(sdf)
            planner["requests"] += 1
            planner["s"] += time.perf_counter() - t0

    threads = [threading.Thread(target=f, args=a, daemon=True) for f, a in
               ((cycler, (0,)), (cycler, (1,)), (controls, ()),
                (plan, ()))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results.put({"log": log, "planner": planner})


def _route_medians(log):
    """Median ms per route kind of the requests that answered 200."""
    import numpy as np
    by = {}
    for _, kind, code, ms in log:
        if code == 200:
            by.setdefault(kind, []).append(ms)
    return {k: float(np.median(v)) for k, v in sorted(by.items())}


def _thread_spy(cls, name, calls):
    """Wrap cls.name to record (thread ident, seconds) of each call into
    ``calls``. Returns the original."""
    import threading
    orig = getattr(cls, name)

    def spy(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(self, *a, **kw)
        finally:
            calls.append((threading.get_ident(),
                          time.perf_counter() - t0))

    setattr(cls, name, spy)
    return orig


def _bill(tr):
    """A run's bill: billed device ms a step, the host seconds of its
    graphs' set-up, each key's eager first step (warm) and its capture,
    and billed ms a step less them. The set-up is billed with the bundle
    it falls in; it is one-off host work that varies from 0.03 to 0.4 s
    from run to run (0.025 to 0.03 typical, 1.3 to 25% of a 600-step
    run's bill)."""
    st = tr.fns.graphs.stats
    setup = st["capture_s"] + st["warm_s"]
    return dict(device_ms_per_step=1e3 * tr.measured_s / VIS_STEPS,
                capture_s=st["capture_s"], warm_s=st["warm_s"],
                steps_ms_per_step=1e3 * (tr.measured_s - setup) / VIS_STEPS)


def _watched_once(torch, root, name):
    """One train_vis --serve --serve-queries run with the client process.
    Returns its readings and trainer; the checks that need no other run
    are made here."""
    import multiprocessing
    import threading

    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.serve import SDFQueryEngine
    from isdf_tpu_torch.train import train_vis as TVIS
    from isdf_tpu_torch.vis import server as SV

    vport, qport = _free_port(), _free_port()
    ctx = multiprocessing.get_context("spawn")
    stop, results = ctx.Event(), ctx.Queue()
    client = ctx.Process(target=_client_main,
                         args=(vport, qport, stop, results), daemon=True)
    client.start()
    seen, webs, main_id, times = {}, [], threading.get_ident(), {}
    refreshes, evals = [], []
    origs = [(SV.ViewerSource, "refresh",
              _thread_spy(SV.ViewerSource, "refresh", refreshes))]
    for fn in ("get_sdf_grid", "sdf_fn", "grad_fn"):
        origs.append((Trainer, fn, _thread_spy(Trainer, fn, evals)))
    start, make_hook = SV.SDFWebViewer.start, TVIS.make_hook

    def record(self):
        webs.append(self)
        return start(self)

    def before(tr):
        _vis_pin(tr)
        seen["loop_t0"] = time.perf_counter()

    def after(tr):
        torch.cuda.synchronize()
        seen["loop_s"] = time.perf_counter() - seen["loop_t0"]
        # the clients stop while the servers still answer
        stop.set()
        seen["clients"] = results.get(timeout=600)

    SV.SDFWebViewer.start = record
    TVIS.make_hook = lambda *a, **kw: make_hook(*a, times=times, **kw)
    try:
        reset_launches()
        tw = time.perf_counter()
        res, tr = _spy_trainer(lambda: TVIS.main(
            ["--config", CONFIG, "--save_path", os.path.join(root, name),
             "--max_steps", str(VIS_STEPS), "--monitor_every_s",
             str(VIS_EVERY_S), "--serve", str(vport), "--serve-queries",
             str(qport)]), before=before, after=after)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        launches = read_launches()
    finally:
        stop.set()
        SV.SDFWebViewer.start, TVIS.make_hook = start, make_hook
        for cls, fn, orig in origs:
            setattr(cls, fn, orig)
        client.join(timeout=60)
        if client.is_alive():
            client.kill()
    expect(res.steps == VIS_STEPS, f"{name}: {res.steps} steps")
    log, planner = seen["clients"]["log"], seen["clients"]["planner"]
    # the trainer's K1-pc once a step, the planner's /sdf requests the
    # query kernel once a chunk, and no other kernel
    chunks = planner["requests"] * -(-PLANNER_POINTS
                                     // SDFQueryEngine.chunk_size)
    expect(launches["K1-pc"] == res.steps and chunks >= 1
           and launches["query_sdf"] == chunks
           and all(v == 0 for k, v in launches.items()
                   if k not in ("K1-pc", "query_sdf")),
           f"{name}: launches {launches}, {chunks} query chunks")
    first_kf = min([t for t, k, c, _ in log if k == "keyframes" and c == 200],
                   default=float("inf"))
    bad = [(k, c) for t, k, c, _ in log if c != 200
           and not (k == "keyframes" and c == 404 and t < first_kf)]
    expect(not bad, f"{name}: responses {bad[:10]}")
    kinds = {k for _, k, c, _ in log if c == 200}
    expect(kinds >= set(ROUTE_KINDS) | {"post_control", "sdf"},
           f"{name}: routes answered {sorted(kinds)}")
    expect(planner["requests"] > 0 and planner["bad"] == 0,
           f"{name}: planner {planner}")
    expect(refreshes and all(i == main_id for i, _ in refreshes),
           f"{name}: {len(refreshes)} refreshes, threads "
           f"{sorted({i for i, _ in refreshes})}, loop thread {main_id}")
    expect(all(i == main_id for i, _ in evals),
           f"{name}: the map evaluated off the loop's thread")
    (web,) = webs
    return dict(
        steps=res.steps, launches=launches["K1-pc"],
        captures=tr.fns.graphs.stats["captures"], wall_s=wall,
        loop_s=seen["loop_s"],
        # the loop thread's own viewer work: monitor cycles and refreshes
        loop_vis_s=sum(times.get(k, 0.0) for k in
                       ("latest", "write", "slices", "refresh")),
        requests=len(log), route_ms=_route_medians(log),
        refreshes_on_loop=len(refreshes),
        planner_points_per_s=planner["points"] / max(planner["s"], 1e-9),
        planner_requests=planner["requests"],
        **_bill(tr)), tr, web


def _watched_run(torch, root):
    """Phase 12 (a): SERVE_REPS pairs of a plain run and a watched, queried
    run, each watched run held to the first plain run's bits and to its
    pair's captures; the median bill less the graphs' set-up with
    clients within
    SERVE_BILL_TOL of the plain runs' (see _bill), and
    each watched loop's wall, less its own monitor and refresh seconds,
    within SERVE_WALL_RATIO of its pair's plain loop. Returns the readings
    and the first plain run's trainer."""
    import numpy as np

    runs, plains, plain = [], [], None
    for i in range(SERVE_REPS):
        # the last run's garbage is not collected inside this one's bundles
        gc.collect()
        p, _, wall_p = _plain_vis_run(torch, root, f"served_plain_{i}")
        plains.append(dict(wall_s=wall_p,
                           captures=p.fns.graphs.stats["captures"],
                           **_bill(p)))
        if plain is None:
            plain = p
        del p
        gc.collect()
        r, tr, web = _watched_once(torch, root, f"served_{i}")
        for k in plain.params:
            expect(same_bits(torch, plain.params[k], tr.params[k]),
                   f"watched run {i}: parameter {k} differs from the plain "
                   "run's")
        r["loop_wall_ratio"] = (r["loop_s"] - r["loop_vis_s"]) / wall_p
        runs.append(r)
        del tr
    # the refresh at grid_dim 200, timed alone on the last run's final map
    t = time.perf_counter()
    web.source.refresh()
    refresh_s = time.perf_counter() - t
    del web
    med = {k: [float(np.median([r[k] for r in rs])) for rs in (runs, plains)]
           for k in ("device_ms_per_step", "steps_ms_per_step", "capture_s",
                     "warm_s")}
    out = dict(runs=runs, plains=plains, medians=med,
               refresh_s_grid200=refresh_s)
    print(f"serve [watched]: {json.dumps(out)}", flush=True)

    def row(k, fmt):
        return " / ".join(", ".join(fmt.format(r[k]) for r in rs)
                          for rs in (runs, plains))
    print("serve [watched]: with clients / without: billed device ms/step "
          + row("device_ms_per_step", "{:.4f}") + "; captures s "
          + row("capture_s", "{:.4f}") + "; warm-up s "
          + row("warm_s", "{:.4f}") + "; billed ms/step less the set-up "
          + row("steps_ms_per_step", "{:.4f}") + "; the loop's wall less "
          "its own viewer work against its plain loop's " + ", ".join(
              f"{r['loop_wall_ratio']:.2f}x" for r in runs), flush=True)
    expect(all(r["captures"] == p["captures"] for r, p in zip(runs, plains)),
           f"watched run: captures {[r['captures'] for r in runs]} against "
           f"{[p['captures'] for p in plains]}")
    w, p = med["steps_ms_per_step"]
    expect(abs(w - p) <= SERVE_BILL_TOL * p,
           f"watched run: billed {w:.4f} ms/step less the graphs' set-up "
           f"with clients, {p:.4f} without (medians)")
    expect(all(r["loop_wall_ratio"] <= SERVE_WALL_RATIO for r in runs),
           "watched run: the loop's wall against the plain loop's " + ", ".join(
               f"{r['loop_wall_ratio']:.2f}x" for r in runs))
    return out, plain


def _status(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/status",
                                timeout=60) as r:
        return json.loads(r.read())


def _pause_run(torch, root, plain):
    """Phase 12 (c): train_vis --serve paused over HTTP at about step
    SERVE_PAUSE_AT for over 2 s of wall: the steps stand for 1.2 s, then
    two status reads 1 s apart are the same; then the plain run's bits
    and clock."""
    import threading
    import urllib.request

    from isdf_tpu_torch.train import train_vis as TVIS

    port, out = _free_port(), {}

    def post(d):
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/api/control",
            data=json.dumps(d).encode(), method="POST"), timeout=60).read()

    def controller():
        try:
            while True:
                try:
                    s = _status(port)
                except OSError:
                    time.sleep(0.02)
                    continue
                if s["steps"] >= SERVE_PAUSE_AT:
                    break
                time.sleep(0.01)
            post({"paused": True})
            t0 = time.perf_counter()
            # the loop ends its bundle and monitor cycle, then sits in its
            # control hook: wait for the steps to stand for 1.2 s
            last, since = _status(port)["steps"], time.perf_counter()
            while time.perf_counter() - since < 1.2:
                time.sleep(0.1)
                n = _status(port)["steps"]
                if n != last:
                    last, since = n, time.perf_counter()
            out["a"] = _status(port)
            time.sleep(1.0)
            out["b"] = _status(port)
            out["paused_s"] = time.perf_counter() - t0
        finally:
            post({"paused": False})

    th = threading.Thread(target=controller, daemon=True)
    th.start()
    res, tr = _spy_trainer(lambda: TVIS.main(
        ["--config", CONFIG, "--save_path", os.path.join(root, "paused"),
         "--max_steps", str(VIS_STEPS), "--monitor_every_s",
         str(VIS_EVERY_S), "--serve", str(port)]), before=_vis_pin)
    th.join(timeout=60)
    expect(not th.is_alive() and "b" in out, "pause run: no pause read")
    a, b = out["a"], out["b"]
    expect(a["paused"] and (a["steps"], a["sim_time_s"])
           == (b["steps"], b["sim_time_s"]) and a["steps"] < res.steps
           and out["paused_s"] >= 2.0, f"pause run: status {a} then {b} "
           f"over {out['paused_s']:.2f} s")
    for k in plain.params:
        expect(same_bits(torch, plain.params[k], tr.params[k]),
               f"pause run: parameter {k} differs from the plain run's")
    expect(tr.tot_step_time == plain.tot_step_time,
           f"pause run: sim clock {tr.tot_step_time} against "
           f"{plain.tot_step_time}")
    return dict(paused_at=a["steps"], sim_time_s=a["sim_time_s"],
                paused_s=out["paused_s"], steps=res.steps)


def _capped_run(torch, root):
    """Phase 12 (d): iters_per_step SERVE_CAP set through the viewer's
    controls caps every bundle; the run takes its VIS_STEPS steps."""
    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    from isdf_tpu_torch.vis.server import ViewerSource

    tr = Trainer(load_config(CONFIG), seed=1)
    _vis_pin(tr)
    src = ViewerSource.from_trainer(tr, loop_attached=True)
    src.update_controls({"iters_per_step": SERVE_CAP})
    sizes, run = [], tr.run_steps

    def spy(n):
        sizes.append(n)
        return run(n)

    tr.run_steps = spy
    os.makedirs(os.path.join(root, "capped"))
    res = train_loop(tr, max_steps=VIS_STEPS, eval_hook=lambda t: {},
                     save_path=os.path.join(root, "capped"),
                     control_hook=src.get_controls)
    expect(res.steps == sum(sizes) == VIS_STEPS and max(sizes) <= SERVE_CAP,
           f"capped run: {res.steps} steps, bundles up to {max(sizes)}")
    return dict(steps=res.steps, bundles=len(sizes), largest=max(sizes))


def serve_phase(torch, root):
    """Phase 12: the HTTP viewer and the query service beside the loop,
    the live controls, and the capture stress run. Returns the
    readings."""
    t0 = time.perf_counter()
    # a first plain run pays the process's warm-up (phase 11's reason)
    cold, _, _ = _plain_vis_run(torch, root, "serve_cold")
    del cold
    out = {}
    out["watched"], plain = _watched_run(torch, root)
    out["pause"] = _pause_run(torch, root, plain)
    del plain
    out["capped"] = _capped_run(torch, root)
    out["stress"] = capture_stress(torch)
    for arena, r in out["stress"].items():
        expect(r["loop_error"] is None and not r["planner_errors"],
               f"capture stress [{arena}]: {r['loop_error']} "
               f"{r['planner_errors']}")
        expect(r["captures"] > 0
               and r["captures_overlapped"] == r["captures"],
               f"capture stress [{arena}]: {r['captures_overlapped']} of "
               f"{r['captures']} captures overlap a query")
        expect(r["same_bits"], f"capture stress [{arena}]: the bits differ "
               "from the eager loop's")
    out["phase_s"] = time.perf_counter() - t0
    w, wl = out["watched"], out["watched"]["runs"][-1]
    print(f"serve: {json.dumps(out)}", flush=True)
    # the last run's: the first run's first planner request waits for the
    # query service's JSON worker to start
    print("serve: median ms per route (last watched run): " + ", ".join(
        f"{k} {v:.1f}" for k, v in wl["route_ms"].items())
        + f"; refresh {w['refresh_s_grid200']:.3f} s at grid_dim 200; "
        "planner M points/s while training " + ", ".join(
            f"{r['planner_points_per_s'] / 1e6:.4f} "
            f"({r['planner_requests']} requests)" for r in w["runs"])
        + "; billed device ms/step {:.4f} with clients, {:.4f} without, "
        "less the set-up {:.4f}, {:.4f} (medians of {}); watched runs ".format(
            *w["medians"]["device_ms_per_step"],
            *w["medians"]["steps_ms_per_step"], SERVE_REPS) + ", ".join(
            f"{r['wall_s']:.1f}" for r in w["runs"]) + " s wall (plain loops "
        + ", ".join(f"{p['wall_s']:.1f}" for p in w["plains"])
        + f"); phase 12 {out['phase_s']:.1f} s wall", flush=True)
    expect(out["phase_s"] < 120, f"phase 12: {out['phase_s']:.1f} s wall")
    return out


# ---------------------------------------------------------------------------
# phase 13: the 2-D plot kit, the three figures and the debug oracles
# ---------------------------------------------------------------------------

PLOTS_STEPS = 300
PLOTS_DT = 0.01          # 3 s of sim time: three timed evals in res.json
TOL_ORACLE = 1e-5        # the oracles' curves, card against CPU copies


def _cpu_twin(trainer):
    """The trainer's arena, camera rays, config and oracles with the
    arena and rays copied to the host: the oracles then sample and bound
    on the CPU and query the same sdf_fn on the card."""
    import types
    buf = trainer.buffer
    cpu_buf = types.SimpleNamespace(
        depth=buf.depth.cpu(), T_WC=buf.T_WC.cpu(), count=buf.count,
        normals=None if buf.normals is None else buf.normals.cpu())
    return types.SimpleNamespace(
        buffer=cpu_buf, cfg=trainer.cfg, dirs_C=trainer.dirs_C.cpu(),
        H=trainer.H, W=trainer.W, sdf_fn=trainer.sdf_fn,
        gt_sdf_fn=trainer.gt_sdf_fn)


def _draws(torch, trainer, T, seed):
    """Pixel and sample draws for T rays, made on the card."""
    g = torch.Generator(device=trainer.device).manual_seed(seed)
    cfg, dev = trainer.cfg, trainer.device
    return (torch.randint(0, trainer.H, (T,), generator=g, device=dev),
            torch.randint(0, trainer.W, (T,), generator=g, device=dev),
            torch.rand((T, cfg.n_strat_samples), generator=g, device=dev),
            torch.randn((T, cfg.n_surf_samples - 1), generator=g,
                        device=dev))


def _write_exp0(root, res, seqs, repeats):
    """<root>/<seq>_<i>/vox_res.json in isdf_tpu's (the reference's exp0)
    layout from this run's timed entries: av_l1 and the CHOMP costs of
    each entry, scaled per repeat, both regions; seeded cosine
    distances."""
    import numpy as np
    rng = np.random.default_rng(0)
    entries = [e for e in res["sdf_eval"].values() if "rays" in e]
    for k, seq in enumerate(seqs):
        for i in range(repeats):
            d = os.path.join(root, f"{seq}_{i}")
            os.makedirs(d)
            out = {}
            for e in entries:
                s = (1.0 + 0.1 * i) * (1.0 + 0.2 * k)
                region = {"av_l1": s * e["rays"]["av_l1"],
                          "l1_chomp_costs": [s * c for c in
                                             e["rays"]["l1_chomp_costs"]],
                          "av_cossim": rng.random(3).tolist()}
                out[f"{e['time']:.3f}"] = {"time": e["time"], "rays": {
                    "vis": region, "vox": dict(region)}}
            with open(os.path.join(d, "vox_res.json"), "w") as f:
                json.dump(out, f)


def _px(w_in, h_in, dpi):
    """The canvas matplotlib makes of a figure: (int(h dpi), int(w dpi))."""
    return int(h_in * dpi), int(w_in * dpi)


def _read_png(path, shape=None):
    """Decode a figure with the port's codec; its size and that it is
    not blank."""
    import numpy as np

    from isdf_tpu_torch.utils import image_io as IO
    img = IO.imread(path)
    if shape is not None:
        expect(img.shape[:2] == shape, f"{path}: {img.shape} not {shape}")
    ink = (img != 255).any(-1).mean()
    expect(0.01 < ink < 0.9 and len(np.unique(img.reshape(-1, 3), axis=0))
           > 8, f"{path}: blank ({ink:.4f} of the pixels drawn)")
    return img


def plots_phase(torch, root):
    """Phase 13: the shipped synthetic.json at full width on the graph
    route (K1-pc) for PLOTS_STEPS steps, then the debug oracles on the
    card held to CPU copies of the same draws and the five figures drawn
    by the port's plot kit, each read back."""
    import numpy as np

    from isdf_tpu_torch.engine.loop import train_loop
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.eval import debug as D
    from isdf_tpu_torch.eval import figs
    from isdf_tpu_torch.utils.config import load_config
    from isdf_tpu_torch.vis import debug as VD

    t_phase = time.perf_counter()
    trainer = Trainer(load_config(CONFIG), seed=1)
    assert trainer.device.type == "cuda"
    trainer._per_step_device_s = PLOTS_DT
    run_dir = os.path.join(root, "run")
    os.makedirs(run_dir)
    reset_launches()
    res = train_loop(trainer, max_steps=PLOTS_STEPS, save_path=run_dir)
    torch.cuda.synchronize()
    launches = read_launches()
    expect(launches["K1-pc"] == res.steps == PLOTS_STEPS and all(
        v == 0 for k, v in launches.items() if k != "K1-pc"),
        f"plots: launches {launches} in {res.steps} steps")
    billed = 1e3 * trainer.measured_s / res.steps
    stats = getattr(trainer.fns.graphs, "stats", None) or {}
    cap_s = stats.get("capture_s", 0.0)
    with open(os.path.join(run_dir, "res.json")) as f:
        saved = json.load(f)
    expect(len(saved["sdf_eval"]) >= 2, "plots: res.json has no evals")

    out = {"steps": res.steps, "billed_device_ms_per_step": billed,
           "captures": stats.get("captures", 0), "capture_s": cap_s,
           "keyframes": len(res.kf_indices), "figure_s": {}}
    twin = _cpu_twin(trainer)

    # ray_oracle: sampling, bounds and sdf_fn on the card; the same draws
    # on CPU copies
    t0 = time.perf_counter()
    n_rays = 3
    d = _draws(torch, trainer, max(4 * n_rays, 64), 5)
    rays = D.ray_oracle(trainer, n_rays=n_rays, draws=d)
    rays_cpu = D.ray_oracle(twin, n_rays=n_rays,
                            draws=tuple(x.cpu() for x in d))
    err = max(float(np.abs(a[k] - b[k]).max()) for a, b in
              zip(rays, rays_cpu) for k in ("z", "ray", "normal", "pc",
                                            "gt"))
    pred_err = max(float(np.abs(a["pred"] - b["pred"]).max())
                   for a, b in zip(rays, rays_cpu))
    expect(len(rays) == n_rays and err <= TOL_ORACLE,
           f"ray_oracle: card against CPU {err:.3g}")
    expect(pred_err <= TOL_ORACLE, f"ray_oracle: pred {pred_err:.3g}")
    expect(all(np.isfinite(r[k]).all() for r in rays for k in r),
           "ray_oracle: non-finite curves")
    out["oracle_s"] = time.perf_counter() - t0
    out["ray_oracle_max_err"], out["ray_oracle_pred_err"] = err, pred_err

    # check_gt_sdf: the same, then its figure from its own generator
    t0 = time.perf_counter()
    d = _draws(torch, trainer, 100, 6)
    rows = VD.check_gt_sdf(trainer, draws=d)
    rows_cpu = VD.check_gt_sdf(twin, draws=tuple(x.cpu() for x in d))
    err = max(float(np.abs(rows[i][k] - rows_cpu[i][k]).max())
              for i in rows for k in ("z", "gt_sdf", "ray", "pc", "normal")
              if rows[i][k] is not None)
    expect(list(rows) == [9, 19, 23] and err <= TOL_ORACLE,
           f"check_gt_sdf: card against CPU {err:.3g}")
    out["check_gt_sdf_max_err"] = err
    out["check_s"] = time.perf_counter() - t0

    def timed(name, fn, shape=None):
        t = time.perf_counter()
        path = fn(os.path.join(root, name + ".png"))
        out["figure_s"][name] = time.perf_counter() - t
        _read_png(path, shape)

    timed("check_gt_sdf", lambda p: VD.check_gt_sdf(trainer, out_file=p),
          _px(11, 3.3 * 3, 120))
    timed("ray_oracle_figure",
          lambda p: D.ray_oracle_figure(trainer, p, rays=rays))
    timed("vis_embedding", lambda p: D.vis_embedding(p), _px(8, 3.2, 110))
    B = torch.randn((3, 16), device=trainer.device) * 4
    timed("vis_embedding_gauss", lambda p: D.vis_embedding(p, B=B),
          _px(8, 3.2, 110))
    timed("plot_per_seq", lambda p: figs.plot_per_seq(
        run_dir, p, dataset=trainer.dataset), _px(16, 9, 120))
    exp0 = os.path.join(root, "exp0")
    seqs = ["apt_2_nav", "apt_3_obj", "scene0010_00"]
    _write_exp0(exp0, saved, seqs, 3)
    timed("plot_all_seq", lambda p: figs.plot_all_seq(exp0, p),
          _px(5 * 3, 3.5, 120))
    stats = {}

    def fig8(p):
        stats.update(figs.plot_fig8(exp0, p, seq_rows=[
            seqs[:2], [seqs[2], "scene0031_00"]]))
        return p
    timed("plot_fig8", fig8, _px(4.3 * 2, 3.2 * 6, 110))
    expect(sorted(stats) == sorted(seqs) and all(
        s["sdf"][3] == 3 for s in stats.values()), f"plot_fig8: {stats}")
    out["phase_s"] = time.perf_counter() - t_phase
    print("plots: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                               out["figure_s"].items())
          + f"; oracles {out['oracle_s']:.2f} s, check_gt_sdf "
          f"{out['check_s']:.2f} s (card against CPU: ray_oracle "
          f"{out['ray_oracle_max_err']:.3g}, pred "
          f"{out['ray_oracle_pred_err']:.3g}, check_gt_sdf "
          f"{out['check_gt_sdf_max_err']:.3g}); {res.steps} steps, "
          f"{out['keyframes']} keyframes, billed device ms/step "
          f"{billed:.4f} ({out['captures']} captures, {cap_s:.4f} s; less "
          f"captures {billed - 1e3 * cap_s / res.steps:.4f}); launches "
          f"{launches}; phase 13 "
          f"{out['phase_s']:.1f} s wall", flush=True)
    expect(out["phase_s"] < 90, f"phase 13: {out['phase_s']:.1f} s wall")
    return out


# ---------------------------------------------------------------------------
# phase 14: data parallelism over a ray mesh and fleet mode, on one card
# ---------------------------------------------------------------------------

# the bounds of isdf_tpu's own dp test over its 4-step bundle (tests/
# test_parallel.py:52-69). The parameters are held after the first step,
# every entry: later, AdamW's steps lr * g / (|g| + 1e-8) on gradients
# near the epsilon take the sign that the order of the sums gives them
# (full width, bf16 products: 2.1e-3 apart after 10 steps, PERF.md
# section 6)
DP_LOSS_RTOL, DP_LOSS_ATOL, DP_PARAMS, DP_STEPS = 2e-4, 1e-5, 5e-5, 4
# a fleet round's bill against the lockstep stepper's for the same scenes
FLEET_BILL_REL = 0.05
# the fleet runs' arena rows (the shipped 160 cut: 3 x K trainers at once)
FLEET_ARENA = "tpu.kf_buffer_size=16"
NONFUSED = "tpu.pe_in_kernel=false"


def _dp_sets(devices, sets=()):
    return list(sets) + ([f"tpu.data_parallel={len(devices)}"]
                         if devices else [])


def _first_bundle(torch, devices, sets=(), n=DP_STEPS):
    """A trainer on ``devices`` (None: one card; a list: its dp mesh) from
    seed 1 with two keyframes, then ``n`` steps, cut 1 + (n - 1). Returns
    (trainer, the n losses, the parameters after the first step, its
    gradient, the launches)."""
    import numpy as np
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, overrides=_dp_sets(devices, sets))
    tr = Trainer(cfg, seed=1, device=devices)
    for fid in (0, 30):
        tr.last_is_keyframe = True
        tr.add_frame(tr.get_data([fid])[0])
    first, update = [], tr.fns.update

    def recording(params, opt_state, buf, grads, *rest):
        if not first:   # the key's first step, run eagerly before capture
            first.append(tuple(g.clone() for g in grads))
        return update(params, opt_state, buf, grads, *rest)
    tr.fns.update = recording
    reset_launches()
    s1 = tr.run_steps(1)
    p1 = {k: v.clone() for k, v in tr.params.items()}
    s2 = tr.run_steps(n - 1)
    torch.cuda.synchronize()
    tr.fns.update = update
    return (tr, np.concatenate([s1["total_loss"], s2["total_loss"]]), p1,
            first[0], read_launches())


def _dp_parity(torch, label, ref, devices, n=DP_STEPS):
    """dp = len(devices) against dp = 1 (``ref``) over the first ``n``
    steps: the losses, the first step's gradient by block (the kernel
    table's limit) and the parameters after it."""
    import numpy as np
    _, ref_loss, ref_p1, ref_g, _ = ref
    tr, loss, p1, g, launches = _first_bundle(
        torch, devices, ["model.refine_poses=1"], n)
    rel = float(np.max(np.abs(loss - ref_loss) / np.abs(ref_loss)))
    kb = grad_blocks(tr.model, *g)
    pb = grad_blocks(tr.model, *ref_g)
    gblock = max(rel_err(kb[key], pb[key])[1] for key in kb)
    d_all = max((p1[k] - ref_p1[k]).abs().max().item() for k in ref_p1)
    print(f"parallel [{label}]: losses of {n} steps {loss.tolist()} against "
          f"dp = 1 {ref_loss.tolist()}: max rel {rel:.3e} (rtol "
          f"{DP_LOSS_RTOL}, atol {DP_LOSS_ATOL}); first step's gradient "
          f"max block err {gblock:.3e} (tol {TOL_GRAD}); parameters after "
          f"it max |diff| {d_all:.3e} (tol {DP_PARAMS}); launches "
          f"{launches}", flush=True)
    expect(np.allclose(loss, ref_loss, rtol=DP_LOSS_RTOL, atol=DP_LOSS_ATOL),
           f"parallel [{label}]: losses differ from dp = 1")
    expect(gblock <= TOL_GRAD, f"parallel [{label}]: the gradient differs")
    expect(d_all < DP_PARAMS, f"parallel [{label}]: parameters differ")
    D = len(devices)
    expect(launches["K1-pc"] == D * n and all(
        v == 0 for k, v in launches.items() if k != "K1-pc"),
        f"parallel [{label}]: launches {launches}, not {D} K1-pc a step")
    return tr, dict(loss_rel=rel, grad_block_err=gblock,
                    params_max_diff=d_all)


def _nonfused_first_step(torch, devices):
    """One step of the dp trainer without the fused op through K2/K3,
    against the same step through the plain reverse-fused op on the same
    draws: the loss, K2's outputs on each shard's inputs, and the step's
    parameter gradient (each shard's K3, added in shard order) by block
    against the plain op's VJP on the same cotangents."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.models.fused_vjp import make_reverse_fused_mlp
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, overrides=_dp_sets(devices, [NONFUSED]))
    runs = {}
    for kind in ("kernel", "plain"):
        tr = Trainer(cfg, seed=1, device=devices, eager=True)
        model = tr.model
        assert tr.fns.train_op is None and tr.fns.rf_op is not None
        grads, seen, update = [], [], tr.fns.update
        op = (make_reverse_fused_mlp(tr.model) if kind == "plain"
              else tr.fns.rf_op)

        def record_grads(params, opt_state, buf, g, *rest, grads=grads,
                         update=update):
            grads.append(tuple(x.clone() for x in g))
            return update(params, opt_state, buf, g, *rest)

        def recording(p, *a, op=op, seen=seen):
            out = op(p, *a)
            # copies: the leaves alias the parameters, which AdamW updates
            # in place; the hooks keep each output's cotangent
            cot = [None, None]
            seen.append(({k: v.detach().clone() for k, v in p.items()}, a,
                         tuple(o.detach() for o in out), cot))
            for i, o in enumerate(out):
                o.register_hook(lambda g, i=i, cot=cot:
                                cot.__setitem__(i, g.detach().clone()))
            return out
        tr.fns.update, tr.fns.rf_op = record_grads, recording
        for fid in (0, 30):
            tr.last_is_keyframe = True
            tr.add_frame(tr.get_data([fid])[0])
        reset_launches()
        runs[kind] = (float(tr.run_steps(1)["total_loss"][0]),
                      read_launches(), grads, seen)
        del tr
    (lk, launches, gk, seen), (lp, _, gp, seen_p) = (runs["kernel"],
                                                    runs["plain"])
    loss_rel = abs(lk - lp) / abs(lp)
    expect(len(gk) == len(gp) == 1, "K2/K3 route: not one update a step")
    plain = make_reverse_fused_mlp(model)

    def plain_vjp(records):
        """The plain op's parameter VJP on each shard's inputs and
        cotangents, added in shard order."""
        out = None
        for p, a, _, cot in records:
            q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            with torch.enable_grad():
                g = torch.autograd.grad(plain(q, *a), (q["Wp"], q["bp"]),
                                        tuple(cot))
            out = g if out is None else tuple(x + y for x, y in zip(out, g))
        return out

    def block_errs(x, y):
        bx, by = grad_blocks(model, *x[:2]), grad_blocks(model, *y[:2])
        return {key: rel_err(bx[key], by[key])[1] for key in bx}
    same_cot = plain_vjp(seen)
    # K3 is held on the kernel step's own cotangents (phase 5's same-cot
    # rows). Against the plain trainer's gradient the step also carries
    # K2's rounding through the loss into the cotangents: the plain VJP
    # alone, on the two runs' cotangents, reads 5.6e-4 of a block (PERF.md
    # section 6), so those two are printed, not held to K3's limit
    e_k3 = block_errs(gk[0], same_cot)
    e_step = block_errs(gk[0], gp[0])
    e_cot = block_errs(same_cot, plain_vjp(seen_p))
    gblock = max(e_k3.values())
    max_rel, rms = 0.0, 0.0
    for p, a, (raw, graw), _ in seen:
        raw_p, graw_p = plain(p, *a)
        for x, y in ((raw, raw_p),) + tuple((graw[:, c], graw_p[:, c])
                                            for c in range(3)):
            max_rel = max(max_rel, rel_err(x, y)[1])
            rms = max(rms, rms_err(x, y))
    D = len(devices)
    print(f"parallel [dp={D} K2/K3]: first step loss kernel {lk} plain {lp} "
          f"(rel {loss_rel:.3e}, tol {TOL_LOSS_REL}); K2 on {len(seen)} "
          f"shards: max err / max {max_rel:.3e} (tol {TOL_RAW}), norm "
          f"{rms:.3e} (tol {TOL_RAW_RMS}); launches {launches}", flush=True)
    for label, e in ((f"K3 on the same cotangents (tol {TOL_GRAD})", e_k3),
                     ("the whole step (printed)", e_step),
                     ("the cotangents alone (printed)", e_cot)):
        print(f"parallel [dp={D} K2/K3]: gradient by block, {label}: max "
              f"{max(e.values()):.3e}; " + ", ".join(
                  f"{k} {v:.3e}" for k, v in e.items()), flush=True)
    expect(len(seen) == D, f"K2/K3 route: {len(seen)} shard calls, not {D}")
    expect(launches["K2"] == D and launches["K3"] == D,
           f"K2/K3 route: launches {launches} in one step")
    expect(loss_rel <= TOL_LOSS_REL, "K2/K3 route: first losses disagree")
    expect(max_rel <= TOL_RAW and rms <= TOL_RAW_RMS,
           "K2/K3 route: K2 disagrees with the plain op")
    expect(gblock <= TOL_GRAD, "K2/K3 route: K3's gradient disagrees with "
           "the plain op")
    return dict(loss_rel=loss_rel, k2_max_rel=max_rel, k2_rms=rms,
                k3_grad_block_err=gblock,
                step_grad_block_err=max(e_step.values()),
                cot_grad_block_err=max(e_cot.values()))


def _fleet(torch, K, rounds=6, B=10):
    """K scenes (the shipped config, seeds 1..K, arena cut to 16 rows) on a
    2-shard "scene" mesh of the one card, beside the lockstep stepper over
    copies of them, round for round, and each scene's solo run."""
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.parallel.mesh import make_mesh
    from isdf_tpu_torch.parallel.multi_scene import MultiSceneStepper
    from isdf_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, overrides=[FLEET_ARENA])

    def scenes():
        out = []
        for i in range(K):
            tr = Trainer(cfg, seed=1 + i)
            for fid in (0, 30 + 10 * i):
                tr.last_is_keyframe = True
                tr.add_frame(tr.get_data([fid])[0])
            out.append(tr)
        return out
    fleet, lock, solo = scenes(), scenes(), scenes()
    mesh = make_mesh(axis="scene", devices=["cuda:0", "cuda:0"])
    steppers = {"fleet": MultiSceneStepper(fleet, mesh=mesh),
                "lockstep": MultiSceneStepper(lock)}
    bills = {k: [] for k in steppers}
    reset_launches()
    for _ in range(rounds):
        for k, st in steppers.items():
            st.run_steps(B)
            bills[k].append(st.last_bundle_dt)
    launches = read_launches()
    for tr in solo:
        for _ in range(rounds):
            tr.run_steps(B)
    torch.cuda.synchronize()
    same = all(torch.equal(a.params[k], b.params[k])
               and torch.equal(a.params[k], c.params[k])
               for a, b, c in zip(fleet, lock, solo) for k in a.params)
    # the first round captures each scene's step; later rounds replay
    ratios = [f / l for f, l in zip(bills["fleet"][1:], bills["lockstep"][1:])]
    print(f"parallel [fleet K={K}, 2 blocks on one card]: bills ms per "
          f"round fleet {[round(1e3 * b, 4) for b in bills['fleet']]}, "
          f"lockstep {[round(1e3 * b, 4) for b in bills['lockstep']]}; "
          f"fleet / lockstep after the first {[round(r, 4) for r in ratios]}"
          f" (limit {FLEET_BILL_REL}); every scene its solo bits: {same}; "
          f"launches {launches}", flush=True)
    expect(same, f"fleet K={K}: a scene lost its solo bits")
    expect(all(abs(r - 1.0) <= FLEET_BILL_REL for r in ratios),
           f"fleet K={K}: a round's bill is not the lockstep stepper's")
    expect(launches["K1-pc"] == 2 * K * rounds * B,
           f"fleet K={K}: launches {launches}")
    return dict(bill_ms=[1e3 * b for b in bills["fleet"]],
                lockstep_bill_ms=[1e3 * b for b in bills["lockstep"]],
                ratios=ratios)


def parallel_phase(torch):
    """Phase 14: the port's data parallelism and fleet mode on the one
    card, at full width (synthetic.json, 27,000 points a step)."""
    from isdf_tpu_torch.train.profile_step import profile
    t_phase = time.perf_counter()
    two, four = ["cuda:0"] * 2, ["cuda:0"] * 4
    out = {}
    # 1, 3, 4: the first steps at dp = 2 and 4 against dp = 1, then the
    # pose burst on the dp = 2 trainer
    ref = _first_bundle(torch, None, ["model.refine_poses=1"])
    tr2, out["dp2_parity"] = _dp_parity(torch, "dp=2", ref, two)
    tr2.refine_poses_step(n_frames=1, n_steps=2)
    tr2.apply_pose_corrections()
    s = tr2.run_steps(1)
    burst_ms = 1e3 * tr2._last_burst_s
    print(f"parallel [dp=2 pose burst]: {burst_ms:.3f} ms, then loss "
          f"{s['total_loss'].tolist()}", flush=True)
    expect(all(math.isfinite(x) for x in s["total_loss"]),
           "dp=2: the step after the pose burst is not finite")
    del tr2
    _, out["dp4_parity"] = _dp_parity(torch, "dp=4", ref, four)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    # 1: 300 steps at dp = 2 on graphs, as shipped
    summary, launches = run_trainer(torch, _dp_sets(two), 300, 1.0 / 300,
                                    device=two)
    print(f"parallel [dp=2 train]: {json.dumps(summary)}; launches "
          f"{launches}", flush=True)
    expect(launches["K1-pc"] == 2 * summary["steps"] and all(
        v == 0 for k, v in launches.items() if k != "K1-pc"),
        f"dp=2 train: launches {launches} in {summary['steps']} steps")
    for a, b in (("loss_last", "loss_first"), ("av_l1_after", "av_l1_before"),
                 ("sdf_mae_after", "sdf_mae_before")):
        expect(summary[a] < summary[b], f"dp=2 train: {b} did not fall")
    out["dp2_train"] = summary
    # 2: the route without the fused op, K2 and K3 per shard
    out["nonfused_first_step"] = _nonfused_first_step(torch, two)
    summary, launches = run_trainer(torch, _dp_sets(two, [NONFUSED]), 200,
                                    1.0 / 300, device=two)
    print(f"parallel [dp=2 K2/K3 train]: {json.dumps(summary)}; launches "
          f"{launches}", flush=True)
    n = summary["steps"]
    expect(launches["K2"] == 2 * n and launches["K3"] == 2 * n and all(
        v == 0 for k, v in launches.items() if k not in ("K2", "K3")),
        f"dp=2 K2/K3 train: launches {launches} in {n} steps")
    for a, b in (("loss_last", "loss_first"), ("av_l1_after", "av_l1_before")):
        expect(summary[a] < summary[b], f"dp=2 K2/K3 train: {b} did not fall")
    out["nonfused_train"] = summary
    out["nonfused_launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    # 5: fleet mode
    for K in (2, 4):
        out[f"fleet_K{K}"] = _fleet(torch, K)
        gc.collect()
        torch.cuda.empty_cache()
    # 6: readings, graph route, profile_step as phase 10 runs it
    out["profile"] = {}
    for label, devices, sets in (("dp=1", None, []), ("dp=2", two, []),
                                 ("dp=4", four, []),
                                 ("dp=2 K2/K3", two, [NONFUSED])):
        r = profile(_dp_sets(devices, sets), warmup=100, steps=100,
                    devices=devices)
        # the four costliest device kernels: (ms a step, calls a step)
        r["top_kernels"] = dict(sorted(r.pop("by_kernel").items(),
                                       key=lambda kv: -kv[1][0])[:4])
        out["profile"][label] = r
        print(f"parallel [{label}] profile: billed "
              f"{r['billed_device_ms']:.4f} ms/step, kernels "
              f"{r['kernels_per_step']:.1f} a step ({r['kernel_ms']:.4f} "
              f"ms), idle {r['idle_share']:.4f} (traced), peak "
              f"{r['peak_memory_gb']:.3f} GB, host wall "
              f"{r['host_ms_bare']:.4f} ms/step; top kernels " + ", ".join(
                  f"{k[:24]} {ms:.4f} ms x {n:.1f}"
                  for k, (ms, n) in r["top_kernels"].items())
              + f"; {card_line()}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {out['phase_s']:.1f} s wall", flush=True)
    expect(out["phase_s"] < 90, f"phase 14: {out['phase_s']:.1f} s wall")
    return out


def main():
    kernels_only = "--kernels-only" in sys.argv[1:]
    graphs_only = "--graphs-only" in sys.argv[1:]
    vis_only = "--vis-only" in sys.argv[1:]
    serve_only = "--serve-only" in sys.argv[1:]
    plots_only = "--plots-only" in sys.argv[1:]
    parallel_only = "--parallel-only" in sys.argv[1:]
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

    from isdf_tpu_torch.models import cuda_query as CQ
    print("occupancy [query_mlp], blocks the card holds: k_query_sdf "
          "{}, k_query_grad {}".format(*CQ._resident(0)), flush=True)
    for lib in ("train_mlp", "train_mlp_f32", "train_mlp_384",
                "reverse_fused", "reverse_fused_f32"):
        occ = occupancy(nvcc.load(lib), lib)
        print(f"occupancy [{lib}], resident blocks per SM: " + ", ".join(
            f"{k} {v}" for k, v in occ.items()), flush=True)
    if graphs_only:
        print(f"graphs: {json.dumps(graph_phase(torch))}", flush=True)
        return
    if vis_only:
        with tempfile.TemporaryDirectory() as work:
            vis_phase(torch, work)
        return
    if serve_only:
        with tempfile.TemporaryDirectory() as work:
            serve_phase(torch, work)
        return
    if plots_only:
        with tempfile.TemporaryDirectory() as work:
            plots_phase(torch, work)
        return
    if parallel_only:
        print(f"parallel: {json.dumps(parallel_phase(torch))}", flush=True)
        return

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
        # the live config's K1-ray-384, once a step
        by_name["K1-ray-384"]["launches"] = \
            readings["data"]["realsense_live"]["steps"]
        # ---- phase 9: multi-scene training, its CLI, slices, the batch
        # runner and the figure readers ----
        t9 = time.perf_counter()
        readings["multi"] = multi_phase(torch, work, rc_cfg)
        readings["multi"]["wall_s"] = time.perf_counter() - t9
    # ---- phase 10: the CUDA-graph route against the eager loop ----
    readings["graphs"] = graph_phase(torch)
    # ---- phase 11: train_vis, the live monitor and the renders ----
    with tempfile.TemporaryDirectory() as work:
        readings["vis"] = vis_phase(torch, work)
    # ---- phase 12: the HTTP viewer, the live controls, captures beside
    # planner threads ----
    with tempfile.TemporaryDirectory() as work:
        readings["serve"] = serve_phase(torch, work)
    # ---- phase 13: the plot kit, the figures and the debug oracles ----
    with tempfile.TemporaryDirectory() as work:
        readings["plots"] = plots_phase(torch, work)
    # ---- phase 14: data parallelism over a ray mesh (K1 per shard; K2
    # and K3 on the trainer's route without the fused op) and fleet mode,
    # on shards of the one card ----
    readings["parallel"] = parallel_phase(torch)
    # K2 and K3 on the main path: the trainer's launches, no longer the op
    # path's
    for name in ("K2", "K3"):
        by_name[name]["launches"] = readings["parallel"][
            "nonfused_launches"][name]
    readings["wall_s"] = time.perf_counter() - t_main
    print(f"phase 9: {readings['multi']['wall_s']:.1f} s wall; phase 10: "
          f"{readings['graphs']['wall_s']:.1f} s; phase 11: "
          f"{readings['vis']['phase_s']:.1f} s; phase 12: "
          f"{readings['serve']['phase_s']:.1f} s; phase 13: "
          f"{readings['plots']['phase_s']:.1f} s; phase 14: "
          f"{readings['parallel']['phase_s']:.1f} s; the script to here: "
          f"{readings['wall_s']:.1f} s wall", flush=True)
    print(f"readings: {json.dumps(readings)}", flush=True)

    # ---- phase 15: report ----
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
