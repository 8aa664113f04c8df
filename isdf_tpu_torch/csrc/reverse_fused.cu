// Reverse-fused SDF MLP for Hopper (sm_90a): value and spatial gradient
// (K2), and their parameter VJP (K3).
//
// Replaces the TPU kernels of isdf_tpu/models/pallas_mlp.py::
// make_pallas_reverse_fused: _make_kernel_f (K2, reached through _call_f)
// and _make_kernel_b (K3, reached through _bwd). The math is
// isdf_tpu/models/fused_vjp.py::make_reverse_fused_mlp, which
// models/fused_vjp.py repeats in eager torch on the port's packed planes:
//
//   K2  h_l = softplus100(h_{l-1} W_l + b_l)   forward, skip-concat at cat
//       raw = h . w_out + b_out               f32
//       v-chain -> vpe = d raw / d pe         bf16 x bf16 -> f32
//       graw[k] = <cb * vpe, T_k>             IEEE f32
//   K3  m0 = [dg dxs | cb * (dg dproj2)]      combined tangent, f32
//       forward values and the tangent chain u_l = t_{l-1} W_l, t_l = u_l sig_l
//       dW_out = h^T draw + t^T 1, db_out = sum draw
//       du = dt sig, dz = dh sig + (dt u) sig', dW_l = a^T dz + ta^T du,
//       db_l = sum dz, the skip layer's pe slice dropped on the way down.
//
// What bounds it on this card. K2 does 14 products of a 256-vector with a
// 256x256 matrix per point (forward 7, v-chain 7), K3 38 (forward 7,
// tangent chain 7, backward chain 10, dW 14): 49.5 and 134 GFLOP of bf16 at
// the trainer's 27,000 points, 0.05 and 0.14 ms at 989 TFLOP/s. Both are
// bound by operations; the streamed pe (27.5 MB) is the largest input.
//
// What the design does about it (a simple kernel that is right first):
//  * K2 is the first half of the fused train op's phase 1 (mlp_tile.cuh):
//    one block per 64-row tile, sig of the six hidden layers stashed in
//    global f32 scratch (6 x 64 x 256 x 4 B = 393 KB per tile does not fit
//    227 KB of shared memory), read back by the v-chain's register
//    epilogues. sig is kept in f32: the products round their operands to
//    bf16 only after the f32 multiply, as the plain version does. The
//    products are the staged mma.sync products of mlp_tile.cuh, two blocks
//    to an SM.
//  * The TPU kernel B accumulates dW and db in outputs resident across a
//    sequential grid. Here K3 runs the train op's three phases: per-tile
//    bf16 operands and f32 partials (k_rf_vjp_tile), split-K dW GEMMs
//    (k_dw), fixed-order sums into the packed planes with exact zeros in
//    every padded row and column (k_reduce). No atomics: two calls give the
//    same bits.
//  * The combined tangent is built per tile from the pe row (cb_at) and the
//    tangent rows Tc, as kernel B does with its lane rolls.
//  * reverse_fused_f32.cu builds this file in the f32-product mode of
//    mlp_tile.cuh (MLP_F32): isdf_tpu's mm_dtype = float32 variant, its
//    hidden products split-bf16 tensor-core products (six terms), one
//    block per SM.

#include "mlp_tile.cuh"

// K2: raw [N] and graw [N, 3] of the points of one 64-row tile.
static __global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
    k_rf_forward(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t = tile_of(smem);
  __shared__ float raw[TM], g0[TM], g1[TM], g2[TM];

  tile_pe_stream(a, t);
  tile_forward(a, t, false, true);
  tile_head(a, t, raw);
  tile_vchain(a, t, false);
  tile_spatial_grad(a, t, g0, g1, g2);
  if (t.tid < TM) {
    const int r = t.r0 + t.tid;
    if (r < a.N) {
      a.raw_out[r] = raw[t.tid];
      a.graw_out[3 * r] = g0[t.tid];
      a.graw_out[3 * r + 1] = g1[t.tid];
      a.graw_out[3 * r + 2] = g2[t.tid];
    }
  }
}

// K3, phase 1: the parameter VJP of one tile from the cotangents of raw
// (draw [N]) and graw (dgraw [N, 3]).
static __global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
    k_rf_vjp_tile(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t = tile_of(smem);
  __shared__ float draw[TM], dg0[TM], dg1[TM], dg2[TM];

  if (t.tid < TM) {
    const int r = t.r0 + t.tid;
    const bool in = r < a.N;
    draw[t.tid] = in ? a.draw_in[r] : 0.f;
    dg0[t.tid] = in ? a.dg_in[3 * r] : 0.f;
    dg1[t.tid] = in ? a.dg_in[3 * r + 1] : 0.f;
    dg2[t.tid] = in ? a.dg_in[3 * r + 2] : 0.f;
  }
  tile_pe_stream(a, t);  // ends with a barrier: the cotangents are visible
  tile_forward(a, t, true, false);
  tile_param_vjp(a, t, draw, dg0, dg1, dg2);
}

static void set_smem_once() {
  static bool attr_set = false;
  if (!attr_set) {
    allow_smem(k_rf_forward, SMEM_DYN);
    allow_smem(k_rf_vjp_tile, SMEM_DYN);
    allow_smem(k_dw, SMEM_DW);
    attr_set = true;
  }
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// out[0] k_rf_forward, out[1] k_rf_vjp_tile, out[2] k_dw. Returns the CUDA
// error code.
extern "C" int isdf_rf_occupancy(int *out) {
  set_smem_once();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k_rf_forward, NTHR,
                                                SMEM_DYN);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k_rf_vjp_tile, NTHR,
                                                SMEM_DYN);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k_dw, NTHR, SMEM_DW);
  return (int)cudaGetLastError();
}

// K2. ptrs, knobs, ints: see args_from (mlp_tile.cuh). Returns the
// cudaGetLastError() code after the launch.
extern "C" int isdf_rf_forward(const long long *ptrs, const float *knobs,
                               const int *ints, void *stream) {
  Args a = args_from(ptrs, knobs, ints);
  set_smem_once();
  k_rf_forward<<<a.NP / TM, NTHR, SMEM_DYN,
                 reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K3: phase 1 (k_rf_vjp_tile), then phases 2 and 3 into dW and db.
extern "C" int isdf_rf_backward(const long long *ptrs, const float *knobs,
                                const int *ints, void *stream) {
  Args a = args_from(ptrs, knobs, ints);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  set_smem_once();
  k_rf_vjp_tile<<<a.NP / TM, NTHR, SMEM_DYN, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_dw_reduce(a, st);
}
