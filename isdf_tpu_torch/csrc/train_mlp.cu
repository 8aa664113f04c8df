// Fused SDF-MLP train op for Hopper (sm_90a): loss AND parameter gradients.
//
// Replaces the TPU kernel isdf_tpu/models/pallas_mlp.py::_make_kernel_train
// in its three variants, one template mode each:
//   MODE_PC     op_pc_bounds (:726): PE and batch-distance bounds in the
//               kernel, from world xyz and the surface set;
//   MODE_RAY    op_pe_in_kernel (:685): PE built in the kernel, bounds and
//               gradient targets given as columns;
//   MODE_STREAM op (:782): the PE streamed from a [N, E] f32 plane
//               (sdf_mlp._pe_factored), bounds and targets as columns.
// The math is the hand-derived one of the TPU kernel, which
// models/cuda_mlp.py::train_op_plain repeats in eager torch:
//
//   pe   = [xs | sin(xb) | cos(xb)]          from xyz (IEEE f32) or streamed
//   (pc) nearest valid surface point          f32 scores, first-index argmin
//   h_l  = softplus100(h_{l-1} W_l + b_l)     bf16 x bf16 -> f32, skip-concat
//   v-chain -> d sdf/dx, per-point loss, hand loss backward -> (draw, dg)
//   m0 = combined tangent, u_l = t_{l-1} W_l, t_l = u_l sig_l
//   dz_l = dh sig + dt u sig', du_l = dt sig  (backward chain)
//   dW_l = a^T dz + ta^T du,  db_l = sum dz
//
// What bounds it on this card. Per point the op does ~45 products of a
// 256-vector with a 256x256 matrix (~5.9 MFLOP), so at the trainer's
// 27,000 points a step is ~160 GFLOP: 0.16 ms at the 989 TFLOP/s dense
// bf16 peak. Its inputs and outputs are a few MB (the streamed pe 27.5 MB).
// The three-phase design below adds its stash: sig and u of every hidden
// layer in f32, the bf16 dW operands and the split-K partials, ~1.9 GB a
// call at 27,000 points, 0.57 ms at 3.35 TB/s (chip_smoke.py,
// stash_bytes). That, not the tensor-core rate, is this design's floor.
//
// What the design does about it:
//  * The TPU grid is sequential and accumulates dW in resident outputs.
//    Here phase 1 (k_train_tile) runs one block per 64-row tile, all in
//    parallel; it writes the bf16 operands of the dW products (a, ta, dz,
//    du per layer) to global scratch, and per-tile f32 partials of the bias
//    gradients, the output-layer gradient and the five loss sums.
//    Phase 2 (k_dw) forms dW_l = [a; ta]^T [dz; du] as split-K GEMMs over
//    all rows, one partial per split, on 128x128 tiles fed through a
//    cp.async ring in shared memory. Phase 3 (k_reduce) sums the partials
//    in a fixed order. No atomics: the result is the same on every run.
//  * Phase 1's products are mma.sync on weights staged in shared memory by
//    cp.async, k-slab by k-slab, and their epilogues run on the
//    accumulator registers (mlp_tile.cuh). Without f32 accumulator tiles
//    a block takes 113 KB of shared memory, so two blocks share an SM and
//    one block's epilogue (the stash loads and stores) runs under the
//    other's products. An epilogue issues the stash loads of a whole
//    m-tile of its fragments at once, a per-row pass those of eight rows,
//    and the next product's first weight slab is in flight during the
//    epilogue before it.
//  * The PE, the pc scores, the tangent contractions and the output head
//    stay IEEE f32 on the CUDA cores (the pc score rows staged in shared
//    memory through the ring, idle before the first product); the PE and
//    score sums are written
//    with __fmul_rn/__fadd_rn so they round exactly as the eager torch
//    version does, which keeps both on the same argmin.
//  * The streamed mode derives cb = [1,1,1 | cos | -sin | 0] from the pe
//    row by index arithmetic (cb_at), as _cb_from_pe does with lane rolls.
//  * Next: wgmma fed by TMA rings on the staged operands, aimed at the
//    stash floor.
//
// The per-tile stages and phases 2-3 live in mlp_tile.cuh, shared with the
// reverse-fused op (reverse_fused.cu). train_mlp_f32.cu builds this file
// in the f32-product mode of mlp_tile.cuh (MLP_F32), isdf_tpu's
// mm_dtype = float32 variant of the same kernel; train_mlp_384.cu builds
// it for a PE of 384 lanes (MLP_LANES), two blocks an SM as at 256.

#include "mlp_tile.cuh"

enum { MODE_PC = 0, MODE_RAY = 1, MODE_STREAM = 2 };

// Lane j of the tile's PE from its points (px, py, pz) into pe32, peb and,
// with to_tile (lanes j < 256), X and X2.
static __device__ __forceinline__ void pe_lane(const Args &a, const Tile &t,
                                               const float *px,
                                               const float *py,
                                               const float *pz, int j,
                                               bool to_tile) {
  const int E = a.E, F = (E - 3) / 2;
  const float m0 = a.Mc[j], m1 = a.Mc[LANES + j], m2 = a.Mc[2 * LANES + j],
              m3 = a.Mc[3 * LANES + j];
  const bool cos_lane = (j >= 3 + F) && (j < E);
  for (int r = 0; r < TM; r++) {
    float pre = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px[r], m0), __fmul_rn(py[r], m1)),
                  __fmul_rn(pz[r], m2)),
        m3);
    float pe = j < 3 ? pre
                     : (j < E ? sinf(__fadd_rn(pre, cos_lane ? HALF_PI : 0.f))
                              : 0.f);
    size_t o = (size_t)(t.r0 + r) * LANES + j;
    a.pe32[o] = pe;
    const op_t pb = to_op(pe);
    a.peb[o] = pb;
    if (to_tile) {
      t.X[r * LDX + j] = pb;
      t.X2[r * LDX + j] = pb;
    }
  }
}

// Phase 1: one block per 64-row tile.
template <int MODE>
static __global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
    k_train_tile(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t = tile_of(smem);
  op_t *X = t.X, *X2 = t.X2;

  __shared__ float px[TM], py[TM], pz[TM], bcol[TM], gt0[TM], gt1[TM],
      gt2[TM], vcol[TM], nz[TM], raw[TM], g0[TM], g1[TM], g2[TM], draw[TM],
      dg0[TM], dg1[TM], dg2[TM], ctb[5][TM];

  const int tid = t.tid, tile = t.tile, r0 = t.r0;
  const int E = a.E, F = (E - 3) / 2;
  const int j = tid;  // the column this thread owns in elementwise passes

  // ---- per-row inputs ----
  if (tid < TM) {
    int r = r0 + tid;
    bool in = r < a.N;
    if (MODE != MODE_STREAM) {
      px[tid] = in ? a.pts[3 * r] : 0.f;
      py[tid] = in ? a.pts[3 * r + 1] : 0.f;
      pz[tid] = in ? a.pts[3 * r + 2] : 0.f;
    }
    vcol[tid] = in ? a.valid[r] : 0.f;
    nz[tid] = in ? a.noise[r] : 0.f;
    if (MODE != MODE_PC) {
      bcol[tid] = in ? a.col_a[r] : 0.f;
      gt0[tid] = in ? a.vec3[3 * r] : 0.f;
      gt1[tid] = in ? a.vec3[3 * r + 1] : 0.f;
      gt2[tid] = in ? a.vec3[3 * r + 2] : 0.f;
    }
  }
  __syncthreads();

  if (MODE == MODE_STREAM) {
    tile_pe_stream(a, t);
  } else {
    // ---- positional encoding (IEEE f32, rounding as the eager version) ----
    pe_lane(a, t, px, py, pz, j, true);
#if LANES > HID
    if (j < LANES - NTHR) pe_lane(a, t, px, py, pz, j + NTHR, false);
#endif
  }

  // ---- batch-distance bounds: nearest valid surface point ----
  if (MODE == MODE_PC) {
    const int rr = tid >> 2, sub = tid & 3;
    const float x = px[rr], y = py[rr], z = pz[rr];
    float best = __int_as_float(0x7f800000);
    int bi = 0x7fffffff;
    // the score rows staged through the ring (idle until the forward
    // products) in chunks of SP_CHUNK surface points, one float4 each; a
    // chunk is a multiple of 4, so each thread still scans its indices in
    // increasing order
    float4 *spq = reinterpret_cast<float4 *>(t.ring);
    const int SP_CHUNK = RING_BYTES / 16;
    for (int c0 = 0; c0 < a.R; c0 += SP_CHUNK) {
      const int n = min(SP_CHUNK, a.R - c0);
      __syncthreads();
      for (int s = tid; s < n; s += NTHR)
        spq[s] = make_float4(a.sp[c0 + s], a.sp[a.R + c0 + s],
                             a.sp[2 * a.R + c0 + s], a.sp[3 * a.R + c0 + s]);
      __syncthreads();
      for (int s = sub; s < n; s += 4) {
        const float4 q = spq[s];
        float sc = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(x, q.x), __fmul_rn(y, q.y)),
                      __fmul_rn(z, q.z)),
            q.w);
        if (sc < best) { best = sc; bi = c0 + s; }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      float ob = __shfl_xor_sync(0xffffffffu, best, off);
      int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (sub == 0) {
      int r = r0 + rr;
      bool in = r < a.N;
      if (bi >= a.R) bi = 0;  // no finite score: first index, like argmin
      float dx = x - a.surf[3 * bi], dy = y - a.surf[3 * bi + 1],
            dz = z - a.surf[3 * bi + 2];
      float d = sqrtf(dx * dx + dy * dy + dz * dz);
      float zd = in ? a.col_a[r] : 0.f;
      float sg = zd > 0.f ? -1.f : 1.f;
      bcol[rr] = sg * d;
      bool live = (d > 1e-12f) && ((in ? a.is_surf[r] : 0.f) < 0.5f);
      float dd = fmaxf(d, 1e-12f);
      gt0[rr] = live ? (dx * sg) / dd : (in ? a.vec3[3 * r] : 0.f);
      gt1[rr] = live ? (dy * sg) / dd : (in ? a.vec3[3 * r + 1] : 0.f);
      gt2[rr] = live ? (dz * sg) / dd : (in ? a.vec3[3 * r + 2] : 0.f);
    }
  }
  __syncthreads();

  // ---- forward values, output head, v-chain, spatial gradient ----
  tile_forward(a, t, true, true);
  tile_head(a, t, raw);
  tile_vchain(a, t, true);
  tile_spatial_grad(a, t, g0, g1, g2);

  // ---- per-point loss and its hand-derived backward ----
  if (tid < TM) {
    const int r = tid;
    const float so = a.so, v = vcol[r], bc = bcol[r];
    const float gs[3] = {g0[r] * so, g1[r] * so, g2[r] * so};
    const float gt[3] = {gt0[r], gt1[r], gt2[r]};
    const float sdf = (raw[r] + nz[r]) * so;
    const bool fs = bc > a.trunc_d;
    const float a_ = fmaxf(sdf - bc, 0.f);
    const float c_ = expf(-a.fsf * sdf) - 1.f;
    const float f_ = fmaxf(a_, c_);
    const float da = sdf > bc ? 1.f : 0.f;
    const float dc = -a.fsf * expf(-a.fsf * sdf);
    const float df = a_ > c_ ? da : (c_ > a_ ? dc : 0.5f * (da + dc));
    const float mt = sdf - bc;
    float matf, dmatf, matt, dmatt;
    if (a.l1) { matf = f_; dmatf = df; matt = fabsf(mt); dmatt = sgnf(mt); }
    else { matf = f_ * f_; dmatf = 2.f * f_ * df; matt = mt * mt; dmatt = 2.f * mt; }
    const float sdf_mat = fs ? matf : matt * a.tw;
    const float dsdf_mat = fs ? dmatf : dmatt * a.tw;
    float total = sdf_mat, s_grad = 0.f, s_eik = 0.f;
    float dg[3] = {0.f, 0.f, 0.f};
    const float eps = 1e-6f;
    const float gnorm = sqrtf(gs[0] * gs[0] + gs[1] * gs[1] + gs[2] * gs[2]);
    if (a.gw != 0.f) {
      float gtn = sqrtf(gt[0] * gt[0] + gt[1] * gt[1] + gt[2] * gt[2]);
      float na = fmaxf(gtn, eps), nb = fmaxf(gnorm, eps);
      float dotg = gt[0] * gs[0] + gt[1] * gs[1] + gt[2] * gs[2];
      float gmat = 1.f - dotg / (na * nb);
      if (a.orien) {
        gmat = gmat > 1.f ? 1.f : 0.f;
      } else {
        float live = gnorm > eps ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < 3; k++)
          dg[k] += a.gw * -(gt[k] / (na * nb) -
                            dotg * gs[k] * live /
                                (na * nb * nb * fmaxf(gnorm, 1e-12f)));
      }
      total += a.gw * gmat;
      s_grad = gmat * v;
    }
    if (a.ew != 0.f) {
      float emat = fabsf(gnorm - 1.f);
      float gate = bc >= a.ead ? 1.f : 0.f;
      float eikw = emat * (gate * a.ew);
#pragma unroll
      for (int k = 0; k < 3; k++)
        dg[k] += a.ew * gate * sgnf(gnorm - 1.f) * gs[k] / fmaxf(gnorm, 1e-12f);
      total += eikw;
      s_eik = eikw * v;
    }
    total *= v;
    ctb[0][r] = total;
    ctb[1][r] = sdf_mat * v;
    ctb[2][r] = s_grad;
    ctb[3][r] = s_eik;
    ctb[4][r] = v;
    if (r0 + r < a.N) a.ploss[r0 + r] = total;
    const float w_pt = v * a.inv_count[0];
    draw[r] = w_pt * dsdf_mat * so;
    dg0[r] = dg[0] * so * w_pt;
    dg1[r] = dg[1] * so * w_pt;
    dg2[r] = dg[2] * so * w_pt;
  }
  __syncthreads();
  if (tid < 5) {
    float s = 0.f;
    for (int r = 0; r < TM; r++) s += ctb[tid][r];
    a.part_scal[tile * 8 + tid] = s;
  }

  // ---- parameter VJP of the tile ----
  tile_param_vjp(a, t, draw, dg0, dg1, dg2);
}

static void set_attrs_once() {
  static unsigned long long attr_set = 0;
  if (first_on_device(&attr_set)) {
    allow_smem(k_train_tile<MODE_PC>, SMEM_DYN);
    allow_smem(k_train_tile<MODE_RAY>, SMEM_DYN);
    allow_smem(k_train_tile<MODE_STREAM>, SMEM_DYN);
    allow_smem(k_dw, SMEM_DW);
  }
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// out[0..2] k_train_tile in modes pc, ray, stream; out[3] k_dw. Returns
// the CUDA error code.
extern "C" int isdf_train_mlp_occupancy(int *out) {
  set_attrs_once();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k_train_tile<MODE_PC>,
                                                NTHR, SMEM_DYN);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k_train_tile<MODE_RAY>,
                                                NTHR, SMEM_DYN);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], k_train_tile<MODE_STREAM>, NTHR, SMEM_DYN);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], k_dw, NTHR, SMEM_DW);
  return (int)cudaGetLastError();
}

// ptrs, knobs, ints: see args_from (mlp_tile.cuh); ints[10] is the mode
// (0 pc, 1 ray, 2 stream). Returns the cudaGetLastError() code after the
// launches.
extern "C" int isdf_train_mlp(const long long *ptrs, const float *knobs,
                              const int *ints, void *stream) {
  Args a = args_from(ptrs, knobs, ints);
  const int mode = ints[10];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  set_attrs_once();
  const int n_tiles = a.NP / TM;
  if (mode == MODE_PC) k_train_tile<MODE_PC><<<n_tiles, NTHR, SMEM_DYN, st>>>(a);
  else if (mode == MODE_RAY) k_train_tile<MODE_RAY><<<n_tiles, NTHR, SMEM_DYN, st>>>(a);
  else if (mode == MODE_STREAM) k_train_tile<MODE_STREAM><<<n_tiles, NTHR, SMEM_DYN, st>>>(a);
  else return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_dw_reduce(a, st);
}
