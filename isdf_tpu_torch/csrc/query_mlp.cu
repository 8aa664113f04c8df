// The serve engine's query kernel for Hopper (sm_90a): the SDF values, or
// their spatial gradients, of a chunk of world points in one launch.
//
// It replaces no TPU kernel: isdf_tpu answers a query with one jitted,
// XLA-fused program (isdf_tpu/serve.py:53-70) with no pl.pallas_call
// behind it. The port answered it with the eager models/sdf_mlp.py::apply
// and sdf_and_grad, about a hundred PyTorch kernels a chunk, whose
// elementwise ops (the softplus alone eight of them a layer, each reading
// and writing a [N, 256] f32 tensor, and autograd's backward through each)
// took some 70% of the card's time a request. Here every activation stays
// on chip and only the answer is written.
//
// The math is models/sdf_mlp.py's in float32:
//   xs  = (R x + t) s, xb = (xs D) (x) bands    (D: the 21 directions)
//   pe  = [xs, sin(xb), sin(xb + pi/2)]           (E = 42 nf + 3 lanes)
//   h_l = sp(a_{l-1} W_l + b_l), the skip layer's input a = [h, pe]
//   sp(x) = (max(100x, 0) + log1p(exp(-|100x|))) * 0.01
//   sdf = (h W_out + b_out) * scale_output
// and the gradient by reverse mode: v = w_out, dz_l = v_l * sp'(z_l),
// v_{l-1} = dz_l W_l^T down to d sdf / d pe = dz_0 W_0^T + dz_cat
// W_cat[pe rows]^T, then through the PE's Jacobian (dxs = s R^T on the xs
// lanes, cos(xb [+ pi/2]) * dproj on the others, dproj = s R^T D bands as
// sdf_mlp.py::_pe_consts builds it) to d sdf / d x [N, 3], times
// scale_output.
//
// What bounds it on this card: operations. A point is 7 products of a
// 256-vector with a 256x256 matrix for its value (the skip layer's two
// halves counted apart) and 14 for its gradient: 60.1 and 120.2 GFLOP at
// 65,536 points, 0.90 and 1.80 ms at the f32 FMA rate (66.9 TFLOP/s).
// The products are IEEE f32 FMAs on the SIMT pipes, as the map's f32
// reference states (no TF32, no split bf16). The gradient's stash, sp' of
// every hidden layer but the last (f32, 64 KB a layer a tile) in a per-block
// global scratch, moves about 0.8 GB a 65,536-point call, written once and
// read once: about 0.24 ms at 3.35 TB/s, under the FMAs. On an H100 the
// kernel takes 1.57 ms (values) and 3.24 ms (gradients) a 65,536-point
// call, 57% and 55% of the FMA rate (PERF.md).
//
// The hidden layers' pre-activations are meant to be the eager chain's bit
// for bit. Each is one FMA chain over k in order from zero, the skip
// layer's h rows then its pe rows, with the bias added after, as the f32
// SIMT GEMMs that cuBLAS picked for the eager chain's [65,536, 256]
// products on an H100 (torch 2.11, CUDA 12.8) sum them; the softplus and
// the PE are the eager ops in the eager order, through the same expf,
// log1pf and sinf. That is an agreement with another library's choice of
// algorithm, not a property of this kernel: the card's tests hold the
// pre-activations (k_query_preact) equal to the eager chain's at 65,536
// points, so that a library that sums otherwise fails there first. The
// bits matter at x = 0, where autograd's derivative of the stable form is
// 1 rather than sigmoid(0) = 1/2: a sum that cancels exactly (about one
// point in 65,536 has one) must cancel here too, or that point's gradient
// moves by up to a few percent. So no split-K, no reassociation, and no
// faster exp or log in the forward. The head is not bit for bit: it sums a
// row in four quarters, so a value differs from the eager one by rounding.
//
// Design. One block of 256 threads works on a tile of 64 points at a time,
// persistent over the tiles, two blocks to an SM. The tile's activations
// stay transposed in shared memory, act[k][m] (256 rows, row stride LDA);
// the weights stream through a ring of two 16-row slabs filled by 16-byte
// cp.async copies (the forward products read W [k][n] by rows, the reverse
// ones W^T [n][i], which the wrapper transposes), the next slab in flight
// while the current one is multiplied, one barrier a slab. Each thread owns
// an 8x8 block of the [64, 256] result, rows 4tm.. and 32 + 4tm.., columns
// 4tn.. and 128 + 4tn..: per k two 16-byte loads of act (a warp's four tm
// read 64 contiguous bytes) and two of the slab (its eight tn 128
// contiguous bytes) feed 64 FMAs. A layer's epilogue runs on those
// registers and writes the next layer's input over act after a barrier;
// with LDA = 68 a quarter warp's 16-byte stores fall in distinct banks. The
// skip layer is two passes into the same accumulators, over h and then over
// the pe, which is recomputed into act (act holds 256 rows, not 511). The
// reverse chain recomputes nothing: the forward stashes sp', and the skip
// layer's dz goes to its slot for the last pass, d pe's second half. The
// value's head is summed from act by four threads a row; the gradient's
// Jacobian contraction reduces across a row's 32 threads by shuffles; both
// end in a fixed-order sum over four parts. No atomics: two calls give the
// same bits.
//
// Shared memory: act 69,632 B and the ring 33,280 B dynamic, about 6 KB
// static, so two blocks fit an SM's 228 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define QH 256               // hidden width (the kernel's only one)
#define QTM 64               // points a tile
#define QNT 256              // threads a block
#define QKS 16               // weight rows a slab
#define QNS (QH / QKS)       // slabs a pass
#define LDA 68               // act row stride (floats)
#define LDB 260              // slab row stride (floats)
#define STAGE (QKS * LDB)    // floats a ring stage
#define NDIR 21              // PE directions
#define MAX_NF 6             // frequency bands: E = 42 nf + 3 <= 256
#define SMEM_DYN ((QH * LDA + 2 * STAGE) * 4)
#define HALF_PI 1.5707963267948966f

struct QArgs {
  const float *x;      // [N, 3] world points
  const float *T;      // [4, 4] world -> scene frame
  const float *Wp;     // [L, 2K, 256] packed weights (models/sdf_mlp.py)
  const float *WT;     // gradient: [L, 256, 2K], each layer's plane transposed
  const float *bp;     // [L, 256] packed biases
  const float *D;      // [3, 21] PE directions
  const float *bands;  // [nf] 2^k
  float *out;          // [N] values or [N, 3] gradients
  float *scratch;      // gradient: [grid, L - 1, 256, 64]
  float *zout;         // k_query_preact: [L - 1, N, 256] pre-activations
  int N, L, cat, K, E, nf, F;
  float s_in, s_out;
};

struct QShared {
  float w_out[QH];        // the output layer's weight column
  float red[4][QTM];      // the head's sums, four parts a row
  float red_g[4][QTM][3]; // the gradient's sums, four parts a row
  float xs[QTM][3];       // the tile's scaled points
  float D[3][NDIR];
  float bands[MAX_NF];
  float C[3][NDIR];       // s R^T D
  float dxs[3][3];        // s R^T
  float R[3][3], t[3];
};

// ---- PTX: cp.async ----
__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// a 64 KB stash slot ([256][64] f32) towards L2, two 128-byte lines a thread
__device__ __forceinline__ void prefetch_slot(const float *slot, int tid) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(slot + 64 * tid));
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(slot + 64 * tid + 32));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the thread's block of the [64, 256] result ----
__device__ __forceinline__ int row_of(int tm, int r) {
  return (r < 4 ? 4 * tm : 28 + 4 * tm) + r;
}

__device__ __forceinline__ int col_of(int tn, int c) {
  return (c < 4 ? 4 * tn : 124 + 4 * tn) + c;
}

// v[r] (the thread's 8 rows) into column n of a [256][ld] plane
__device__ __forceinline__ void put_col(float *p, int ld, int tm, int n,
                                        const float (&v)[8]) {
  *reinterpret_cast<float4 *>(p + n * ld + 4 * tm) =
      make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4 *>(p + n * ld + 32 + 4 * tm) =
      make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void get_col(const float *p, int ld, int tm, int n,
                                        float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4 *>(p + n * ld + 4 * tm);
  const float4 b =
      *reinterpret_cast<const float4 *>(p + n * ld + 32 + 4 * tm);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Slab s of a pass's B [256 k][256 n] (row stride ld) into ring stage st,
// then one cp.async group: the forward's B is a layer's W [k][n] from a
// row on, the reverse's its transpose W^T [n][i] from a column on.
__device__ __forceinline__ void issue_slab(float *st, const float *B, int ld,
                                           int s, int tid) {
  const float *src = B + (size_t)QKS * s * ld;
#pragma unroll
  for (int q = 0; q < QKS * QH / 4 / QNT; ++q) {
    const int c = tid + QNT * q;
    const int kk = c >> 6, c4 = (c & 63) * 4;
    cp_async16(st + kk * LDB + c4, src + (size_t)kk * ld + c4);
  }
  cp_async_commit();
}

// acc += act^T [64 x 256] @ B [256 x 256], B streamed slab by slab (the
// caller has issued slab 0 into stage 0). Returns with every copy landed;
// the caller puts a barrier before act is written again.
__device__ __forceinline__ void gemm_pass(float (&acc)[8][8], const float *act,
                                          float *ring, const float *B, int ld,
                                          int tid, int tm, int tn) {
#pragma unroll 1
  for (int s = 0; s < QNS; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slab s landed for all; all done with slab s - 1
    if (s + 1 < QNS) issue_slab(ring + ((s + 1) & 1) * STAGE, B, ld, s + 1, tid);
    const float *A = act + s * QKS * LDA;
    const float *Bs = ring + (s & 1) * STAGE;
#pragma unroll 8
    for (int kk = 0; kk < QKS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4 *>(A + kk * LDA + 4 * tm);
      const float4 a1 =
          *reinterpret_cast<const float4 *>(A + kk * LDA + 32 + 4 * tm);
      const float4 b0 = *reinterpret_cast<const float4 *>(Bs + kk * LDB + 4 * tn);
      const float4 b1 =
          *reinterpret_cast<const float4 *>(Bs + kk * LDB + 128 + 4 * tn);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

__device__ __forceinline__ float proj(const QShared &sh, float x0, float x1,
                                      float x2, int d) {
  return fmaf(x2, sh.D[2][d], fmaf(x1, sh.D[1][d], x0 * sh.D[0][d]));
}

// act rows j0 .. j1 - 1 set to v
__device__ __forceinline__ void tile_fill_rows(float *act, int j0, int j1,
                                               float v, int tid) {
  const int m = tid & (QTM - 1);
  for (int j = j0 + (tid >> 6); j < j1; j += QNT / QTM) act[j * LDA + m] = v;
}

// The PE of the tile's points (p0 ..) into act rows 0 .. E - 1, rows E ..
// 255 zero; rows past N encode the origin. keep_xs: the scaled points into
// sh.xs too, for the gradient's Jacobian.
__device__ __forceinline__ void tile_pe(const QArgs &a, QShared &sh,
                                        float *act, int p0, int tid,
                                        bool keep_xs) {
  const int m = tid & (QTM - 1), g = tid >> 6;
  const int p = p0 + m;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (p < a.N) {
    x0 = a.x[3 * p];
    x1 = a.x[3 * p + 1];
    x2 = a.x[3 * p + 2];
  }
  float xs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xs[i] = (fmaf(x2, sh.R[i][2], fmaf(x1, sh.R[i][1], x0 * sh.R[i][0])) +
             sh.t[i]) * a.s_in;
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      act[i * LDA + m] = xs[i];
      if (keep_xs) sh.xs[m][i] = xs[i];
    }
  }
  for (int f = g; f < a.F; f += QNT / QTM) {
    const int d = f / a.nf, q = f - d * a.nf;
    const float xb = proj(sh, xs[0], xs[1], xs[2], d) * sh.bands[q];
    act[(3 + f) * LDA + m] = sinf(xb);
    act[(3 + a.F + f) * LDA + m] = sinf(xb + HALF_PI);
  }
  tile_fill_rows(act, a.E, QH, 0.f, tid);
}

template <bool GRAD, bool ZOUT>
__device__ __forceinline__ void query_tiles(const QArgs &a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ QShared sh;
  float *act = smem, *ring = smem + QH * LDA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = (warp & 1) * 4 + (lane & 3);
  const int tn = (warp >> 1) * 8 + (lane >> 2);
  const int L = a.L;
  const size_t wstride = (size_t)2 * a.K * QH;
  const float *W_out = a.Wp + (L - 1) * wstride;
  const float b_out = a.bp[(L - 1) * QH];

  // the block's constants
  for (int i = tid; i < 3 * NDIR; i += QNT) sh.D[i / NDIR][i % NDIR] = a.D[i];
  if (tid < a.nf) sh.bands[tid] = a.bands[tid];
  if (tid < 12) {
    const int i = tid >> 2, k = tid & 3;
    if (k < 3) sh.R[i][k] = a.T[4 * i + k];
    else sh.t[i] = a.T[4 * i + 3];
  }
  sh.w_out[tid] = W_out[(size_t)tid * QH];
  __syncthreads();
  if (tid < 3 * NDIR) {
    const int k = tid / NDIR, d = tid % NDIR;
    sh.C[k][d] = a.s_in * fmaf(sh.R[2][k], sh.D[2][d],
                               fmaf(sh.R[1][k], sh.D[1][d],
                                    sh.R[0][k] * sh.D[0][d]));
  }
  if (tid < 9) sh.dxs[tid / 3][tid % 3] = a.s_in * sh.R[tid % 3][tid / 3];
  // (the first pass's barrier publishes them)

  float *stash = GRAD ? a.scratch + (size_t)blockIdx.x * (L - 1) * QH * QTM
                      : nullptr;
  const int n_tiles = (a.N + QTM - 1) / QTM;
  float acc[8][8];
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * QTM;
    issue_slab(ring, a.Wp, QH, 0, tid);
    tile_pe(a, sh, act, p0, tid, GRAD);

    // ---- forward: the hidden layers ----
#pragma unroll 1
    for (int l = 0; l < L - 1; ++l) {
      const float *W = a.Wp + l * wstride;
      zero(acc);
      gemm_pass(acc, act, ring, W, QH, tid, tm, tn);
      if (l == a.cat) {
        issue_slab(ring, W + a.K * QH, QH, 0, tid);
        __syncthreads();
        tile_pe(a, sh, act, p0, tid, false);  // the skip layer's pe rows
        gemm_pass(acc, act, ring, W + a.K * QH, QH, tid, tm, tn);
      }
      const bool last = l == L - 2;
      if (!last)
        issue_slab(ring, W + wstride, QH, 0, tid);
      else if (GRAD)  // the first reverse product
        issue_slab(ring, a.WT + l * wstride, 2 * a.K, 0, tid);
      __syncthreads();
      const float *b = a.bp + l * QH;
      float *slot = GRAD ? stash + (size_t)l * QH * QTM : nullptr;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = col_of(tn, c);
        const float bn = b[n];
        float v[8], sg[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = acc[r][c] + bn;
          if (ZOUT && p0 + row_of(tm, r) < a.N)
            a.zout[((size_t)l * a.N + p0 + row_of(tm, r)) * QH + n] = x;
          const float z = 100.f * x;
          const float e = expf(-fabsf(z));
          const float sp = (fmaxf(z, 0.f) + log1pf(e)) * 0.01f;
          v[r] = sp;
          if (GRAD) {
            // sigmoid(z), and 1 at x = 0: autograd's derivative of the
            // stable form (clamp passes the gradient there, abs's is 0).
            // __fdividef (2 ulp, 1 + e in [1, 2]): IEEE division takes its
            // slow path for quotients below 2^-126, most of them (|z| > 87),
            // and cost 0.45 ms a 65,536-point call on an H100
            sg[r] = x == 0.f ? 1.f : __fdividef(z > 0.f ? 1.f : e, 1.f + e);
            if (last) v[r] = sh.w_out[n] * sg[r];
          }
        }
        put_col(act, LDA, tm, n, v);
        if (GRAD && !last) put_col(slot, QTM, tm, n, sg);
        if (GRAD && last && l == a.cat) put_col(slot, QTM, tm, n, v);
      }
    }

    if (!GRAD) {
      // ---- the head: raw = h . w_out + b_out, a row's four quarters
      // summed by four threads, then in a fixed order ----
      __syncthreads();
      {
        const int m = tid & (QTM - 1), q = tid >> 6;
        float part = 0.f;
        for (int n = 64 * q; n < 64 * q + 64; ++n)
          part = fmaf(act[n * LDA + m], sh.w_out[n], part);
        sh.red[q][m] = part;
      }
      __syncthreads();
      if (tid < QTM && p0 + tid < a.N) {
        const float raw = sh.red[0][tid] + sh.red[1][tid] + sh.red[2][tid] +
                          sh.red[3][tid] + b_out;
        a.out[p0 + tid] = raw * a.s_out;
      }
      continue;
    }

    // ---- reverse: dz_{l-1} = (dz_l W_l^T) * sp'(z_{l-1}) ----
#pragma unroll 1
    for (int l = L - 2; l >= 1; --l) {
      const float *WT = a.WT + l * wstride;
      float *slot = stash + (size_t)(l - 1) * QH * QTM;
      prefetch_slot(slot, tid);
      zero(acc);
      gemm_pass(acc, act, ring, WT, 2 * a.K, tid, tm, tn);
      issue_slab(ring, WT - wstride, 2 * a.K, 0, tid);
      // every load of sp' before any store, so that they overlap
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float sg[8];
        get_col(slot, QTM, tm, col_of(tn, c), sg);
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][c] *= sg[r];
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = col_of(tn, c);
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) v[r] = acc[r][c];
        put_col(act, LDA, tm, n, v);
        if (l - 1 == a.cat) put_col(slot, QTM, tm, n, v);
      }
    }

    // ---- d sdf / d pe = dz_0 W_0^T + dz_cat W_cat[K:]^T ----
    const float *slot = stash + (size_t)a.cat * QH * QTM;
    prefetch_slot(slot, tid);
    zero(acc);
    gemm_pass(acc, act, ring, a.WT, 2 * a.K, tid, tm, tn);
    const float *WT_pe = a.WT + a.cat * wstride + a.K;  // the pe columns
    issue_slab(ring, WT_pe, 2 * a.K, 0, tid);
    __syncthreads();
    // dz_cat into act by cp.async; the pass's first wait and barrier
    // publish it
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = col_of(tn, c);
      cp_async16(act + n * LDA + 4 * tm, slot + n * QTM + 4 * tm);
      cp_async16(act + n * LDA + 32 + 4 * tm, slot + n * QTM + 32 + 4 * tm);
    }
    cp_async_commit();
    gemm_pass(acc, act, ring, WT_pe, 2 * a.K, tid, tm, tn);

    // ---- the PE's Jacobian: g[m][k] = sum_j vpe[m][j] dpe_j / dx_k ----
    float g[8][3];
#pragma unroll
    for (int r = 0; r < 8; ++r) g[r][0] = g[r][1] = g[r][2] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = col_of(tn, c);
      if (j < 3) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            g[r][k] = fmaf(acc[r][c], sh.dxs[k][j], g[r][k]);
      } else if (j < a.E) {
        const bool cos_lane = j >= 3 + a.F;
        const int f = j - 3 - (cos_lane ? a.F : 0);
        const int d = f / a.nf, q = f - d * a.nf;
        const float bq = sh.bands[q];
        const float dp0 = sh.C[0][d] * bq, dp1 = sh.C[1][d] * bq,
                    dp2 = sh.C[2][d] * bq;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int m = row_of(tm, r);
          const float xb = proj(sh, sh.xs[m][0], sh.xs[m][1], sh.xs[m][2], d) * bq;
          const float w = acc[r][c] * cosf(cos_lane ? xb + HALF_PI : xb);
          g[r][0] = fmaf(w, dp0, g[r][0]);
          g[r][1] = fmaf(w, dp1, g[r][1]);
          g[r][2] = fmaf(w, dp2, g[r][2]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g[r][k] += __shfl_xor_sync(0xffffffffu, g[r][k], 4);
        g[r][k] += __shfl_xor_sync(0xffffffffu, g[r][k], 8);
        g[r][k] += __shfl_xor_sync(0xffffffffu, g[r][k], 16);
      }
    if ((lane >> 2) == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) sh.red_g[warp >> 1][row_of(tm, r)][k] = g[r][k];
    }
    __syncthreads();
    if (tid < 3 * QTM) {
      const int m = tid / 3, k = tid - 3 * m;
      if (p0 + m < a.N)
        a.out[3 * p0 + tid] = (sh.red_g[0][m][k] + sh.red_g[1][m][k] +
                               sh.red_g[2][m][k] + sh.red_g[3][m][k]) *
                              a.s_out;
    }
  }
}

static __global__ void __launch_bounds__(QNT, 2) k_query_sdf(QArgs a) {
  query_tiles<false, false>(a);
}

static __global__ void __launch_bounds__(QNT, 2) k_query_grad(QArgs a) {
  query_tiles<true, false>(a);
}

// k_query_sdf that also writes each hidden layer's pre-activations, for the
// tests
static __global__ void __launch_bounds__(QNT, 2) k_query_preact(QArgs a) {
  query_tiles<false, true>(a);
}

static bool first_on_device(unsigned long long *seen) {
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (*seen & bit) return false;
  *seen |= bit;
  return true;
}

static void set_smem_once() {
  static unsigned long long attr_set = 0;
  if (first_on_device(&attr_set)) {
    cudaFuncSetAttribute(k_query_sdf,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    cudaFuncSetAttribute(k_query_grad,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    cudaFuncSetAttribute(k_query_preact,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    cudaFuncSetAttribute(k_query_sdf,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(k_query_grad,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(k_query_preact,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  }
}

// ptrs: x, T, Wp, bp, D, bands, out, scratch, WT, zout; knobs: scale_input,
// scale_output; ints: N, L, cat, K, E, nf, grid.
static QArgs args_from(const long long *p, const float *k, const int *n) {
  QArgs a;
  a.x = reinterpret_cast<const float *>(p[0]);
  a.T = reinterpret_cast<const float *>(p[1]);
  a.Wp = reinterpret_cast<const float *>(p[2]);
  a.bp = reinterpret_cast<const float *>(p[3]);
  a.D = reinterpret_cast<const float *>(p[4]);
  a.bands = reinterpret_cast<const float *>(p[5]);
  a.out = reinterpret_cast<float *>(p[6]);
  a.scratch = reinterpret_cast<float *>(p[7]);
  a.WT = reinterpret_cast<const float *>(p[8]);
  a.zout = reinterpret_cast<float *>(p[9]);
  a.s_in = k[0];
  a.s_out = k[1];
  a.N = n[0];
  a.L = n[1];
  a.cat = n[2];
  a.K = n[3];
  a.E = n[4];
  a.nf = n[5];
  a.F = NDIR * a.nf;
  return a;
}

// Resident blocks per SM of k_query_sdf (out[0]) and k_query_grad (out[1])
// and the card's SMs (out[2]). Returns the CUDA error code.
extern "C" int isdf_query_occupancy(int *out) {
  set_smem_once();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k_query_sdf, QNT,
                                                SMEM_DYN);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k_query_grad, QNT,
                                                SMEM_DYN);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  return (int)cudaGetLastError();
}

static int launch(int mode, const long long *ptrs, const float *knobs,
                  const int *ints, void *stream) {
  const QArgs a = args_from(ptrs, knobs, ints);
  set_smem_once();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mode == 1)
    k_query_grad<<<ints[6], QNT, SMEM_DYN, st>>>(a);
  else if (mode == 2)
    k_query_preact<<<ints[6], QNT, SMEM_DYN, st>>>(a);
  else
    k_query_sdf<<<ints[6], QNT, SMEM_DYN, st>>>(a);
  return (int)cudaGetLastError();
}

// SDF values [N]. Returns the cudaGetLastError() code after the launch.
extern "C" int isdf_query_sdf(const long long *ptrs, const float *knobs,
                              const int *ints, void *stream) {
  return launch(0, ptrs, knobs, ints, stream);
}

// Spatial gradients [N, 3]; scratch holds grid * (L - 1) * 256 * 64 floats,
// WT each layer's [2K, 256] plane transposed.
extern "C" int isdf_query_grad(const long long *ptrs, const float *knobs,
                               const int *ints, void *stream) {
  return launch(1, ptrs, knobs, ints, stream);
}

// SDF values [N] and the hidden pre-activations into zout [L - 1, N, 256].
extern "C" int isdf_query_preact(const long long *ptrs, const float *knobs,
                                 const int *ints, void *stream) {
  return launch(2, ptrs, knobs, ints, stream);
}
