// Shared pieces of the SDF-MLP kernels for Hopper (sm_90a): the argument
// block, the bf16 wmma tile products, and the per-tile stages that the
// fused train op (train_mlp.cu, K1) and the reverse-fused op
// (reverse_fused.cu, K2 and K3) run in the same way:
//
//   tile_pe_stream   pe tile read from a streamed [N, E] f32 plane
//   tile_forward     h_l = softplus100(h_{l-1} W_l + b_l), skip-concat,
//                    sig_l stashed in global f32 scratch
//   tile_head        raw = h . w_out + b_out (f32)
//   tile_vchain      reverse v-chain -> d raw / d pe
//   tile_spatial_grad  g[k] = <cb * vpe, T_k> (IEEE f32)
//   tile_param_vjp   combined tangent m0, tangent chain, output-layer
//                    partials, backward chain -> bf16 dW operands
//   k_dw, k_reduce   phases 2 and 3: split-K dW GEMMs, fixed-order sums
//
// A tile is 64 rows, one block of 256 threads; thread j owns column j in
// the elementwise passes. Shared memory holds two bf16 [64,256] operand
// tiles (X, X2) and two f32 [64,256] accumulator tiles (OUT, OUT2):
// 196 KB of dynamic shared memory. Per-layer sig and u live in global f32
// scratch, read back once and coalesced. No atomics anywhere: every
// result is the same on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define HID 256
#define CATW 512
#define TM 64
#define NTHR 256
#define LDX 264  // bf16 shared tile row stride (elements)
#define LDO 260  // f32 shared tile row stride (elements)
#define HALF_PI 1.57079637050628662109375f  // float32(pi / 2)

struct Args {
  // per-point inputs
  const float *pts, *valid, *noise, *col_a, *vec3, *is_surf;
  // pc surface set: sp [4, R] (rows 0..2 = -2 s, row 3 = |s|^2 + penalty),
  // surf [R, 3]
  const float *sp, *surf;
  // constants: Mc [4, 256] PE plane, Tc [3, 256] tangent rows,
  // b [L, 256] biases (b[L-1][0] = output bias), w_out [256], inv_count [1]
  const float *Mc, *Tc, *b, *w_out, *inv_count;
  const bf16 *W;  // [L, 512, 256]
  // outputs
  float *ploss, *sums, *dW, *db;
  // scratch
  float *pe32, *sig, *u, *h5, *t5;
  bf16 *peb, *m0b, *hb, *tb, *dzb, *dub;
  float *part_scal, *part_db, *part_dwout, *part_dw;
  // streamed pe [N, E]; reverse-fused outputs raw [N], graw [N, 3] and
  // cotangents draw [N], dgraw [N, 3]
  const float *pe_in;
  float *raw_out, *graw_out;
  const float *draw_in, *dg_in;
  // loss knobs
  float so, trunc_d, tw, gw, ew, ead, fsf;
  // sizes and flags
  int N, NP, R, L, cat, E, l1, orien, S, rps;
};

#define N_PTRS 38
static_assert(offsetof(Args, so) == N_PTRS * sizeof(void *),
              "Args must start with N_PTRS pointers");

// ptrs: the pointer fields of Args in declaration order; knobs: so,
// trunc_d, tw, gw, ew, ead, fsf; ints: N, NP, R, L, cat, E, l1, orien, S,
// rps (then entry-specific flags).
static inline Args args_from(const long long *ptrs, const float *knobs,
                             const int *ints) {
  Args a;
  memcpy(&a, ptrs, N_PTRS * sizeof(void *));
  a.so = knobs[0]; a.trunc_d = knobs[1]; a.tw = knobs[2]; a.gw = knobs[3];
  a.ew = knobs[4]; a.ead = knobs[5]; a.fsf = knobs[6];
  a.N = ints[0]; a.NP = ints[1]; a.R = ints[2]; a.L = ints[3];
  a.cat = ints[4]; a.E = ints[5]; a.l1 = ints[6]; a.orien = ints[7];
  a.S = ints[8]; a.rps = ints[9];
  return a;
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

static const int SMEM_DYN = 2 * TM * LDX * (int)sizeof(bf16) +
                            2 * TM * LDO * (int)sizeof(float);

__device__ __forceinline__ void sig_sp(float z, float &sig, float &h) {
  float x = 100.f * z;
  float e = expf(-fabsf(x));
  float inv = 1.f / (1.f + e);
  sig = x >= 0.f ? inv : e * inv;
  h = (fmaxf(x, 0.f) + log1pf(e)) * 0.01f;
}

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ void acc_zero(Acc (&acc)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 2; j++) wmma::fill_fragment(acc[i][j], 0.f);
}

// acc[64 x 32 slice of warp] += X[64, 256] @ B, B = Wl[256, 256] (row-major,
// row stride 256) or, with TRANS, Wl^T.
template <bool TRANS>
__device__ __forceinline__ void mm(Acc (&acc)[4][2], const bf16 *X,
                                   const bf16 *Wl, int warp) {
  const int n0 = warp * 32;
  for (int k0 = 0; k0 < HID; k0 += 16) {
    FragA a[4];
#pragma unroll
    for (int i = 0; i < 4; i++)
      wmma::load_matrix_sync(a[i], X + (16 * i) * LDX + k0, LDX);
    if (TRANS) {
      FragBc bf[2];
#pragma unroll
      for (int j = 0; j < 2; j++)
        wmma::load_matrix_sync(bf[j], Wl + (size_t)(n0 + 16 * j) * HID + k0,
                               HID);
#pragma unroll
      for (int i = 0; i < 4; i++)
#pragma unroll
        for (int j = 0; j < 2; j++)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    } else {
      FragBr bf[2];
#pragma unroll
      for (int j = 0; j < 2; j++)
        wmma::load_matrix_sync(bf[j], Wl + (size_t)k0 * HID + n0 + 16 * j,
                               HID);
#pragma unroll
      for (int i = 0; i < 4; i++)
#pragma unroll
        for (int j = 0; j < 2; j++)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void acc_store(Acc (&acc)[4][2], float *O,
                                          int warp) {
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 2; j++)
      wmma::store_matrix_sync(O + (16 * i) * LDO + warp * 32 + 16 * j,
                              acc[i][j], LDO, wmma::mem_row_major);
}

// cb[j]: the point-dependent factor of the PE Jacobian, from the f32 pe row
// pe = [xs | sin(xb) | cos(xb)]: cb = [1,1,1 | cos(xb) | -sin(xb) | 0].
__device__ __forceinline__ float cb_at(const float *pe_row, int j, int E,
                                       int F) {
  if (j < 3) return 1.f;
  if (j < 3 + F) return pe_row[j + F];
  if (j < E) return -pe_row[j - F];
  return 0.f;
}

// The block's shared tiles and coordinates.
struct Tile {
  bf16 *X, *X2;
  float *OUT, *OUT2;
  int tid, warp, lane, tile, r0;
};

__device__ __forceinline__ Tile tile_of(unsigned char *smem) {
  Tile t;
  t.X = reinterpret_cast<bf16 *>(smem);
  t.X2 = t.X + TM * LDX;
  t.OUT = reinterpret_cast<float *>(t.X2 + TM * LDX);
  t.OUT2 = t.OUT + TM * LDO;
  t.tid = threadIdx.x;
  t.warp = t.tid >> 5;
  t.lane = t.tid & 31;
  t.tile = blockIdx.x;
  t.r0 = t.tile * TM;
  return t;
}

// pe tile from the streamed plane pe_in [N, E] (zero past row N and column
// E) into pe32 (f32 scratch), peb (bf16 dW operand, when given), X and X2.
__device__ __forceinline__ void tile_pe_stream(const Args &a, const Tile &t) {
  const int j = t.tid;
  for (int r = 0; r < TM; r++) {
    const int row = t.r0 + r;
    const float pe =
        (row < a.N && j < a.E) ? a.pe_in[(size_t)row * a.E + j] : 0.f;
    const size_t o = (size_t)row * HID + j;
    a.pe32[o] = pe;
    const bf16 pb = __float2bfloat16(pe);
    if (a.peb) a.peb[o] = pb;
    t.X[r * LDX + j] = pb;
    t.X2[r * LDX + j] = pb;
  }
  __syncthreads();
}

// Forward values. X and X2 hold the bf16 pe tile. Stashes sig per layer;
// with keep, also the bf16 inputs of layers 1.. (hb) and the last h in f32
// (h5) for the parameter VJP. Leaves the last h (f32) in OUT.
__device__ __forceinline__ void tile_forward(const Args &a, const Tile &t,
                                             bool keep) {
  const int nh = a.L - 1, j = t.tid;
  const size_t plane = (size_t)a.NP * HID;
  const size_t wl = (size_t)CATW * HID;
  Acc acc[4][2];
  for (int l = 0; l < nh; l++) {
    const bf16 *Wl = a.W + l * wl;
    acc_zero(acc);
    mm<false>(acc, t.X, Wl, t.warp);
    if (l == a.cat) mm<false>(acc, t.X2, Wl + HID * HID, t.warp);
    acc_store(acc, t.OUT, t.warp);
    __syncthreads();
    const float bj = a.b[l * HID + j];
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(t.r0 + r) * HID + j;
      float s, h;
      sig_sp(t.OUT[r * LDO + j] + bj, s, h);
      a.sig[l * plane + o] = s;
      t.X[r * LDX + j] = __float2bfloat16(h);
      if (l < nh - 1) {
        if (keep) a.hb[l * plane + o] = __float2bfloat16(h);
      } else {
        if (keep) a.h5[o] = h;
        t.OUT[r * LDO + j] = h;
      }
    }
    __syncthreads();
  }
}

// raw[r] = h . w_out + b_out (f32), h the last hidden row in OUT.
__device__ __forceinline__ void tile_head(const Args &a, const Tile &t,
                                          float *raw) {
  const int nh = a.L - 1;
  const float bout = a.b[nh * HID];
  for (int q = 0; q < TM / 8; q++) {
    int r = t.warp * (TM / 8) + q;
    float s = 0.f;
    for (int k = t.lane; k < HID; k += 32) s += t.OUT[r * LDO + k] * a.w_out[k];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (t.lane == 0) raw[r] = s + bout;
  }
  __syncthreads();
}

// Reverse v-chain: leaves vpe = d raw / d pe (f32) in OUT. The skip layer's
// pe rows add their term to the layer-0 product through X2.
__device__ __forceinline__ void tile_vchain(const Args &a, const Tile &t) {
  const int nh = a.L - 1, j = t.tid;
  const size_t plane = (size_t)a.NP * HID;
  const size_t wl = (size_t)CATW * HID;
  {
    const float wj = a.w_out[j];
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(t.r0 + r) * HID + j;
      bf16 vs = __float2bfloat16(wj * a.sig[(nh - 1) * plane + o]);
      t.X[r * LDX + j] = vs;
      if (nh - 1 == a.cat) t.X2[r * LDX + j] = vs;
    }
  }
  __syncthreads();
  Acc acc[4][2];
  for (int l = nh - 1; l >= 0; l--) {
    acc_zero(acc);
    mm<true>(acc, t.X, a.W + l * wl, t.warp);
    if (l == 0 && a.cat < nh)
      mm<true>(acc, t.X2, a.W + a.cat * wl + HID * HID, t.warp);
    __syncthreads();
    acc_store(acc, t.OUT, t.warp);
    __syncthreads();
    if (l > 0) {
      for (int r = 0; r < TM; r++) {
        size_t o = (size_t)(t.r0 + r) * HID + j;
        bf16 vs = __float2bfloat16(t.OUT[r * LDO + j] * a.sig[(l - 1) * plane + o]);
        t.X[r * LDX + j] = vs;
        if (l - 1 == a.cat) t.X2[r * LDX + j] = vs;
      }
      __syncthreads();
    }
  }
}

// Spatial gradient g[k] = <cb * vpe, T_k> (IEEE f32), vpe in OUT.
__device__ __forceinline__ void tile_spatial_grad(const Args &a, const Tile &t,
                                                  float *g0, float *g1,
                                                  float *g2) {
  const int E = a.E, F = (E - 3) / 2;
  for (int q = 0; q < TM / 8; q++) {
    int r = t.warp * (TM / 8) + q;
    const float *pe_row = a.pe32 + (size_t)(t.r0 + r) * HID;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = t.lane; k < HID; k += 32) {
      float c = cb_at(pe_row, k, E, F) * t.OUT[r * LDO + k];
      s0 += c * a.Tc[k];
      s1 += c * a.Tc[HID + k];
      s2 += c * a.Tc[2 * HID + k];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (t.lane == 0) { g0[r] = s0; g1[r] = s1; g2[r] = s2; }
  }
  __syncthreads();
}

// Parameter VJP of one tile from the cotangents of raw (draw) and of the
// spatial gradient (dg0..2), after tile_forward(keep = true): writes the
// bf16 operands of the dW products (m0b, tb, dzb, dub), the f32 partials of
// the biases and of the output layer. Phases 2 and 3 finish dW and db.
__device__ __forceinline__ void tile_param_vjp(const Args &a, const Tile &t,
                                               const float *draw,
                                               const float *dg0,
                                               const float *dg1,
                                               const float *dg2) {
  const int nh = a.L - 1, E = a.E, F = (E - 3) / 2, j = t.tid;
  const size_t plane = (size_t)a.NP * HID;
  const size_t wl = (size_t)CATW * HID;
  Acc acc[4][2];

  // ---- combined tangent m0 = [dg dxs | cb * (dg dproj2)] ----
  {
    const float t0 = a.Tc[j], t1 = a.Tc[HID + j], t2 = a.Tc[2 * HID + j];
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(t.r0 + r) * HID + j;
      float dgT = dg0[r] * t0 + dg1[r] * t1 + dg2[r] * t2;
      float m0 = j < 3 ? dgT : cb_at(a.pe32 + (size_t)(t.r0 + r) * HID, j, E, F) * dgT;
      bf16 mb = __float2bfloat16(m0);
      a.m0b[o] = mb;
      t.X[r * LDX + j] = mb;
      t.X2[r * LDX + j] = mb;
    }
  }
  __syncthreads();

  // ---- tangent chain ----
  for (int l = 0; l < nh; l++) {
    const bf16 *Wl = a.W + l * wl;
    acc_zero(acc);
    mm<false>(acc, t.X, Wl, t.warp);
    if (l == a.cat) mm<false>(acc, t.X2, Wl + HID * HID, t.warp);
    __syncthreads();
    acc_store(acc, t.OUT, t.warp);
    __syncthreads();
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(t.r0 + r) * HID + j;
      float u = t.OUT[r * LDO + j];
      a.u[l * plane + o] = u;
      float tv = u * a.sig[l * plane + o];
      t.X[r * LDX + j] = __float2bfloat16(tv);
      if (l < nh - 1) a.tb[l * plane + o] = __float2bfloat16(tv);
      else a.t5[o] = tv;
    }
    __syncthreads();
  }

  // ---- output-layer gradient partials (f32) ----
  {
    float sh = 0.f, st = 0.f;
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(t.r0 + r) * HID + j;
      sh += a.h5[o] * draw[r];
      st += a.t5[o];
    }
    a.part_dwout[(size_t)t.tile * HID + j] = sh + st;
    if (t.tid == 0) {
      float s = 0.f;
      for (int r = 0; r < TM; r++) s += draw[r];
      a.part_db[(size_t)t.tile * a.L * HID + nh * HID] = s;
    }
  }

  // ---- backward chain ----
  const float wj = a.w_out[j];
  for (int l = nh - 1; l >= 0; l--) {
    float dbs = 0.f;
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(t.r0 + r) * HID + j;
      float s = a.sig[l * plane + o], u = a.u[l * plane + o];
      float dh, dt;
      if (l == nh - 1) { dh = draw[r] * wj; dt = wj; }
      else { dh = t.OUT[r * LDO + j]; dt = t.OUT2[r * LDO + j]; }
      float sigp = 100.f * s * (1.f - s);
      float du = dt * s;
      float dz = dh * s + (dt * u) * sigp;
      dbs += dz;
      bf16 zb = __float2bfloat16(dz), ub = __float2bfloat16(du);
      a.dzb[l * plane + o] = zb;
      a.dub[l * plane + o] = ub;
      t.X[r * LDX + j] = zb;
      t.X2[r * LDX + j] = ub;
    }
    a.part_db[(size_t)t.tile * a.L * HID + l * HID + j] = dbs;
    __syncthreads();
    if (l > 0) {
      const bf16 *Wl = a.W + l * wl;
      acc_zero(acc);
      mm<true>(acc, t.X, Wl, t.warp);
      acc_store(acc, t.OUT, t.warp);
      acc_zero(acc);
      mm<true>(acc, t.X2, Wl, t.warp);
      acc_store(acc, t.OUT2, t.warp);
      __syncthreads();
    }
  }
}

// Phase 2: split-K dW GEMMs. grid (16 output tiles of 64x64, nh+1 GEMMs,
// S splits), 4 warps of 32x32. GEMM g < nh: layer g rows 0:256; g == nh:
// the skip layer's pe rows 256:512.
static __global__ void __launch_bounds__(128) k_dw(Args a) {
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.y, s = blockIdx.z, nh = a.L - 1;
  const int i0 = (blockIdx.x >> 2) * 64 + (warp >> 1) * 32;
  const int j0 = (blockIdx.x & 3) * 64 + (warp & 1) * 32;
  const size_t plane = (size_t)a.NP * HID;
  const int l = g < nh ? g : a.cat;
  const bf16 *A = (g == nh || l == 0) ? a.peb : a.hb + (l - 1) * plane;
  const bf16 *TA = (g == nh || l == 0) ? a.m0b : a.tb + (l - 1) * plane;
  const bf16 *DZ = a.dzb + l * plane, *DU = a.dub + l * plane;
  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int jj = 0; jj < 2; jj++) wmma::fill_fragment(acc[i][jj], 0.f);
  const int rb = s * a.rps, re = min(rb + a.rps, a.NP);
  for (int r = rb; r < re; r += 16) {
#pragma unroll
    for (int p = 0; p < 2; p++) {
      const bf16 *Ap = p ? TA : A, *Bp = p ? DU : DZ;
      FragAc fa[2];
      FragBr fb[2];
#pragma unroll
      for (int i = 0; i < 2; i++)
        wmma::load_matrix_sync(fa[i], Ap + (size_t)r * HID + i0 + 16 * i, HID);
#pragma unroll
      for (int jj = 0; jj < 2; jj++)
        wmma::load_matrix_sync(fb[jj], Bp + (size_t)r * HID + j0 + 16 * jj, HID);
#pragma unroll
      for (int i = 0; i < 2; i++)
#pragma unroll
        for (int jj = 0; jj < 2; jj++)
          wmma::mma_sync(acc[i][jj], fa[i], fb[jj], acc[i][jj]);
    }
  }
  float *out = a.part_dw + ((size_t)s * (nh + 1) + g) * HID * HID;
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int jj = 0; jj < 2; jj++)
      wmma::store_matrix_sync(out + (size_t)(i0 + 16 * i) * HID + j0 + 16 * jj,
                              acc[i][jj], HID, wmma::mem_row_major);
}

// Phase 3: fixed-order sums of the partials into dW [L,512,256],
// db [L,256] and (when sums is given) the five loss sums. Every output
// element is written: padded rows and columns get exact zeros.
static __global__ void k_reduce(Args a, int n_tiles) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nh = a.L - 1;
  const long long n_dw = (long long)a.L * CATW * HID;
  if (idx < n_dw) {
    int l = (int)(idx / (CATW * HID));
    int i = (int)((idx / HID) % CATW);
    int j = (int)(idx % HID);
    float s = 0.f;
    if (l < nh) {
      int g = -1, ii = i;
      if (i < HID) g = l;
      else if (l == a.cat) { g = nh; ii = i - HID; }
      if (g >= 0)
        for (int k = 0; k < a.S; k++)
          s += a.part_dw[(((size_t)k * (nh + 1) + g) * HID + ii) * HID + j];
    } else if (i < HID && j == 0) {
      for (int t = 0; t < n_tiles; t++) s += a.part_dwout[(size_t)t * HID + i];
    }
    a.dW[idx] = s;
    return;
  }
  long long k2 = idx - n_dw;
  if (k2 < (long long)a.L * HID) {
    int l = (int)(k2 / HID), j = (int)(k2 % HID);
    float s = 0.f;
    if (l < nh || j == 0)
      for (int t = 0; t < n_tiles; t++) s += a.part_db[(size_t)t * a.L * HID + k2];
    a.db[k2] = s;
    return;
  }
  long long k3 = k2 - (long long)a.L * HID;
  if (k3 < 5 && a.sums) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; t++) s += a.part_scal[t * 8 + k3];
    a.sums[k3] = s;
  }
}

// Phases 2 and 3 on stream st; returns the cudaGetLastError() code.
static inline int launch_dw_reduce(const Args &a, cudaStream_t st) {
  const int n_tiles = a.NP / TM;
  dim3 gdw(16, a.L, a.S);  // nh + 1 == L GEMMs
  k_dw<<<gdw, 128, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long total = (long long)a.L * CATW * HID + (long long)a.L * HID + 5;
  int nb = (int)((total + 255) / 256);
  k_reduce<<<nb, 256, 0, st>>>(a, n_tiles);
  return (int)cudaGetLastError();
}
