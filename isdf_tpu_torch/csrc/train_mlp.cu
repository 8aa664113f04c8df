// Fused SDF-MLP train op for Hopper (sm_90a): loss AND parameter gradients.
//
// Replaces the TPU kernel isdf_tpu/models/pallas_mlp.py::_make_kernel_train
// (reached through make_pallas_train_op -> op_pc_bounds / op_pe_in_kernel).
// The PC template flag selects the in-kernel batch-distance bounds (pc
// variant); without it the bounds and gradient targets come in as columns
// (ray variant). The math is the hand-derived one of the TPU kernel, which
// models/cuda_mlp.py::train_op_plain repeats in eager torch:
//
//   pe   = [xs | sin(xb) | cos(xb)]          from xyz, IEEE f32
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
// bf16 peak. Its inputs and outputs are a few MB, so it is bound by
// operations, and everything it stashes between phases is traffic the
// bound does not count.
//
// What the design does about it (a simple kernel that is right first):
//  * The TPU grid is sequential and accumulates dW in resident outputs.
//    Here phase 1 (k_train_tile) runs one block per 64-row tile, all in
//    parallel; it writes the bf16 operands of the dW products (a, ta, dz,
//    du per layer) to global scratch, and per-tile f32 partials of the bias
//    gradients, the output-layer gradient and the five loss sums.
//    Phase 2 (k_dw) forms dW_l = [a; ta]^T [dz; du] as split-K GEMMs over
//    all rows, one partial per split. Phase 3 (k_reduce) sums the partials
//    in a fixed order. No atomics: the result is the same on every run.
//  * 227 KB of shared memory cannot hold the TPU's per-layer stash of
//    sig/u/h/t (1.5 MB at 64 rows). The block keeps only its current
//    operands in shared memory (two bf16 [64,256] tiles, two f32 [64,256]
//    accumulator tiles, 196 KB) and stashes sig and u per layer in global
//    f32 scratch: it is read back once, coalesced, and stays far below the
//    time of the products.
//  * Hidden products are bf16 wmma fragments (16x16x16, f32 accumulate),
//    the weights read straight from global memory (L2-resident, 1.8 MB).
//    The PE, the pc scores, the tangent contractions and the output head
//    stay IEEE f32 on the CUDA cores; the PE and score sums are written
//    with __fmul_rn/__fadd_rn so they round exactly as the eager torch
//    version does, which keeps both on the same argmin.
//  * wgmma, TMA and a persistent pipelined schedule are later work.

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
  // loss knobs
  float so, trunc_d, tw, gw, ew, ead, fsf;
  // sizes and flags
  int N, NP, R, L, cat, E, l1, orien, S, rps;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

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
__device__ __forceinline__ float cb_at(const float *pe_row, int j, int E,
                                       int F) {
  if (j < 3) return 1.f;
  if (j < 3 + F) return pe_row[j + F];
  if (j < E) return -pe_row[j - F];
  return 0.f;
}

// Phase 1: one block per 64-row tile.
template <bool PC>
__global__ void __launch_bounds__(NTHR, 1) k_train_tile(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *X = reinterpret_cast<bf16 *>(smem);
  bf16 *X2 = X + TM * LDX;
  float *OUT = reinterpret_cast<float *>(X2 + TM * LDX);
  float *OUT2 = OUT + TM * LDO;

  __shared__ float px[TM], py[TM], pz[TM], bcol[TM], gt0[TM], gt1[TM],
      gt2[TM], vcol[TM], nz[TM], raw[TM], g0[TM], g1[TM], g2[TM], draw[TM],
      dg0[TM], dg1[TM], dg2[TM], ctb[5][TM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, r0 = tile * TM;
  const int nh = a.L - 1, E = a.E, F = (E - 3) / 2;
  const size_t plane = (size_t)a.NP * HID;
  const size_t wl = (size_t)CATW * HID;
  const int j = tid;  // the column this thread owns in elementwise passes

  // ---- per-row inputs ----
  if (tid < TM) {
    int r = r0 + tid;
    bool in = r < a.N;
    px[tid] = in ? a.pts[3 * r] : 0.f;
    py[tid] = in ? a.pts[3 * r + 1] : 0.f;
    pz[tid] = in ? a.pts[3 * r + 2] : 0.f;
    vcol[tid] = in ? a.valid[r] : 0.f;
    nz[tid] = in ? a.noise[r] : 0.f;
    if (!PC) {
      bcol[tid] = in ? a.col_a[r] : 0.f;
      gt0[tid] = in ? a.vec3[3 * r] : 0.f;
      gt1[tid] = in ? a.vec3[3 * r + 1] : 0.f;
      gt2[tid] = in ? a.vec3[3 * r + 2] : 0.f;
    }
  }
  __syncthreads();

  // ---- positional encoding (IEEE f32, rounding as the eager version) ----
  {
    const float m0 = a.Mc[j], m1 = a.Mc[HID + j], m2 = a.Mc[2 * HID + j],
                m3 = a.Mc[3 * HID + j];
    const bool cos_lane = (j >= 3 + F) && (j < E);
    for (int r = 0; r < TM; r++) {
      float pre = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(px[r], m0), __fmul_rn(py[r], m1)),
                    __fmul_rn(pz[r], m2)),
          m3);
      float pe = j < 3 ? pre
                       : (j < E ? sinf(__fadd_rn(pre, cos_lane ? HALF_PI : 0.f))
                                : 0.f);
      size_t o = (size_t)(r0 + r) * HID + j;
      a.pe32[o] = pe;
      bf16 pb = __float2bfloat16(pe);
      a.peb[o] = pb;
      X[r * LDX + j] = pb;
      X2[r * LDX + j] = pb;
    }
  }

  // ---- batch-distance bounds: nearest valid surface point ----
  if (PC) {
    const int rr = tid >> 2, sub = tid & 3;
    const float x = px[rr], y = py[rr], z = pz[rr];
    float best = __int_as_float(0x7f800000);
    int bi = 0x7fffffff;
    for (int s = sub; s < a.R; s += 4) {
      float sc = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(x, a.sp[s]), __fmul_rn(y, a.sp[a.R + s])),
                    __fmul_rn(z, a.sp[2 * a.R + s])),
          a.sp[3 * a.R + s]);
      if (sc < best) { best = sc; bi = s; }
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

  Acc acc[4][2];

  // ---- forward values ----
  for (int l = 0; l < nh; l++) {
    const bf16 *Wl = a.W + l * wl;
    acc_zero(acc);
    mm<false>(acc, X, Wl, warp);
    if (l == a.cat) mm<false>(acc, X2, Wl + HID * HID, warp);
    acc_store(acc, OUT, warp);
    __syncthreads();
    const float bj = a.b[l * HID + j];
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(r0 + r) * HID + j;
      float s, h;
      sig_sp(OUT[r * LDO + j] + bj, s, h);
      a.sig[l * plane + o] = s;
      X[r * LDX + j] = __float2bfloat16(h);
      if (l < nh - 1) {
        a.hb[l * plane + o] = __float2bfloat16(h);
      } else {
        a.h5[o] = h;
        OUT[r * LDO + j] = h;
      }
    }
    __syncthreads();
  }

  // ---- output head: raw = h . w_out + b_out (f32) ----
  const float bout = a.b[nh * HID];
  for (int q = 0; q < TM / 8; q++) {
    int r = warp * (TM / 8) + q;
    float s = 0.f;
    for (int k = lane; k < HID; k += 32) s += OUT[r * LDO + k] * a.w_out[k];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) raw[r] = s + bout;
  }
  __syncthreads();

  // ---- reverse v-chain -> d sdf / d pe ----
  {
    const float wj = a.w_out[j];
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(r0 + r) * HID + j;
      bf16 vs = __float2bfloat16(wj * a.sig[(nh - 1) * plane + o]);
      X[r * LDX + j] = vs;
      if (nh - 1 == a.cat) X2[r * LDX + j] = vs;
    }
  }
  __syncthreads();
  for (int l = nh - 1; l >= 0; l--) {
    acc_zero(acc);
    mm<true>(acc, X, a.W + l * wl, warp);
    if (l == 0 && a.cat < nh) mm<true>(acc, X2, a.W + a.cat * wl + HID * HID, warp);
    __syncthreads();
    acc_store(acc, OUT, warp);
    __syncthreads();
    if (l > 0) {
      for (int r = 0; r < TM; r++) {
        size_t o = (size_t)(r0 + r) * HID + j;
        bf16 vs = __float2bfloat16(OUT[r * LDO + j] * a.sig[(l - 1) * plane + o]);
        X[r * LDX + j] = vs;
        if (l - 1 == a.cat) X2[r * LDX + j] = vs;
      }
      __syncthreads();
    }
  }

  // ---- spatial gradient g[k] = <cb * vpe, T_k> (IEEE f32) ----
  for (int q = 0; q < TM / 8; q++) {
    int r = warp * (TM / 8) + q;
    const float *pe_row = a.pe32 + (size_t)(r0 + r) * HID;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < HID; k += 32) {
      float c = cb_at(pe_row, k, E, F) * OUT[r * LDO + k];
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
    if (lane == 0) { g0[r] = s0; g1[r] = s1; g2[r] = s2; }
  }
  __syncthreads();

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

  // ---- combined tangent m0 ----
  {
    const float t0 = a.Tc[j], t1 = a.Tc[HID + j], t2 = a.Tc[2 * HID + j];
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(r0 + r) * HID + j;
      float dgT = dg0[r] * t0 + dg1[r] * t1 + dg2[r] * t2;
      float m0 = j < 3 ? dgT : cb_at(a.pe32 + (size_t)(r0 + r) * HID, j, E, F) * dgT;
      bf16 mb = __float2bfloat16(m0);
      a.m0b[o] = mb;
      X[r * LDX + j] = mb;
      X2[r * LDX + j] = mb;
    }
  }
  __syncthreads();

  // ---- tangent chain ----
  for (int l = 0; l < nh; l++) {
    const bf16 *Wl = a.W + l * wl;
    acc_zero(acc);
    mm<false>(acc, X, Wl, warp);
    if (l == a.cat) mm<false>(acc, X2, Wl + HID * HID, warp);
    __syncthreads();
    acc_store(acc, OUT, warp);
    __syncthreads();
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(r0 + r) * HID + j;
      float u = OUT[r * LDO + j];
      a.u[l * plane + o] = u;
      float t = u * a.sig[l * plane + o];
      X[r * LDX + j] = __float2bfloat16(t);
      if (l < nh - 1) a.tb[l * plane + o] = __float2bfloat16(t);
      else a.t5[o] = t;
    }
    __syncthreads();
  }

  // ---- output-layer gradient partials (f32) ----
  {
    float sh = 0.f, st = 0.f;
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(r0 + r) * HID + j;
      sh += a.h5[o] * draw[r];
      st += a.t5[o];
    }
    a.part_dwout[(size_t)tile * HID + j] = sh + st;
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < TM; r++) s += draw[r];
      a.part_db[(size_t)tile * a.L * HID + nh * HID] = s;
    }
  }

  // ---- backward chain ----
  const float wj = a.w_out[j];
  for (int l = nh - 1; l >= 0; l--) {
    float dbs = 0.f;
    for (int r = 0; r < TM; r++) {
      size_t o = (size_t)(r0 + r) * HID + j;
      float s = a.sig[l * plane + o], u = a.u[l * plane + o];
      float dh, dt;
      if (l == nh - 1) { dh = draw[r] * wj; dt = wj; }
      else { dh = OUT[r * LDO + j]; dt = OUT2[r * LDO + j]; }
      float sigp = 100.f * s * (1.f - s);
      float du = dt * s;
      float dz = dh * s + (dt * u) * sigp;
      dbs += dz;
      bf16 zb = __float2bfloat16(dz), ub = __float2bfloat16(du);
      a.dzb[l * plane + o] = zb;
      a.dub[l * plane + o] = ub;
      X[r * LDX + j] = zb;
      X2[r * LDX + j] = ub;
    }
    a.part_db[(size_t)tile * a.L * HID + l * HID + j] = dbs;
    __syncthreads();
    if (l > 0) {
      const bf16 *Wl = a.W + l * wl;
      acc_zero(acc);
      mm<true>(acc, X, Wl, warp);
      acc_store(acc, OUT, warp);
      acc_zero(acc);
      mm<true>(acc, X2, Wl, warp);
      acc_store(acc, OUT2, warp);
      __syncthreads();
    }
  }
}

// Phase 2: split-K dW GEMMs. grid (16 output tiles of 64x64, nh+1 GEMMs,
// S splits), 4 warps of 32x32. GEMM g < nh: layer g rows 0:256; g == nh:
// the skip layer's pe rows 256:512.
__global__ void __launch_bounds__(128) k_dw(Args a) {
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
// db [L,256] and the five loss sums. Every output element is written.
__global__ void k_reduce(Args a, int n_tiles) {
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
  if (k3 < 5) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; t++) s += a.part_scal[t * 8 + k3];
    a.sums[k3] = s;
  }
}

#define N_PTRS 33
static_assert(offsetof(Args, so) == N_PTRS * sizeof(void *),
              "Args must start with N_PTRS pointers");

static const int SMEM_DYN = 2 * TM * LDX * (int)sizeof(bf16) +
                            2 * TM * LDO * (int)sizeof(float);

extern "C" int isdf_train_mlp_smem_bytes() { return SMEM_DYN; }

// ptrs: the pointer fields of Args in declaration order (N_PTRS of them);
// knobs: so, trunc_d, tw, gw, ew, ead, fsf; ints: N, NP, R, L, cat, E, l1,
// orien, S, rps, pc. Returns the cudaGetLastError() code after the launches.
extern "C" int isdf_train_mlp(const long long *ptrs, const float *knobs,
                              const int *ints, void *stream) {
  Args a;
  memcpy(&a, ptrs, N_PTRS * sizeof(void *));
  a.so = knobs[0]; a.trunc_d = knobs[1]; a.tw = knobs[2]; a.gw = knobs[3];
  a.ew = knobs[4]; a.ead = knobs[5]; a.fsf = knobs[6];
  a.N = ints[0]; a.NP = ints[1]; a.R = ints[2]; a.L = ints[3];
  a.cat = ints[4]; a.E = ints[5]; a.l1 = ints[6]; a.orien = ints[7];
  a.S = ints[8]; a.rps = ints[9];
  const bool pc = ints[10] != 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);

  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(k_train_tile<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    cudaFuncSetAttribute(k_train_tile<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    attr_set = true;
  }
  const int n_tiles = a.NP / TM;
  if (pc) k_train_tile<true><<<n_tiles, NTHR, SMEM_DYN, st>>>(a);
  else k_train_tile<false><<<n_tiles, NTHR, SMEM_DYN, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gdw(16, a.L, a.S);  // nh + 1 == L GEMMs
  k_dw<<<gdw, 128, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long total = (long long)a.L * CATW * HID + (long long)a.L * HID + 5;
  int nb = (int)((total + 255) / 256);
  k_reduce<<<nb, 256, 0, st>>>(a, n_tiles);
  return (int)cudaGetLastError();
}
