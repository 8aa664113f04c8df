// Shared pieces of the SDF-MLP kernels for Hopper (sm_90a): the argument
// block, the staged mma.sync tile products, and the per-tile stages that
// the fused train op (train_mlp.cu, K1) and the reverse-fused op
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
// A tile is 64 rows, one block of 256 threads (8 warps). Each hidden
// product X[64,256] @ W (or W^T) is mma.sync m16n8k16 (bf16 in, f32
// accumulate, inline PTX): the activation tile X/X2 stays in shared memory
// and is read by ldmatrix; the weight matrix streams through a ring of
// NSTAGE k-slabs of KS rows filled by cp.async, the next slab in flight
// while the current one is multiplied. Warp w owns output columns
// 32w..32w+31 of all 64 rows (64 f32 accumulators a thread). The
// epilogues (bias, softplus and sigma; the v-chain's * sig; the tangent
// chain's u and t; the backward chain's dz and du) run on the accumulator
// registers and write the bf16 result straight into the next product's
// X/X2 and the stash with 4- and 8-byte stores. Only the two row
// reductions (the output head and the spatial-gradient contraction) go
// through an f32 tile, which aliases X and X2 once the last product has
// read them. Shared memory: X and X2 (66 KB) and the ring (2 stages of 32
// rows, 40 KB), so two blocks are resident on an SM; a deeper ring would
// leave one, which measured slower (tools/k1_variants.py).
//
// What bounds it: the stash. sig and u of every hidden layer stay f32 in
// global scratch (they do not fit shared memory at 64 rows) and the dW
// operands go to global memory for phase 2: about 69 KB a point read and
// written, with the split-K partials 1.9 GB or 0.57 ms at 3.35 TB/s at the
// trainer's 27,000 points (chip_smoke.py, stash_bytes), against 0.165 ms
// of tensor-core work.
// Next step: wgmma fed by TMA rings on the staged operands.
//
// The f32-product mode (MLP_F32 = 1, set by the *_f32.cu sources; the
// port's tpu.mm_precision other than "default", isdf_tpu's mm_dtype =
// float32): the same stages, every hidden product an f32-grade product on
// the tensor cores by split bf16. An f32 value splits exactly into three
// bf16 parts, x = hi + mid + lo (8 + 8 + 8 significand bits; split3), and
// a product keeps the six largest of the nine cross terms (hh, hm, mh, hl,
// lh, mm; mma_split), each an mma.sync m16n8k16 bf16 product with f32
// accumulation, smallest first, in the accumulator fragment every epilogue
// already reads (rows g and g + 8, columns 2q and 2q + 1). The terms left
// out are below 2^-24 of the product, f32's own rounding: this is the
// arithmetic of a TPU's MXU under Precision.HIGHEST (float32 as six bf16
// passes), the mode isdf_tpu's f32 kernels ask for. The tensor cores' own
// sums do not round to nearest: with the running sum in the mma (96 term
// products a 256-deep product) the card read 13x the f32 FMA design's
// gap, so each k16 step sums its terms in a fresh fragment and f32 adds
// carry the running one (acc_add).
// Operands: the weights come through the ring as f32, as the wrapper holds
// them, and the activation tiles X and X2 stay f32; both are split in
// registers as a fragment is read (split_b, split_a; ld.shared, no
// ldmatrix). Each warp owns its 32 columns, so no weight is split twice in
// a tile. Three bf16 planes of the weights through the ring, read by
// ldmatrix, move 6 bytes a weight against 4, fit only 16-row stages, and
// measured about 1.2 ms slower a K1 call on an H100 (PERF.md). k_dw
// loads its f32 operand planes into registers and splits each value once
// into bf16 planes in shared memory, which it reads by ldmatrix as the
// bf16 mode does; storing split planes in the stash instead would add half
// again to its bytes.
// Shared memory: X and X2 f32 at a row stride of 264 (135,168 B; the
// 8-byte fragment loads of a quad's rows fall in distinct banks) and two
// 32-row f32 stages of the ring (81,920 B): 217,088 B dynamic and 6,656 B
// static, as ptxas -v reports it for k_train_tile's pc and ray modes and
// k1_geometry budgets it (5,888 B in the streamed-PE mode), one block of 8
// warps per SM. k_dw: two buffers of a 16-row slab's split planes
// (104,448 B). PERF.md, section 6.
// Bound: six bf16 products per f32 product, ~957 GFLOP a K1 call at
// 27,000 points, ~0.97 ms at 989 TFLOP/s (IEEE f32 FMAs: ~2.4 ms at 67
// TFLOP/s; the stash's 2.63 GB, 0.79 ms at 3.35 TB/s). What bounds it now:
// with one block per SM the weight stream, the stash's loads and stores
// and the epilogues run in lockstep with the tensor cores and add to their
// time rather than hide under it: the five terms past the first cost about
// 1.8 ms a K1 call, about 0.32 m16n8k16 a clock an SM (tools/
// k1_variants.py's f32_hh and f32_nomma against the shipped kernel; PERF.md,
// section 6).
//
// No atomics anywhere: every result is the same on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#ifndef MLP_F32
#define MLP_F32 0
#endif

#if MLP_F32
typedef float op_t;  // activation tiles and dW operand planes
typedef float wt_t;  // the weights, in global memory and in the ring
#define LDW 260      // plain weight slab row stride (elements)
#define MG 2         // m-tiles whose split fragments are live together
#define DW_KS 16     // k_dw slab rows
#define DW_LDB 136   // k_dw split planes' row stride (bf16)
#define DW_PRE (DW_KS * DW_T / NTHR)  // float4 a thread loads a slab
#define MIN_BLOCKS 1 // resident blocks per SM the launch bounds ask for
#else
typedef bf16 op_t;
typedef bf16 wt_t;
#define LDW 264
#define DW_KS 32
#define DW_LD 136
#define MIN_BLOCKS 2
#endif
#define LDX 264      // activation tile row stride (elements)
#define DW_NSTAGE 3  // k_dw ring stages
#define CHUNK (16 / (int)sizeof(op_t))  // elements of one 16-byte cp.async
#define WCHUNK (16 / (int)sizeof(wt_t))  // ... of the weights

#define HID 256
#define CATW 512
#define TM 64
#define NTHR 256
#define LDO 260    // f32 row-reduction tile row stride (elements)
#define KS 32      // weight rows (k) per ring stage
#define NSTAGE 2   // ring stages
#define LDT (KS + 8)  // row stride of a transposed weight slab [256 n][KS k]
#define STAGE_ELEMS (HID * LDT)  // >= KS * LDW, the plain slab [KS k][256 n]
#define HALF_PI 1.57079637050628662109375f  // float32(pi / 2)
#define ROWS_IN_FLIGHT 8  // global loads issued together in a per-row pass

// phase 2: 128x128 output tiles, slabs of DW_KS rows of the four operands
#define DW_T 128
#define DW_STAGE_ELEMS (4 * DW_KS * DW_LD)

struct Args {
  // per-point inputs
  const float *pts, *valid, *noise, *col_a, *vec3, *is_surf;
  // pc surface set: sp [4, R] (rows 0..2 = -2 s, row 3 = |s|^2 + penalty),
  // surf [R, 3]
  const float *sp, *surf;
  // constants: Mc [4, 256] PE plane, Tc [3, 256] tangent rows,
  // b [L, 256] biases (b[L-1][0] = output bias), w_out [256], inv_count [1]
  const float *Mc, *Tc, *b, *w_out, *inv_count;
  const wt_t *W;  // [L, 512, 256]
  // outputs
  float *ploss, *sums, *dW, *db;
  // scratch
  float *pe32, *sig, *u, *h5;
  op_t *peb, *m0b, *hb, *tb, *dzb, *dub;
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

#define N_PTRS 37
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

static const int RING_BYTES = NSTAGE * STAGE_ELEMS * (int)sizeof(wt_t);
static const int SMEM_DYN = 2 * TM * LDX * (int)sizeof(op_t) + RING_BYTES;
#if MLP_F32
// two buffers of a slab's split planes [3][4 operands][DW_KS][DW_LDB]
static const int DW_PLANE_ELEMS = 4 * DW_KS * DW_LDB;
static const int SMEM_DW = 2 * 3 * DW_PLANE_ELEMS * (int)sizeof(bf16);
#else
static const int SMEM_DW = DW_NSTAGE * DW_STAGE_ELEMS * (int)sizeof(op_t);
#endif
static_assert(KS * LDW <= STAGE_ELEMS, "a plain slab fits a stage");
static_assert(TM * LDO * sizeof(float) <= 2 * TM * LDX * sizeof(op_t),
              "the f32 tile fits in X and X2");

// ---- PTX: cp.async, ldmatrix, mma.sync ----

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16 *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16 *p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8]. Accumulator layout (PTX ISA): with
// g = lane / 4, q = lane % 4, c[0..1] hold row g, columns 2q and 2q + 1;
// c[2..3] row g + 8, the same columns.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void st_f2(float *p, float x, float y) {
  *reinterpret_cast<float2 *>(p) = make_float2(x, y);
}

__device__ __forceinline__ float2 ld_f2(const float *p) {
  return *reinterpret_cast<const float2 *>(p);
}

__device__ __forceinline__ void st_o2(bf16 *p, float x, float y) {
  *reinterpret_cast<bf162 *>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void st_o2(float *p, float x, float y) {
  st_f2(p, x, y);
}

// A product operand from an f32 value: rounded to bf16, or kept.
__device__ __forceinline__ op_t to_op(float x) {
#if MLP_F32
  return x;
#else
  return __float2bfloat16(x);
#endif
}

#if MLP_F32
// (x, y) -> bf16 pairs r[0] = hi, r[1] = mid, r[2] = lo with x == hi.x +
// mid.x + lo.x exactly (y likewise): each part is the bf16 rounding of what
// the larger ones leave, and every residual is exact in f32. The lower
// halves hold x, a fragment register's lower column.
__device__ __forceinline__ void split3(uint32_t (&r)[3], float x, float y) {
  const bf162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float mx = x - hf.x, my = y - hf.y;
  const bf162 m = __floats2bfloat162_rn(mx, my);
  const float2 mf = __bfloat1622float2(m);
  const bf162 l = __floats2bfloat162_rn(mx - mf.x, my - mf.y);
  r[0] = *reinterpret_cast<const uint32_t *>(&h);
  r[1] = *reinterpret_cast<const uint32_t *>(&m);
  r[2] = *reinterpret_cast<const uint32_t *>(&l);
}

// acc[i][jn] += A_X[i] B_Y[jn]: the (X, Y) cross term of a split product
// (parts 0 hi, 1 mid, 2 lo), 4 MT independent mma.sync a term.
template <int X, int Y, int MT>
__device__ __forceinline__ void split_term(float (&acc)[MT][4][4],
                                           const uint32_t (&a)[MT][3][4],
                                           const uint32_t (&b)[3][4][2]) {
#pragma unroll
  for (int i = 0; i < MT; i++)
#pragma unroll
    for (int jn = 0; jn < 4; jn++)
      mma_bf16(acc[i][jn], a[i][X], b[Y][jn][0], b[Y][jn][1]);
}

// acc += A B, A and B the sums of their three split parts: the six cross
// terms at least 2^-16 of the product, smallest first (ml, lm and ll, below
// 2^-24, are left out).
template <int MT>
__device__ __forceinline__ void mma_split(float (&acc)[MT][4][4],
                                          const uint32_t (&a)[MT][3][4],
                                          const uint32_t (&b)[3][4][2]) {
  split_term<1, 1>(acc, a, b);                                // mm
  split_term<0, 2>(acc, a, b); split_term<2, 0>(acc, a, b);  // hl, lh
  split_term<0, 1>(acc, a, b); split_term<1, 0>(acc, a, b);  // hm, mh
  split_term<0, 0>(acc, a, b);                                // hh
}
#endif

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

// cb[j]: the point-dependent factor of the PE Jacobian, from the f32 pe row
// pe = [xs | sin(xb) | cos(xb)]: cb = [1,1,1 | cos(xb) | -sin(xb) | 0].
__device__ __forceinline__ float cb_at(const float *pe_row, int j, int E,
                                       int F) {
  if (j < 3) return 1.f;
  if (j < 3 + F) return pe_row[j + F];
  if (j < E) return -pe_row[j - F];
  return 0.f;
}

// The block's shared tiles and coordinates. F, the f32 tile of the row
// reductions, aliases X and X2.
struct Tile {
  op_t *X, *X2;
  wt_t *ring;
  float *F;
  int tid, warp, lane, g, q, n0, tile, r0;
};

__device__ __forceinline__ Tile tile_of(unsigned char *smem) {
  Tile t;
  t.X = reinterpret_cast<op_t *>(smem);
  t.X2 = t.X + TM * LDX;
  t.ring = reinterpret_cast<wt_t *>(t.X2 + TM * LDX);
  t.F = reinterpret_cast<float *>(smem);
  t.tid = threadIdx.x;
  t.warp = t.tid >> 5;
  t.lane = t.tid & 31;
  t.g = t.lane >> 2;
  t.q = t.lane & 3;
  t.n0 = t.warp * 32;  // the warp's output columns n0..n0+31
  t.tile = blockIdx.x;
  t.r0 = t.tile * TM;
  return t;
}

template <int MT>
__device__ __forceinline__ void acc_zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int i = 0; i < MT; i++)
#pragma unroll
    for (int jn = 0; jn < 4; jn++)
#pragma unroll
      for (int e = 0; e < 4; e++) acc[i][jn][e] = 0.f;
}

#if MLP_F32
// acc[i0 + i] += part[i], f32 adds (round to nearest): the tensor cores'
// own sums of a product's terms do not round to nearest, so each k16 step
// sums its terms in a fresh fragment and only these adds carry the
// running sum.
template <int NG, int MT>
__device__ __forceinline__ void acc_add(float (&acc)[MT][4][4], int i0,
                                        const float (&part)[NG][4][4]) {
#pragma unroll
  for (int i = 0; i < NG; i++)
#pragma unroll
    for (int jn = 0; jn < 4; jn++)
#pragma unroll
      for (int e = 0; e < 4; e++) acc[i0 + i][jn][e] += part[i][jn][e];
}
#endif

// The weights of one product: segment 0 is W0, segment 1 (nseg == 2) W1;
// each is a 256x256 block of row stride 256.
struct Prod {
  const wt_t *W0, *W1;
  int nseg;
};

// Slab s of a product's weights into its ring stage: [KS k][256 n] or,
// with TRANS, [256 n][KS k]; then one cp.async group, empty past the end.
template <bool TRANS>
__device__ __forceinline__ void ring_issue(const Prod &p, int s, const Tile &t) {
  const int SPS = HID / KS;  // slabs per segment
  if (s < p.nseg * SPS) {
    const wt_t *W = s < SPS ? p.W0 : p.W1;
    const int k0 = (s % SPS) * KS;
    wt_t *dst = t.ring + (s % NSTAGE) * STAGE_ELEMS;
#pragma unroll
    for (int c = t.tid; c < HID * KS / WCHUNK; c += NTHR) {
      if (TRANS) {  // KS / WCHUNK chunks of 16 bytes a row
        const int n = c / (KS / WCHUNK), h = c % (KS / WCHUNK);
        cp_async16(dst + n * LDT + h * WCHUNK,
                   W + (size_t)n * HID + k0 + h * WCHUNK);
      } else {      // HID / WCHUNK chunks a row
        const int k = c / (HID / WCHUNK), h = c % (HID / WCHUNK);
        cp_async16(dst + k * LDW + h * WCHUNK,
                   W + (size_t)(k0 + k) * HID + h * WCHUNK);
      }
    }
  }
  cp_async_commit();
}

#if MLP_F32
// The split B fragments of the warp's 32 columns at k-rows k16..k16 + 15
// of an f32 weight slab: register h of n-tile jn holds k-rows 2q + 8h and
// 2q + 8h + 1 of column n0 + 8 jn + g, read as one float2 ([n][k]) or two
// floats ([k][n]) and split.
template <bool TRANS>
__device__ __forceinline__ void split_b(uint32_t (&b)[3][4][2],
                                        const float *S, int k16,
                                        const Tile &t) {
#pragma unroll
  for (int jn = 0; jn < 4; jn++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int n = t.n0 + 8 * jn + t.g, k = k16 + 2 * t.q + 8 * h;
      float x, y;
      if (TRANS) {
        const float2 v = ld_f2(S + n * LDT + k);
        x = v.x; y = v.y;
      } else {
        x = S[k * LDW + n]; y = S[(k + 1) * LDW + n];
      }
      uint32_t s3[3];
      split3(s3, x, y);
      b[0][jn][h] = s3[0]; b[1][jn][h] = s3[1]; b[2][jn][h] = s3[2];
    }
}

// The split A fragments of rows m0row..m0row + 16 MT - 1, columns k0..k0 +
// 15 of an f32 tile: register r of m-tile i holds rows g + 8 (r & 1),
// columns 2q, 2q + 1 (+ 8 when r >= 2), read as float2 and split.
template <int MT>
__device__ __forceinline__ void split_a(uint32_t (&af)[MT][3][4],
                                        const float *X, int m0row, int k0,
                                        const Tile &t) {
#pragma unroll
  for (int i = 0; i < MT; i++) {
    const float *p = X + (m0row + 16 * i + t.g) * LDX + k0 + 2 * t.q;
#pragma unroll
    for (int r = 0; r < 4; r++) {
      const float2 v = ld_f2(p + (r & 1) * 8 * LDX + (r >> 1) * 8);
      uint32_t s3[3];
      split3(s3, v.x, v.y);
      af[i][0][r] = s3[0]; af[i][1][r] = s3[1]; af[i][2][r] = s3[2];
    }
  }
}
#endif

// Starts a product's weight stream: its first NSTAGE - 1 slabs. Called
// once the ring is free (after the barrier that ends the previous
// product's k-loop), so the loads run under the epilogue in between.
template <bool TRANS>
__device__ __forceinline__ void ring_prime(const Prod &p, const Tile &t) {
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; s++) ring_issue<TRANS>(p, s, t);
}

// Rows m0row .. m0row + 16 MT - 1 of the product, columns n0..n0+31 of the
// warp, accumulated in registers, after ring_prime<TRANS>(p):
//   !DUAL: acc += X0 @ B(W0) [+ X1 @ B(W1) when nseg == 2]
//    DUAL: acc += X0 @ B(W0), acc2 += X1 @ B(W0)
// with B(W) = W (row-major [256 k][256 n]) or, with TRANS, W^T (W read as
// [256 n][256 k]). The weights stream through the ring in slabs of KS
// k-rows: cp.async by all threads, NSTAGE - 1 slabs in flight, one barrier
// per slab. Ends with every cp.async group retired; the caller puts a
// barrier before anything overwrites X0/X1 or the ring.
template <bool TRANS, int MT, bool DUAL>
__device__ __forceinline__ void mm_stream(float (&acc)[MT][4][4],
                                          float (&acc2)[MT][4][4],
                                          const op_t *X0, const op_t *X1,
                                          const Prod &p, int m0row,
                                          const Tile &t) {
  const int SPS = HID / KS;
  const int nslab = p.nseg * SPS;
  const int lane = t.lane;
  for (int s = 0; s < nslab; s++) {
    cp_async_wait<NSTAGE - 2>();  // slab s has landed for this thread
    __syncthreads();              // ... for all; slab s - 1's stage is free
    ring_issue<TRANS>(p, s + NSTAGE - 1, t);
    const wt_t *S = t.ring + (s % NSTAGE) * STAGE_ELEMS;
    const int kk = (s % SPS) * KS;
    const op_t *XA = (!DUAL && s >= SPS) ? X1 : X0;
#if MLP_F32
    // split-bf16 products: B(W) and A's rows split in registers (A MG
    // m-tiles at a time), the six cross terms into a fresh fragment added
    // to the running one
#pragma unroll
    for (int k16 = 0; k16 < KS; k16 += 16) {
      uint32_t b[3][4][2];
      split_b<TRANS>(b, S, k16, t);
#pragma unroll
      for (int ig = 0; ig < MT; ig += MG) {
        uint32_t af[MG][3][4];
        float part[MG][4][4];
        split_a<MG>(af, XA, m0row + 16 * ig, kk + k16, t);
        acc_zero(part);
        mma_split(part, af, b);
        acc_add<MG>(acc, ig, part);
        if (DUAL) {
          split_a<MG>(af, X1, m0row + 16 * ig, kk + k16, t);
          acc_zero(part);
          mma_split(part, af, b);
          acc_add<MG>(acc2, ig, part);
        }
      }
    }
#else
#pragma unroll
    for (int k16 = 0; k16 < KS; k16 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int pp = 0; pp < 2; pp++) {
        uint32_t r[4];
        const int nb = t.n0 + 16 * pp;
        if (TRANS)
          ldsm_x4(r, S + (nb + (lane & 7) + ((lane >> 4) << 3)) * LDT + k16 +
                         ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(r, S + (k16 + (lane & 15)) * LDW + nb + (lane >> 4) * 8);
        b[2 * pp][0] = r[0]; b[2 * pp][1] = r[1];
        b[2 * pp + 1][0] = r[2]; b[2 * pp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; i++) {
        const int ar = (m0row + 16 * i + (lane & 15)) * LDX + kk + k16 +
                       (lane >> 4) * 8;
        uint32_t af[4];
        ldsm_x4(af, XA + ar);
#pragma unroll
        for (int jn = 0; jn < 4; jn++) mma_bf16(acc[i][jn], af, b[jn][0], b[jn][1]);
        if (DUAL) {
          ldsm_x4(af, X1 + ar);
#pragma unroll
          for (int jn = 0; jn < 4; jn++)
            mma_bf16(acc2[i][jn], af, b[jn][0], b[jn][1]);
        }
      }
    }
#endif
  }
  cp_async_wait<0>();
}

// The products of the chains: the forward and tangent chains' layer l
// (the skip layer's pe rows as a second segment), the v-chain's layer l
// (transposed; layer 0 adds the skip layer's pe rows through X2) and the
// backward chain's layer l (transposed, main rows only).
__device__ __forceinline__ Prod prod_fwd(const Args &a, int l) {
  const wt_t *Wl = a.W + (size_t)l * CATW * HID;
  return Prod{Wl, Wl + HID * HID, l == a.cat ? 2 : 1};
}

__device__ __forceinline__ Prod prod_vchain(const Args &a, int l) {
  return Prod{a.W + (size_t)l * CATW * HID,
              a.W + (size_t)a.cat * CATW * HID + HID * HID,
              (l == 0 && a.cat < a.L - 1) ? 2 : 1};
}

__device__ __forceinline__ Prod prod_back(const Args &a, int l) {
  return Prod{a.W + (size_t)l * CATW * HID, nullptr, 1};
}

// pe tile from the streamed plane pe_in [N, E] (zero past row N and column
// E) into pe32 (f32 scratch), peb (op_t dW operand, when given), X and X2.
__device__ __forceinline__ void tile_pe_stream(const Args &a, const Tile &t) {
  const int j = t.tid;
  for (int rb = 0; rb < TM; rb += ROWS_IN_FLIGHT) {
    float pe[ROWS_IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < ROWS_IN_FLIGHT; k++) {
      const int row = t.r0 + rb + k;
      pe[k] = (row < a.N && j < a.E) ? a.pe_in[(size_t)row * a.E + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < ROWS_IN_FLIGHT; k++) {
      const int r = rb + k;
      const size_t o = (size_t)(t.r0 + r) * HID + j;
      a.pe32[o] = pe[k];
      const op_t pb = to_op(pe[k]);
      if (a.peb) a.peb[o] = pb;
      t.X[r * LDX + j] = pb;
      t.X2[r * LDX + j] = pb;
    }
  }
  __syncthreads();
}

// Forward values. X and X2 hold the op_t pe tile. Stashes sig per layer;
// with keep, also the op_t inputs of layers 1.. (hb) and the last h in f32
// (h5) for the parameter VJP. Leaves the last h (f32) in F, and primes the
// ring with the next stage's first product: the v-chain's (then_vchain)
// or the tangent chain's.
__device__ __forceinline__ void tile_forward(const Args &a, const Tile &t,
                                             bool keep, bool then_vchain) {
  const int nh = a.L - 1;
  const size_t plane = (size_t)a.NP * HID;
  float acc[4][4][4];
  ring_prime<false>(prod_fwd(a, 0), t);
  for (int l = 0; l < nh; l++) {
    acc_zero(acc);
    mm_stream<false, 4, false>(acc, acc, t.X, t.X2, prod_fwd(a, l), 0, t);
    __syncthreads();
    if (l + 1 < nh) ring_prime<false>(prod_fwd(a, l + 1), t);
    else if (then_vchain) ring_prime<true>(prod_vchain(a, nh - 1), t);
    else ring_prime<false>(prod_fwd(a, 0), t);
    const bool last = l == nh - 1;
    float2 bias[4];
#pragma unroll
    for (int jn = 0; jn < 4; jn++)
      bias[jn] = ld_f2(a.b + l * HID + t.n0 + 8 * jn + 2 * t.q);
#pragma unroll
    for (int i = 0; i < 4; i++)
#pragma unroll
      for (int h = 0; h < 2; h++) {
        const int r = 16 * i + t.g + 8 * h;  // forward epilogue row
#pragma unroll
        for (int jn = 0; jn < 4; jn++) {
          const int c = t.n0 + 8 * jn + 2 * t.q;
          const size_t o = (size_t)(t.r0 + r) * HID + c;
          float s0, h0, s1, h1;
          sig_sp(acc[i][jn][2 * h] + bias[jn].x, s0, h0);
          sig_sp(acc[i][jn][2 * h + 1] + bias[jn].y, s1, h1);
          st_f2(a.sig + l * plane + o, s0, s1);
          if (!last) {
            st_o2(t.X + r * LDX + c, h0, h1);
            if (keep) st_o2(a.hb + l * plane + o, h0, h1);
          } else {
            st_f2(t.F + r * LDO + c, h0, h1);
            if (keep) st_f2(a.h5 + o, h0, h1);
          }
        }
      }
    __syncthreads();
  }
}

// raw[r] = h . w_out + b_out (f32), h the last hidden row in F.
__device__ __forceinline__ void tile_head(const Args &a, const Tile &t,
                                          float *raw) {
  const int nh = a.L - 1;
  const float bout = a.b[nh * HID];
  for (int q = 0; q < TM / 8; q++) {
    int r = t.warp * (TM / 8) + q;
    float s = 0.f;
    for (int k = t.lane; k < HID; k += 32) s += t.F[r * LDO + k] * a.w_out[k];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (t.lane == 0) raw[r] = s + bout;
  }
  __syncthreads();
}

// Reverse v-chain, its first product primed by tile_forward: leaves vpe =
// d raw / d pe (f32) in F. The skip layer's pe rows add their term to the
// layer-0 product through X2. With then_tangent, primes the ring with the
// tangent chain's first product.
__device__ __forceinline__ void tile_vchain(const Args &a, const Tile &t,
                                            bool then_tangent) {
  const int nh = a.L - 1, j = t.tid;
  const size_t plane = (size_t)a.NP * HID;
  {
    const float wj = a.w_out[j];
    for (int rb = 0; rb < TM; rb += ROWS_IN_FLIGHT) {
      float sv[ROWS_IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; k++)
        sv[k] = a.sig[(nh - 1) * plane + (size_t)(t.r0 + rb + k) * HID + j];
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; k++) {
        const int r = rb + k;
        const op_t vs = to_op(wj * sv[k]);
        t.X[r * LDX + j] = vs;
        if (nh - 1 == a.cat) t.X2[r * LDX + j] = vs;
      }
    }
  }
  __syncthreads();
  float acc[4][4][4];
  for (int l = nh - 1; l >= 0; l--) {
    acc_zero(acc);
    mm_stream<true, 4, false>(acc, acc, t.X, t.X2, prod_vchain(a, l), 0, t);
    __syncthreads();
    if (l > 0) ring_prime<true>(prod_vchain(a, l - 1), t);
    else if (then_tangent) ring_prime<false>(prod_fwd(a, 0), t);
#pragma unroll
    for (int i = 0; i < 4; i++) {
      float2 sv[2][4];
      if (l > 0) {
#pragma unroll
        for (int h = 0; h < 2; h++)
#pragma unroll
          for (int jn = 0; jn < 4; jn++)
            sv[h][jn] = ld_f2(a.sig + (l - 1) * plane +
                              (size_t)(t.r0 + 16 * i + t.g + 8 * h) * HID +
                              t.n0 + 8 * jn + 2 * t.q);
      }
#pragma unroll
      for (int h = 0; h < 2; h++) {
        const int r = 16 * i + t.g + 8 * h;
#pragma unroll
        for (int jn = 0; jn < 4; jn++) {
          const int c = t.n0 + 8 * jn + 2 * t.q;
          const float v0 = acc[i][jn][2 * h], v1 = acc[i][jn][2 * h + 1];
          if (l > 0) {
            st_o2(t.X + r * LDX + c, v0 * sv[h][jn].x, v1 * sv[h][jn].y);
            if (l - 1 == a.cat)
              st_o2(t.X2 + r * LDX + c, v0 * sv[h][jn].x, v1 * sv[h][jn].y);
          } else {
            st_f2(t.F + r * LDO + c, v0, v1);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Spatial gradient g[k] = <cb * vpe, T_k> (IEEE f32), vpe in F.
__device__ __forceinline__ void tile_spatial_grad(const Args &a, const Tile &t,
                                                  float *g0, float *g1,
                                                  float *g2) {
  const int E = a.E, F = (E - 3) / 2;
  for (int q0 = 0; q0 < TM / 8; q0 += 4) {
    float cb[4][HID / 32];  // the loads of four rows in flight together
#pragma unroll
    for (int q = 0; q < 4; q++)
#pragma unroll
      for (int m = 0; m < HID / 32; m++)
        cb[q][m] = cb_at(a.pe32 + (size_t)(t.r0 + t.warp * (TM / 8) + q0 + q) * HID,
                         t.lane + 32 * m, E, F);
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int r = t.warp * (TM / 8) + q0 + q;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int m = 0; m < HID / 32; m++) {
        const int k = t.lane + 32 * m;
        float c = cb[q][m] * t.F[r * LDO + k];
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
  }
  __syncthreads();
}

// Sum of v over the 8 lanes of a quad column (rows g = 0..7), fixed order.
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Parameter VJP of one tile from the cotangents of raw (draw) and of the
// spatial gradient (dg0..2), after tile_forward(keep = true), the tangent
// chain's first product primed in the ring: writes the
// op_t operands of the dW products (m0b, tb, dzb, dub), the f32 partials of
// the biases and of the output layer. Phases 2 and 3 finish dW and db.
__device__ __forceinline__ void tile_param_vjp(const Args &a, const Tile &t,
                                               const float *draw,
                                               const float *dg0,
                                               const float *dg1,
                                               const float *dg2) {
  const int nh = a.L - 1, E = a.E, F = (E - 3) / 2, j = t.tid;
  const size_t plane = (size_t)a.NP * HID;
  __shared__ float st_col[HID];  // sum over the tile's rows of the last t

  // ---- combined tangent m0 = [dg dxs | cb * (dg dproj2)] ----
  {
    const float t0 = a.Tc[j], t1 = a.Tc[HID + j], t2 = a.Tc[2 * HID + j];
    for (int rb = 0; rb < TM; rb += ROWS_IN_FLIGHT) {
      float cb[ROWS_IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; k++)
        cb[k] = cb_at(a.pe32 + (size_t)(t.r0 + rb + k) * HID, j, E, F);
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; k++) {
        const int r = rb + k;
        size_t o = (size_t)(t.r0 + r) * HID + j;
        float dgT = dg0[r] * t0 + dg1[r] * t1 + dg2[r] * t2;
        float m0 = j < 3 ? dgT : cb[k] * dgT;
        const op_t mb = to_op(m0);
        a.m0b[o] = mb;
        t.X[r * LDX + j] = mb;
        t.X2[r * LDX + j] = mb;
      }
    }
  }
  __syncthreads();

  // ---- tangent chain: u_l = t_{l-1} W_l, t_l = u_l sig_l ----
  {
    float acc[4][4][4];
    for (int l = 0; l < nh; l++) {
      const bool last = l == nh - 1;
      acc_zero(acc);
      mm_stream<false, 4, false>(acc, acc, t.X, t.X2, prod_fwd(a, l), 0, t);
      __syncthreads();
      if (!last) ring_prime<false>(prod_fwd(a, l + 1), t);
      else ring_prime<true>(prod_back(a, nh - 1), t);
      float st[4][2] = {};
#pragma unroll
      for (int i = 0; i < 4; i++) {
        float2 sv[2][4];
#pragma unroll
        for (int h = 0; h < 2; h++)
#pragma unroll
          for (int jn = 0; jn < 4; jn++)
            sv[h][jn] = ld_f2(a.sig + l * plane +
                              (size_t)(t.r0 + 16 * i + t.g + 8 * h) * HID +
                              t.n0 + 8 * jn + 2 * t.q);
#pragma unroll
        for (int h = 0; h < 2; h++) {
          const int r = 16 * i + t.g + 8 * h;
#pragma unroll
          for (int jn = 0; jn < 4; jn++) {
            const int c = t.n0 + 8 * jn + 2 * t.q;
            const size_t o = (size_t)(t.r0 + r) * HID + c;
            const float u0 = acc[i][jn][2 * h], u1 = acc[i][jn][2 * h + 1];
            st_f2(a.u + l * plane + o, u0, u1);
            const float tv0 = u0 * sv[h][jn].x, tv1 = u1 * sv[h][jn].y;
            if (!last) {
              st_o2(t.X + r * LDX + c, tv0, tv1);
              st_o2(a.tb + l * plane + o, tv0, tv1);
            } else {
              st[jn][0] += tv0;
              st[jn][1] += tv1;
            }
          }
        }
      }
      if (last) {
#pragma unroll
        for (int jn = 0; jn < 4; jn++)
#pragma unroll
          for (int e = 0; e < 2; e++) {
            const float v = sum_over_g(st[jn][e]);
            if (t.g == 0) st_col[t.n0 + 8 * jn + 2 * t.q + e] = v;
          }
      }
      __syncthreads();
    }
  }

  // ---- output-layer gradient partials (f32) ----
  {
    float sh = 0.f;
#pragma unroll 8
    for (int r = 0; r < TM; r++)
      sh += a.h5[(size_t)(t.r0 + r) * HID + j] * draw[r];
    a.part_dwout[(size_t)t.tile * HID + j] = sh + st_col[j];
    if (t.tid == 0) {
      float s = 0.f;
      for (int r = 0; r < TM; r++) s += draw[r];
      a.part_db[(size_t)t.tile * a.L * HID + nh * HID] = s;
    }
  }

  // ---- backward chain, last hidden layer: dh = draw w_out, dt = w_out ----
  {
    const int l = nh - 1;
    const float wj = a.w_out[j];
    float dbs = 0.f;
    for (int rb = 0; rb < TM; rb += ROWS_IN_FLIGHT) {
      float sv[ROWS_IN_FLIGHT], uv[ROWS_IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; k++) {
        const size_t o = (size_t)(t.r0 + rb + k) * HID + j;
        sv[k] = a.sig[l * plane + o];
        uv[k] = a.u[l * plane + o];
      }
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; k++) {
        const int r = rb + k;
        size_t o = (size_t)(t.r0 + r) * HID + j;
        float s = sv[k], u = uv[k];
        float dh = draw[r] * wj, dt = wj;
        float sigp = 100.f * s * (1.f - s);
        float du = dt * s;
        float dz = dh * s + (dt * u) * sigp;
        dbs += dz;
        const op_t zb = to_op(dz), ub = to_op(du);
        a.dzb[l * plane + o] = zb;
        a.dub[l * plane + o] = ub;
        t.X[r * LDX + j] = zb;
        t.X2[r * LDX + j] = ub;
      }
    }
    a.part_db[(size_t)t.tile * a.L * HID + l * HID + j] = dbs;
  }
  __syncthreads();

  // ---- backward chain: dh = dz_l W_l^T, dt = du_l W_l^T -> layer l - 1.
  // Two passes of 32 rows each hold both products in registers; a pass
  // reads and then rewrites only its own rows of X and X2.
  for (int l = nh - 1; l >= 1; l--) {
    const int lo = l - 1;
    float dbs[4][2] = {};
    for (int half = 0; half < 2; half++) {
      float dh[2][4][4], dt[2][4][4];
      acc_zero(dh);
      acc_zero(dt);
      mm_stream<true, 2, true>(dh, dt, t.X, t.X2, prod_back(a, l), 32 * half,
                               t);
      __syncthreads();
      if (half == 0) ring_prime<true>(prod_back(a, l), t);
      else if (l > 1) ring_prime<true>(prod_back(a, l - 1), t);
#pragma unroll
      for (int i = 0; i < 2; i++)
#pragma unroll
        for (int h = 0; h < 2; h++) {
          const int r = 32 * half + 16 * i + t.g + 8 * h;
          float2 sv[4], uv[4];
#pragma unroll
          for (int jn = 0; jn < 4; jn++) {
            const size_t o = (size_t)(t.r0 + r) * HID + t.n0 + 8 * jn + 2 * t.q;
            sv[jn] = ld_f2(a.sig + lo * plane + o);
            uv[jn] = ld_f2(a.u + lo * plane + o);
          }
#pragma unroll
          for (int jn = 0; jn < 4; jn++) {
            const int c = t.n0 + 8 * jn + 2 * t.q;
            const size_t o = (size_t)(t.r0 + r) * HID + c;
            float dz[2], du[2];
#pragma unroll
            for (int e = 0; e < 2; e++) {
              const float s = e ? sv[jn].y : sv[jn].x;
              const float u = e ? uv[jn].y : uv[jn].x;
              const float dhv = dh[i][jn][2 * h + e], dtv = dt[i][jn][2 * h + e];
              const float sigp = 100.f * s * (1.f - s);
              du[e] = dtv * s;
              dz[e] = dhv * s + (dtv * u) * sigp;
              dbs[jn][e] += dz[e];
            }
            st_o2(a.dzb + lo * plane + o, dz[0], dz[1]);
            st_o2(a.dub + lo * plane + o, du[0], du[1]);
            st_o2(t.X + r * LDX + c, dz[0], dz[1]);
            st_o2(t.X2 + r * LDX + c, du[0], du[1]);
          }
        }
    }
#pragma unroll
    for (int jn = 0; jn < 4; jn++)
#pragma unroll
      for (int e = 0; e < 2; e++) {
        const float v = sum_over_g(dbs[jn][e]);
        if (t.g == 0)
          a.part_db[(size_t)t.tile * a.L * HID + lo * HID + t.n0 + 8 * jn +
                    2 * t.q + e] = v;
      }
    __syncthreads();
  }
}

// Phase 2: split-K dW GEMMs, dW_g = [A; TA]^T [DZ; DU] over the rows
// rb..re of split s. grid (4 output tiles of 128x128, nh + 1 GEMMs, S
// splits), 8 warps of 64x32. GEMM g < nh: layer g rows 0:256; g == nh: the
// skip layer's pe rows 256:512. Slabs of DW_KS rows of the four operands
// (128 columns each) come in by cp.async through a DW_NSTAGE ring; the
// A-side fragments by ldmatrix.trans (A is stored [row][i]), the B side
// by ldmatrix.trans ([row][j] is k-major); in the f32 mode the same from
// bf16 planes that the block splits each f32 slab into, once a value.
static __global__ void __launch_bounds__(NTHR, MIN_BLOCKS) k_dw(Args a) {
  extern __shared__ __align__(128) unsigned char smem_dw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.y, s = blockIdx.z, nh = a.L - 1;
  const int ib = (blockIdx.x >> 1) * DW_T, jb = (blockIdx.x & 1) * DW_T;
  const int wi = (warp >> 2) * 64, wj = (warp & 3) * 32;
  const size_t plane = (size_t)a.NP * HID;
  const int l = g < nh ? g : a.cat;
  const op_t *ops[4];
  ops[0] = (g == nh || l == 0) ? a.peb : a.hb + (l - 1) * plane;   // A
  ops[1] = (g == nh || l == 0) ? a.m0b : a.tb + (l - 1) * plane;   // TA
  ops[2] = a.dzb + l * plane;                                      // DZ
  ops[3] = a.dub + l * plane;                                      // DU
  const int rb = s * a.rps, re = min(rb + a.rps, a.NP);
  const int nslab = max(re - rb, 0) / DW_KS;

  const int gq = lane >> 2, q = lane & 3;
  float acc[4][4][4];
  acc_zero(acc);
#if MLP_F32
  // each slab's f32 operands come to registers (the next slab's loads in
  // flight under this slab's products), are split once into bf16 planes
  // (two buffers, one barrier a slab), then multiplied as split-bf16
  // products on fragments read as in the bf16 mode, MG m-tiles at a time
  // into a fresh fragment added to the running one
  bf16 *planes = reinterpret_cast<bf16 *>(smem_dw);
  float4 pre[DW_PRE];
  auto load = [&](int k) {  // slab k into pre
    const size_t row0 = (size_t)rb + k * DW_KS;
#pragma unroll
    for (int j = 0; j < DW_PRE; j++) {
      const int c = tid + j * NTHR;
      const int op = c / (DW_KS * DW_T / 4), r = (c / (DW_T / 4)) % DW_KS;
      const int c4 = (c % (DW_T / 4)) * 4;
      pre[j] = *reinterpret_cast<const float4 *>(
          ops[op] + (row0 + r) * HID + (op < 2 ? ib : jb) + c4);
    }
  };
  auto store = [&](int buf) {  // pre, split, into plane buffer buf
    bf16 *P = planes + buf * 3 * DW_PLANE_ELEMS;
#pragma unroll
    for (int j = 0; j < DW_PRE; j++) {
      const int c = tid + j * NTHR;
      const int op = c / (DW_KS * DW_T / 4), r = (c / (DW_T / 4)) % DW_KS;
      const int c4 = (c % (DW_T / 4)) * 4;
      uint32_t lo[3], hi[3];
      split3(lo, pre[j].x, pre[j].y);
      split3(hi, pre[j].z, pre[j].w);
#pragma unroll
      for (int pl = 0; pl < 3; pl++)
        *reinterpret_cast<uint2 *>(P + pl * DW_PLANE_ELEMS +
                                   (op * DW_KS + r) * DW_LDB + c4) =
            make_uint2(lo[pl], hi[pl]);
    }
  };
  if (nslab > 0) {
    load(0);
    store(0);
  }
  if (nslab > 1) load(1);
  for (int k = 0; k < nslab; k++) {
    __syncthreads();  // slab k's planes are stored; slab k - 1's are read
    if (k + 1 < nslab) {
      store((k + 1) & 1);
      if (k + 2 < nslab) load(k + 2);
    }
    const bf16 *P = planes + (k & 1) * 3 * DW_PLANE_ELEMS;
#pragma unroll
    for (int ig = 0; ig < 4; ig += MG) {
      float part[MG][4][4];
      acc_zero(part);
#pragma unroll
      for (int p = 0; p < 2; p++) {
        uint32_t b[3][4][2], af[MG][3][4];
#pragma unroll
        for (int pl = 0; pl < 3; pl++) {
          const bf16 *SA = P + pl * DW_PLANE_ELEMS + p * DW_KS * DW_LDB;
          const bf16 *SB = P + pl * DW_PLANE_ELEMS + (2 + p) * DW_KS * DW_LDB;
#pragma unroll
          for (int pp = 0; pp < 2; pp++) {
            uint32_t r[4];
            ldsm_x4_t(r, SB + (lane & 15) * DW_LDB + wj + 16 * pp +
                             (lane >> 4) * 8);
            b[pl][2 * pp][0] = r[0]; b[pl][2 * pp][1] = r[1];
            b[pl][2 * pp + 1][0] = r[2]; b[pl][2 * pp + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < MG; i++)
            ldsm_x4_t(af[i][pl], SA + ((lane & 7) + ((lane >> 4) << 3)) *
                                          DW_LDB + wi + 16 * (ig + i) +
                                      ((lane >> 3) & 1) * 8);
        }
        mma_split(part, af, b);
      }
      acc_add<MG>(acc, ig, part);
    }
  }
#else
  op_t *ring = reinterpret_cast<op_t *>(smem_dw);
  auto issue = [&](int k) {
    if (k < nslab) {
      op_t *dst = ring + (k % DW_NSTAGE) * DW_STAGE_ELEMS;
      const size_t row0 = (size_t)rb + k * DW_KS;
#pragma unroll
      for (int op = 0; op < 4; op++)
#pragma unroll
        for (int c = tid; c < DW_KS * (DW_T / CHUNK); c += NTHR) {
          const int r = c / (DW_T / CHUNK), h = c % (DW_T / CHUNK);
          cp_async16(dst + (op * DW_KS + r) * DW_LD + h * CHUNK,
                     ops[op] + (row0 + r) * HID + (op < 2 ? ib : jb) +
                         h * CHUNK);
        }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < DW_NSTAGE - 1; k++) issue(k);
  for (int k = 0; k < nslab; k++) {
    cp_async_wait<DW_NSTAGE - 2>();
    __syncthreads();
    issue(k + DW_NSTAGE - 1);
    const op_t *S = ring + (k % DW_NSTAGE) * DW_STAGE_ELEMS;
#pragma unroll
    for (int k16 = 0; k16 < DW_KS; k16 += 16)
#pragma unroll
      for (int p = 0; p < 2; p++) {
        const op_t *SA = S + p * DW_KS * DW_LD;        // A or TA
        const op_t *SB = S + (2 + p) * DW_KS * DW_LD;  // DZ or DU
        uint32_t b[4][2];
#pragma unroll
        for (int pp = 0; pp < 2; pp++) {
          uint32_t r[4];
          ldsm_x4_t(r, SB + (k16 + (lane & 15)) * DW_LD + wj + 16 * pp +
                           (lane >> 4) * 8);
          b[2 * pp][0] = r[0]; b[2 * pp][1] = r[1];
          b[2 * pp + 1][0] = r[2]; b[2 * pp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; i++) {
          uint32_t af[4];
          ldsm_x4_t(af, SA + (k16 + (lane & 7) + ((lane >> 4) << 3)) * DW_LD +
                            wi + 16 * i + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int jn = 0; jn < 4; jn++) mma_bf16(acc[i][jn], af, b[jn][0], b[jn][1]);
        }
      }
  }
  cp_async_wait<0>();
#endif
  float *out = a.part_dw + ((size_t)s * (nh + 1) + g) * HID * HID;
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int h = 0; h < 2; h++)
#pragma unroll
      for (int jn = 0; jn < 4; jn++)
        st_f2(out + (size_t)(ib + wi + 16 * i + gq + 8 * h) * HID + jb + wj +
                  8 * jn + 2 * q,
              acc[i][jn][2 * h], acc[i][jn][2 * h + 1]);
}

// Phase 3: fixed-order sums of the partials into dW [L,512,256],
// db [L,256] and (when sums is given) the five loss sums. Every output
// element is written: padded rows and columns get exact zeros. The first
// n_dw threads take one dW element each (a sum over the S splits); after
// them one warp takes each sum over the tiles (the output layer's weight
// column, each bias, each loss sum): lane k adds tiles k, k + 32, ... in
// order, then the lanes combine in a fixed butterfly.
static __global__ void k_reduce(Args a, int n_tiles) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nh = a.L - 1;
  const long long n_dw = (long long)a.L * CATW * HID;
  if (idx < n_dw) {
    int l = (int)(idx / (CATW * HID));
    int i = (int)((idx / HID) % CATW);
    int j = (int)(idx % HID);
    if (l == nh && i < HID && j == 0) return;  // a tile sum, below
    float s = 0.f;
    if (l < nh) {
      int g = -1, ii = i;
      if (i < HID) g = l;
      else if (l == a.cat) { g = nh; ii = i - HID; }
      if (g >= 0)
        for (int k = 0; k < a.S; k++)
          s += a.part_dw[(((size_t)k * (nh + 1) + g) * HID + ii) * HID + j];
    }
    a.dW[idx] = s;
    return;
  }
  const long long w = (idx - n_dw) >> 5;  // the warp's tile sum
  const int lane = threadIdx.x & 31;
  const float *src;
  size_t stride;
  float *dst;
  if (w < HID) {  // output layer's weight column: dW[nh][w][0]
    src = a.part_dwout + w;
    stride = HID;
    dst = a.dW + ((size_t)nh * CATW + w) * HID;
  } else if (w < HID + (long long)a.L * HID) {
    const int k2 = (int)(w - HID), l = k2 / HID, j = k2 % HID;
    if (!(l < nh || j == 0)) {
      if (lane == 0) a.db[k2] = 0.f;
      return;
    }
    src = a.part_db + k2;
    stride = (size_t)a.L * HID;
    dst = a.db + k2;
  } else if (w < HID + (long long)a.L * HID + 5 && a.sums) {
    const int k3 = (int)(w - HID - (long long)a.L * HID);
    src = a.part_scal + k3;
    stride = 8;
    dst = a.sums + k3;
  } else {
    return;
  }
  float s = 0.f;
  for (int t = lane; t < n_tiles; t += 32) s += src[(size_t)t * stride];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) *dst = s;
}

// Lets a kernel take more than 48 KB of dynamic shared memory and asks for
// the largest shared-memory carveout, so that MIN_BLOCKS blocks fit an SM.
template <class K>
static inline void allow_smem(K kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
}

// Phases 2 and 3 on stream st; returns the cudaGetLastError() code.
static inline int launch_dw_reduce(const Args &a, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    allow_smem(k_dw, SMEM_DW);
    attr_set = true;
  }
  const int n_tiles = a.NP / TM;
  dim3 gdw((HID / DW_T) * (HID / DW_T), a.L, a.S);  // nh + 1 == L GEMMs
  k_dw<<<gdw, NTHR, SMEM_DW, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_sums = HID + (long long)a.L * HID + 5;
  const long long total = (long long)a.L * CATW * HID + 32 * n_sums;
  const int nb = (int)((total + 255) / 256);
  k_reduce<<<nb, 256, 0, st>>>(a, n_tiles);
  return (int)cudaGetLastError();
}
