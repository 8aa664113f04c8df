// Nearest valid surface point of every sample point, for the batch-distance
// (pc) bounds, on Hopper (sm_90a).
//
// Replaces the TPU kernel isdf_tpu/ops/pallas/bounds_pc.py::
// closest_surface_ix (body _kernel), with that function's inputs: points
// [M, 3], surf [R, 3] and valid [R] (bool, read as bytes; each with a row
// stride, so a strided view such as pc[:, 0] needs no copy). Per sample
// point p, the index of the surface point s that minimises bias_s - 2 p.s,
// with bias_s = |s|^2 for a valid surface point and +inf otherwise; the
// first index on equal scores, index 0 when every score is +inf
// (jnp.argmin's answer). The caller recomputes the exact distance at that
// index.
//
// The score is summed in a fixed order with __fmul_rn/__fadd_rn (no fused
// multiply-add): bias = (sx sx + sy sy) + sz sz, score = bias + ((x (-2 sx)
// + y (-2 sy)) + z (-2 sz)). The factor -2 is folded into the staged
// coordinates, which is exact (a power of two), so the score rounds as
// bias - 2 ((x sx + y sy) + z sz) does, and as the plain version in
// ops/cuda_bounds.py does: both take the same argmin.
//
// What bounds it on this card. 6 f32 operations and a compare per (point,
// surface) pair: at the trainer's 27,000 points and 1,000 surface points
// 0.19 G operations, 0.0028 ms at 67 TFLOP/s; the inputs and the output
// are under 1 MB. Without fused multiply-adds f32 issues at half that peak
// (one instruction a lane a clock), so the 6 operations of this exact
// order alone take about 2x the bound, and the selection issues beside
// them.
//
// What the design does about it: every instruction of the scan is spent on
// a pair, and every SM holds many independent chains.
//   * A block takes `points` sample points (k4_geometry in
//     ops/cuda_bounds.py picks the points a thread, PPT, so the grid fills
//     the 132 SMs in whole waves). Its threads form `splits` groups of
//     `lanes` threads; every group holds all of the block's points, PPT a
//     thread (independent chains), and scans its own contiguous share of
//     the surface set, ascending.
//   * The selection is one fminf a pair: a running minimum per chain, and
//     after each run of K4_RUN rows the run is recorded if it lowered the
//     minimum strictly, so the record is the run where the group's minimum
//     first occurs.
//   * Each block stages (-2 sx, -2 sy, -2 sz, bias) of up to K4_CHUNK
//     surface points in shared memory at a time, four rows a thread in
//     flight, the bias built there from surf and valid: one launch a call.
//     Every lane of a warp reads the same surface point, a broadcast.
//   * The groups' (minimum, run) pairs meet in shared memory. Per point,
//     in a fixed order: the first group with the smallest minimum wins (the
//     groups hold ascending shares, so its rows come first), and only its
//     recorded run is scored again (the same bits) for the first row equal
//     to the minimum: the first index of the minimum, as a strict `<` over
//     ascending rows gives. A later pass replaces a point's result only if
//     it is strictly smaller. No atomics, the same bits on every call.

#include <cuda_runtime.h>

#define K4_CHUNK 1024       // surface points staged per pass (16 KB)
#define K4_RUN 8            // rows a thread scans between two records
#define K4_MAX_THREADS 512
#define K4_INF __int_as_float(0x7f800000)

struct K4Args {
  const float *pts;
  const float *surf;
  const unsigned char *valid;
  long long *out;
  int M, R;
  int pts_stride, surf_stride, valid_stride;  // rows, in elements
  int splits, points, chunk;
};

// bias + ((x (-2 sx) + y (-2 sy)) + z (-2 sz)), q = (-2 sx, -2 sy, -2 sz,
// bias), each operation rounded on its own
__device__ __forceinline__ float k4_score(float x, float y, float z,
                                          float4 q) {
  return __fadd_rn(q.w, __fadd_rn(__fadd_rn(__fmul_rn(x, q.x),
                                            __fmul_rn(y, q.y)),
                                  __fmul_rn(z, q.z)));
}

template <int PPT>
__global__ void __launch_bounds__(K4_MAX_THREADS)
    k_closest_surface(const K4Args a) {
  extern __shared__ float4 smem[];
  float4 *s = smem;                                       // [chunk]
  // the groups' (minimum, run) pairs, [splits][points] each
  float *red_m = reinterpret_cast<float *>(smem + a.chunk);
  int *red_c = reinterpret_cast<int *>(red_m + a.splits * a.points);
  const int T = blockDim.x, tid = threadIdx.x;
  const int lanes = T / a.splits, split = tid / lanes, lane = tid % lanes;
  const int p0 = blockIdx.x * a.points;

  float x[PPT], y[PPT], z[PPT];
#pragma unroll
  for (int j = 0; j < PPT; j++) {
    const int p = p0 + lane + j * lanes;
    const float *q = a.pts + (long long)min(p, a.M - 1) * a.pts_stride;
    x[j] = q[0];
    y[j] = q[1];
    z[j] = q[2];
  }
  // the result so far of the points this thread merges, q = tid + i T
  float pb[PPT];
  int pi[PPT];
#pragma unroll
  for (int i = 0; i < PPT; i++) {
    pb[i] = K4_INF;
    pi[i] = 0;
  }

  for (int c0 = 0; c0 < a.R; c0 += a.chunk) {
    const int n = min(a.chunk, a.R - c0);
    __syncthreads();
    // stage (-2 sx, -2 sy, -2 sz, bias), four rows a thread in flight
    for (int k0 = tid; k0 < n; k0 += 4 * T) {
      float v[4][3];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; u++) {
        const int k = k0 + u * T;
        if (k < n) {
          const float *q = a.surf + (long long)(c0 + k) * a.surf_stride;
          v[u][0] = q[0];
          v[u][1] = q[1];
          v[u][2] = q[2];
          ok[u] = a.valid[(long long)(c0 + k) * a.valid_stride] != 0;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; u++) {
        const int k = k0 + u * T;
        if (k < n) {
          const float sx = v[u][0], sy = v[u][1], sz = v[u][2];
          const float b = __fadd_rn(
              __fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)),
              __fmul_rn(sz, sz));
          s[k] = make_float4(
              __fmul_rn(-2.f, sx), __fmul_rn(-2.f, sy), __fmul_rn(-2.f, sz),
              ok[u] ? b : K4_INF);
        }
      }
    }
    __syncthreads();
    // this group's share of the pass: rows [kb, ke), ascending. A running
    // minimum per chain; after each run of K4_RUN rows the run is recorded
    // if it lowered the minimum (strictly), so the last record is the run
    // where the group's minimum first occurs.
    const int rps = (n + a.splits - 1) / a.splits;
    const int kb = min(split * rps, n), ke = min(kb + rps, n);
    float m[PPT];
    int ck[PPT];
#pragma unroll
    for (int j = 0; j < PPT; j++) {
      m[j] = K4_INF;
      ck[j] = -1;
    }
    int k = kb;
    for (; k + K4_RUN <= ke; k += K4_RUN) {
      float mp[PPT];
#pragma unroll
      for (int j = 0; j < PPT; j++) mp[j] = m[j];
#pragma unroll
      for (int u = 0; u < K4_RUN; u++) {
        const float4 q = s[k + u];
#pragma unroll
        for (int j = 0; j < PPT; j++)
          m[j] = fminf(m[j], k4_score(x[j], y[j], z[j], q));
      }
#pragma unroll
      for (int j = 0; j < PPT; j++)
        if (m[j] < mp[j]) ck[j] = k;
    }
    if (k < ke) {  // the last, shorter run
      float mp[PPT];
#pragma unroll
      for (int j = 0; j < PPT; j++) mp[j] = m[j];
      for (int u = k; u < ke; u++) {
        const float4 q = s[u];
#pragma unroll
        for (int j = 0; j < PPT; j++)
          m[j] = fminf(m[j], k4_score(x[j], y[j], z[j], q));
      }
#pragma unroll
      for (int j = 0; j < PPT; j++)
        if (m[j] < mp[j]) ck[j] = k;
    }
#pragma unroll
    for (int j = 0; j < PPT; j++) {
      red_m[split * a.points + lane + j * lanes] = m[j];
      red_c[split * a.points + lane + j * lanes] = ck[j];
    }
    __syncthreads();
    // per point, across groups in their (ascending) order: the first group
    // with the smallest minimum; if it lowers the result of the earlier
    // passes (strictly), its recorded run is scored again (the same bits)
    // for the first row equal to the minimum.
#pragma unroll
    for (int i = 0; i < PPT; i++) {
      const int q = tid + i * T;
      if (q >= a.points) break;
      float b = red_m[q];
      int gw = 0;
      for (int g = 1; g < a.splits; g++) {
        const float mg = red_m[g * a.points + q];
        if (mg < b) {
          b = mg;
          gw = g;
        }
      }
      if (b < pb[i]) {
        const int c = red_c[gw * a.points + q];
        const int ue = min(c + K4_RUN, min(min(gw * rps, n) + rps, n));
        const float *pt =
            a.pts + (long long)min(p0 + q, a.M - 1) * a.pts_stride;
        const float px = pt[0], py = pt[1], pz = pt[2];
        for (int u = c; u < ue; u++) {
          if (k4_score(px, py, pz, s[u]) == b) {
            pi[i] = c0 + u;
            break;
          }
        }
        pb[i] = b;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; i++) {
    const int q = tid + i * T;
    if (q < a.points && p0 + q < a.M) a.out[p0 + q] = pi[i];
  }
}

template <int PPT>
static void launch(const K4Args &a, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  k_closest_surface<PPT><<<blocks, threads, smem, stream>>>(a);
}

// ptrs: pts, surf (f32), valid (bytes), out [M] (int64); ints: M, R,
// pts_stride, surf_stride, valid_stride, threads, splits, ppt, points,
// chunk, blocks, smem bytes (k4_geometry). Returns the cudaGetLastError()
// code after the launch.
extern "C" int isdf_closest_surface(const long long *ptrs, const float *knobs,
                                    const int *ints, void *stream) {
  (void)knobs;
  K4Args a;
  a.pts = reinterpret_cast<const float *>(ptrs[0]);
  a.surf = reinterpret_cast<const float *>(ptrs[1]);
  a.valid = reinterpret_cast<const unsigned char *>(ptrs[2]);
  a.out = reinterpret_cast<long long *>(ptrs[3]);
  a.M = ints[0];
  a.R = ints[1];
  a.pts_stride = ints[2];
  a.surf_stride = ints[3];
  a.valid_stride = ints[4];
  const int threads = ints[5];
  a.splits = ints[6];
  const int ppt = ints[7];
  a.points = ints[8];
  a.chunk = ints[9];
  const int blocks = ints[10], smem = ints[11];
  if (threads > K4_MAX_THREADS || threads % a.splits != 0 ||
      a.points != threads / a.splits * ppt || a.chunk > K4_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (ppt) {
    case 1: launch<1>(a, blocks, threads, smem, st); break;
    case 2: launch<2>(a, blocks, threads, smem, st); break;
    case 3: launch<3>(a, blocks, threads, smem, st); break;
    case 4: launch<4>(a, blocks, threads, smem, st); break;
    case 5: launch<5>(a, blocks, threads, smem, st); break;
    case 6: launch<6>(a, blocks, threads, smem, st); break;
    case 7: launch<7>(a, blocks, threads, smem, st); break;
    case 8: launch<8>(a, blocks, threads, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
