// Nearest valid surface point of every sample point, for the batch-distance
// (pc) bounds, on Hopper (sm_90a).
//
// Replaces the TPU kernel isdf_tpu/ops/pallas/bounds_pc.py::
// closest_surface_ix (body _kernel): per sample point p, the index of the
// surface point s that minimises bias_s - 2 p.s, with bias_s = |s|^2 for a
// valid surface point and +inf otherwise; the first index on equal scores,
// index 0 when every score is +inf (jnp.argmin's answer). The caller
// recomputes the exact distance at that index.
//
// The score is summed in a fixed order with __fmul_rn/__fadd_rn/__fsub_rn
// (no fused multiply-add), so it rounds exactly as the plain version in
// ops/cuda_bounds.py does and both take the same argmin.
//
// What bounds it on this card. 7 f32 operations per (point, surface) pair:
// at the trainer's 27,000 points and 1,000 surface points 0.19 GFLOP,
// 0.003 ms at 67 TFLOP/s; the inputs and the output are under 1 MB. At that
// size the launch itself dominates.
//
// What the design does about it: one thread per sample point, the surface
// set staged in shared memory as (x, y, z, bias) in chunks of 2,048 points
// (32 KB); every lane of a warp reads the same surface point, a broadcast.

#include <cuda_runtime.h>

#define K4_THREADS 128
#define K4_CHUNK 2048

__global__ void __launch_bounds__(K4_THREADS)
    k_closest_surface(const float *pts, const float *surf, const float *bias,
                      int M, int R, long long *out) {
  __shared__ float4 s[K4_CHUNK];
  const int i = blockIdx.x * K4_THREADS + threadIdx.x;
  float x = 0.f, y = 0.f, z = 0.f;
  if (i < M) { x = pts[3 * i]; y = pts[3 * i + 1]; z = pts[3 * i + 2]; }
  float best = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  for (int c0 = 0; c0 < R; c0 += K4_CHUNK) {
    const int n = min(K4_CHUNK, R - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += K4_THREADS) {
      const int q = c0 + k;
      s[k] = make_float4(surf[3 * q], surf[3 * q + 1], surf[3 * q + 2],
                         bias[q]);
    }
    __syncthreads();
    for (int k = 0; k < n; k++) {
      const float4 q = s[k];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(x, q.x), __fmul_rn(y, q.y)),
                                  __fmul_rn(z, q.z));
      const float sc = __fsub_rn(q.w, __fmul_rn(2.f, dot));
      if (sc < best) { best = sc; bi = c0 + k; }
    }
  }
  if (i < M) out[i] = bi;
}

// ptrs: pts [M, 3], surf [R, 3], bias [R] (f32), out [M] (int64);
// ints: M, R. Returns the cudaGetLastError() code after the launch.
extern "C" int isdf_closest_surface(const long long *ptrs, const float *knobs,
                                    const int *ints, void *stream) {
  (void)knobs;
  const int M = ints[0], R = ints[1];
  const int nb = (M + K4_THREADS - 1) / K4_THREADS;
  k_closest_surface<<<nb, K4_THREADS, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float *>(ptrs[0]),
      reinterpret_cast<const float *>(ptrs[1]),
      reinterpret_cast<const float *>(ptrs[2]), M, R,
      reinterpret_cast<long long *>(ptrs[3]));
  return (int)cudaGetLastError();
}
