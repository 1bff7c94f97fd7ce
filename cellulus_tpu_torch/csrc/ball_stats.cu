// Mean-shift ball statistics for Hopper (sm_90a). For S seeds c and N
// points x in d <= 8 dimensions:
//
//   counts[s] = #{ n : valid[n] and d2(s, n) <= bw2 }      (inclusive)
//   sums[s]   = sum of x[n] over the same n
//   d2(s, n)  = (c_norm[s] + x_norm[n]) - 2 * sum_k c[s][k] * x[n][k]
//
// Replaces: cellulus_tpu/ops/pallas_mean_shift.py `_kernel` /
// `ball_stats_padded` (a (seed tile, point chunk) grid whose point axis
// accumulates sequentially in VMEM).
//
// What bounds it on the H100: operations, in f32 on the CUDA cores. Each
// (seed, point) pair costs about 3d + 3 FLOP against d + 2 floats read per
// point per block, and the points stay in L2 (N * 16 bytes at d = 2). The
// least time is the pair work over the f32 peak; at the fit's sizes (a few
// hundred seeds, ~10^4 points) the launch itself is of the same order.
//
// What the design does about it: a block owns kSeeds seeds and walks all
// N points, its threads striding over points, so the sequential grid axis
// of the TPU kernel becomes a loop inside the block; counts and sums stay
// in registers and are reduced across the block in a fixed order (warp
// butterfly, then warps in index order), so the result is deterministic
// and needs no atomics. The distance is computed with explicitly rounded
// operations in the plain version's order: contracting it into FMAs would
// move points that lie on the sphere across the inclusive boundary.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeeds = 8;

template <int D>
__global__ void __launch_bounds__(kThreads)
ball_stats_kernel(const float* __restrict__ c, const float* __restrict__ c_norm,
                  const float* __restrict__ x, const float* __restrict__ x_norm,
                  const uint8_t* __restrict__ valid, float bw2, int S, int N,
                  float* __restrict__ counts, float* __restrict__ sums) {
  constexpr int V = D + 1;  // count + d sums per seed
  __shared__ float sc[kSeeds][D];
  __shared__ float scn[kSeeds];
  __shared__ float red[kWarps][kSeeds * V];

  const int s0 = blockIdx.x * kSeeds;
  for (int i = threadIdx.x; i < kSeeds * D; i += kThreads) {
    const int s = s0 + i / D;
    sc[i / D][i % D] = s < S ? c[(size_t)s * D + i % D] : 0.f;
  }
  for (int i = threadIdx.x; i < kSeeds; i += kThreads) scn[i] = s0 + i < S ? c_norm[s0 + i] : 0.f;
  __syncthreads();

  float acc[kSeeds][V];
#pragma unroll
  for (int s = 0; s < kSeeds; ++s)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[s][k] = 0.f;

  for (int n = threadIdx.x; n < N; n += kThreads) {
    if (!valid[n]) continue;
    float xv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = x[(size_t)n * D + k];
    const float xn = x_norm[n];
#pragma unroll
    for (int s = 0; s < kSeeds; ++s) {
      float cross = __fmul_rn(sc[s][0], xv[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) cross = __fadd_rn(cross, __fmul_rn(sc[s][k], xv[k]));
      const float d2 = __fsub_rn(__fadd_rn(scn[s], xn), __fmul_rn(2.f, cross));
      if (d2 <= bw2) {
        acc[s][0] += 1.f;
#pragma unroll
        for (int k = 0; k < D; ++k) acc[s][1 + k] += xv[k];
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kSeeds; ++s)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = acc[s][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][s * V + k] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < kSeeds * V; i += kThreads) {
    const int s = s0 + i / V, k = i % V;
    if (s >= S) continue;
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += red[w][i];
    if (k == 0)
      counts[s] = total;
    else
      sums[(size_t)s * D + k - 1] = total;
  }
}

template <int D>
int launch(const float* c, const float* c_norm, const float* x, const float* x_norm,
           const uint8_t* valid, float bw2, int S, int N, float* counts, float* sums,
           cudaStream_t stream) {
  const int blocks = (S + kSeeds - 1) / kSeeds;
  ball_stats_kernel<D><<<blocks, kThreads, 0, stream>>>(c, c_norm, x, x_norm, valid, bw2, S, N,
                                                          counts, sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous f32 (valid: one byte per
// point, 0 or 1). Returns the CUDA error code (0 = ok).
int ball_stats_launch(const void* c, const void* c_norm, const void* x, const void* x_norm,
                      const void* valid, float bw2, int S, int N, int d, void* counts,
                      void* sums, void* stream) {
  if (S <= 0) return 0;
  const float* cf = (const float*)c;
  const float* cn = (const float*)c_norm;
  const float* xf = (const float*)x;
  const float* xn = (const float*)x_norm;
  const uint8_t* v = (const uint8_t*)valid;
  float* co = (float*)counts;
  float* so = (float*)sums;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch<1>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 2: return launch<2>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 3: return launch<3>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 4: return launch<4>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 5: return launch<5>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 6: return launch<6>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 7: return launch<7>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    case 8: return launch<8>(cf, cn, xf, xn, v, bw2, S, N, co, so, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
