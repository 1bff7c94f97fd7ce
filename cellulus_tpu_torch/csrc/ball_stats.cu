// Mean shift for Hopper (sm_90a): the ball statistics of one iteration, and
// the whole fit in one launch. For S seeds c and N points x in d <= 8
// dimensions:
//
//   counts[s] = #{ n : valid[n] and d2(s, n) <= bw2 }      (inclusive)
//   sums[s]   = sum of x[n] over the same n
//   d2(s, n)  = (c_norm[s] + x_norm[n]) - 2 * sum_k c[s][k] * x[n][k]
//
// Replaces: cellulus_tpu/ops/pallas_mean_shift.py `_kernel` /
// `ball_stats_padded` (a (seed tile, point chunk) grid whose point axis
// accumulates sequentially in VMEM), and, with `mean_shift_fit`, the loop
// around it: cellulus_tpu/ops/mean_shift.py `_fit_impl` (a
// `jax.lax.while_loop` of `_make_step`) plus the recount of
// `_finalize_impl`.
//
// What bounds it on the H100: operations, in f32 on the CUDA cores (the
// tensor cores do not serve: K is d <= 8, and TF32 would move points across
// the inclusive boundary). Each live (seed, point) pair costs about 2d + 4
// FLOP, plus d + 1 adds when the point lies in the ball. The distance is
// computed with explicitly rounded operations (and the file builds with
// --fmad=false): contracting it into FMAs would move points that lie on the
// sphere across the inclusive boundary.
//
// ball_stats_kernel (one iteration): a block owns kSeeds seeds and walks all
// N points, its threads striding over points, so the sequential grid axis of
// the TPU kernel becomes a loop inside the block; counts and sums stay in
// registers and are reduced across the block in a fixed order (warp
// butterfly, then warps in index order), so the result needs no atomics.
//
// mean_shift_fit_kernel (the whole fit): launched as clusters of kCluster
// blocks. Each block keeps a fixed share of the points in shared memory for
// the whole fit (as much of it as fits; the rest is read from L2 every
// iteration), so the points are loaded once per fit and not once per
// iteration. A cluster owns a group of up to G seeds and loops on the device
// until every seed of the group has halted (or max_iter), then recounts its
// never-frozen seeds and takes the next group: a persistent grid of clusters
// walks the groups. Halted seeds cost nothing. Per iteration each block
// reduces its partial (count, sums) per live seed into its own shared memory;
// after one cluster barrier every block reads all ranks' partials through
// distributed shared memory in rank order, so every block computes the same
// new centers and nothing is broadcast. Partials are double-buffered, so one
// barrier per iteration is enough. No atomics: two launches give the same
// bits.
//
// The order of a seed's sum depends only on N and the launch shape
// (kCluster, kFitThreads), never on S or on which seeds share its group:
//   1. block r of the cluster owns points [r * share, min((r + 1) * share, N)),
//      share = ceil(N / kCluster);
//   2. thread t of the block adds, in increasing j, the points of local index
//      t + j * kFitThreads that lie in the ball, into a register that starts
//      at 0 (counts: +1 per point; sums: + x[n][k]);
//   3. each warp reduces by butterfly: v += shfl_xor(v, m) for m = 16, 8, 4,
//      2, 1 (lane 0's value is kept);
//   4. the block sums its warps in index order, starting from warp 0's value;
//   5. every block sums the ranks' partials in rank order, starting from
//      rank 0's.
// Because of that, a group may leave its loop as soon as its own seeds have
// halted, and the results equal those of one global loop over all seeds
// (tests/mean_shift_fit_emu.py emulates this order in numpy).
//
// The step per live seed is cellulus_tpu/ops/mean_shift.py `_make_step`:
// means = sums / max(count, 1); shift = sqrt of the sum of squared
// differences in index order; the seed freezes on an empty ball or
// shift < stop (recording its count); an exact period-2 cycle
// (new == prev) jumps to the phase it would hold at max_iter and halts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---- the whole fit -------------------------------------------------------

constexpr int kCluster = 8;
constexpr int kFitThreads = 256;
constexpr int kFitWarps = kFitThreads / 32;
// shared memory a block may give to its resident points (the rest of the
// 227 KB holds the per-group state)
constexpr int kPointBytes = 200 * 1024;
constexpr uint8_t kFrozen = 1, kHalted = 2;

// most seeds a group holds: their accumulators live in registers
template <int D>
struct MaxGroup {
  static constexpr int value = D <= 3 ? 16 : 8;
};

struct FitPlan {
  int group;      // seeds per group
  int clusters;   // clusters in the grid
  int resident;   // points of a block's share held in shared memory
  int smem;       // dynamic shared memory per block, bytes
};

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

template <int D>
__global__ void __launch_bounds__(kFitThreads, 1)
mean_shift_fit_kernel(const float* __restrict__ seeds, const float* __restrict__ x,
                      const float* __restrict__ x_norm, const uint8_t* __restrict__ valid,
                      float bw2, float stop, int max_iter, int S, int N, int resident,
                      int group, float* __restrict__ centers_out,
                      float* __restrict__ n_final_out, uint8_t* __restrict__ frozen_out,
                      int* __restrict__ n_iter_out) {
  constexpr int GM = MaxGroup<D>::value;
  constexpr int V = D + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cluster_id = blockIdx.x / kCluster;
  const int n_clusters = gridDim.x / kCluster;
  const int n_groups = (S + group - 1) / group;

  // resident points, by coordinate: pts[k * resident + i], then |x|^2 (inf
  // for an invalid point, which no ball then holds) at pts[D * resident + i]
  extern __shared__ float pts[];
  __shared__ float c[GM][D], prev[GM][D];
  __shared__ float red[kFitWarps][GM * V];
  __shared__ float part[2][GM * V];
  __shared__ float tot[GM * V];
  __shared__ float nfin[GM];
  __shared__ int niter[GM];
  __shared__ uint8_t flags[GM];

  const int share = (N + kCluster - 1) / kCluster;
  const int begin = min(N, rank * share);
  const int len = min(N, begin + share) - begin;
  const int held = min(len, resident);
  for (int i = threadIdx.x; i < held; i += kFitThreads) {
    const int n = begin + i;
#pragma unroll
    for (int k = 0; k < D; ++k) pts[k * resident + i] = x[(size_t)n * D + k];
    pts[D * resident + i] = valid[n] ? x_norm[n] : f32_inf();
  }
  // every block of the cluster runs (distributed shared memory may be read)
  // and holds its points
  cluster.sync();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int buf = 0;
  for (int g = cluster_id; g < n_groups; g += n_clusters) {
    const int s0 = g * group;
    const int gs = min(group, S - s0);
    for (int i = threadIdx.x; i < GM * D; i += kFitThreads) {
      const int s = i / D, k = i % D;
      c[s][k] = s < gs ? seeds[(size_t)(s0 + s) * D + k] : 0.f;
      prev[s][k] = f32_inf();
    }
    for (int s = threadIdx.x; s < GM; s += kFitThreads) {
      nfin[s] = 0.f;
      niter[s] = 0;
      flags[s] = s < gs ? 0 : (kFrozen | kHalted);
    }
    __syncthreads();

    for (int it = 0;; ++it) {
      // the seeds of this pass: the live ones, or after the loop the
      // recount of the never-frozen ones (identical in every block)
      unsigned live = 0, unfrozen = 0;
#pragma unroll
      for (int s = 0; s < GM; ++s) {
        if (!(flags[s] & kHalted)) live |= 1u << s;
        if (!(flags[s] & kFrozen)) unfrozen |= 1u << s;
      }
      const bool recount = it >= max_iter || live == 0;
      const unsigned mask = recount ? unfrozen : live;
      if (mask == 0) break;

      float cs[GM][D], cn[GM], acc[GM][V];
#pragma unroll
      for (int s = 0; s < GM; ++s) {
#pragma unroll
        for (int k = 0; k < D; ++k) cs[s][k] = c[s][k];
        cn[s] = __fmul_rn(cs[s][0], cs[s][0]);
#pragma unroll
        for (int k = 1; k < D; ++k) cn[s] = __fadd_rn(cn[s], __fmul_rn(cs[s][k], cs[s][k]));
#pragma unroll
        for (int k = 0; k < V; ++k) acc[s][k] = 0.f;
      }

      for (int i = threadIdx.x; i < len; i += kFitThreads) {
        float xv[D], xn;
        if (i < held) {
#pragma unroll
          for (int k = 0; k < D; ++k) xv[k] = pts[k * resident + i];
          xn = pts[D * resident + i];
        } else {
          const int n = begin + i;
#pragma unroll
          for (int k = 0; k < D; ++k) xv[k] = x[(size_t)n * D + k];
          xn = valid[n] ? x_norm[n] : f32_inf();
        }
#pragma unroll
        for (int s = 0; s < GM; ++s) {
          if (!(mask >> s & 1u)) continue;
          float cross = __fmul_rn(cs[s][0], xv[0]);
#pragma unroll
          for (int k = 1; k < D; ++k) cross = __fadd_rn(cross, __fmul_rn(cs[s][k], xv[k]));
          const float d2 = __fsub_rn(__fadd_rn(cn[s], xn), __fmul_rn(2.f, cross));
          if (d2 <= bw2) {
            acc[s][0] = __fadd_rn(acc[s][0], 1.f);
#pragma unroll
            for (int k = 0; k < D; ++k) acc[s][1 + k] = __fadd_rn(acc[s][1 + k], xv[k]);
          }
        }
      }

#pragma unroll
      for (int s = 0; s < GM; ++s) {
        if (!(mask >> s & 1u)) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float v = acc[s][k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
          if (lane == 0) red[warp][s * V + k] = v;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < GM * V; i += kFitThreads) {
        if (!(mask >> (i / V) & 1u)) continue;
        float t = red[0][i];
        for (int w = 1; w < kFitWarps; ++w) t = __fadd_rn(t, red[w][i]);
        part[buf][i] = t;
      }
      cluster.sync();
      for (int i = threadIdx.x; i < GM * V; i += kFitThreads) {
        if (!(mask >> (i / V) & 1u)) continue;
        float t = *cluster.map_shared_rank(&part[buf][i], 0);
        for (int r = 1; r < kCluster; ++r) t = __fadd_rn(t, *cluster.map_shared_rank(&part[buf][i], r));
        tot[i] = t;
      }
      buf ^= 1;
      __syncthreads();

      if (recount) {
        if (threadIdx.x < GM && (mask >> threadIdx.x & 1u)) nfin[threadIdx.x] = tot[threadIdx.x * V];
        __syncthreads();
        break;
      }
      if (threadIdx.x < GM && (mask >> threadIdx.x & 1u)) {
        const int s = threadIdx.x;
        const float count = tot[s * V];
        const float denom = fmaxf(count, 1.f);
        float mean[D], ss = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          mean[k] = __fdiv_rn(tot[s * V + 1 + k], denom);
          const float diff = __fsub_rn(mean[k], c[s][k]);
          const float sq = __fmul_rn(diff, diff);
          ss = k == 0 ? sq : __fadd_rn(ss, sq);
        }
        const bool empty = count == 0.f;
        const bool done = empty || __fsqrt_rn(ss) < stop;
        float next[D];
        bool same = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          next[k] = empty ? c[s][k] : mean[k];
          same = same && next[k] == prev[s][k];
        }
        // exact period-2 cycle: move to the phase held at max_iter and halt
        const bool cycle = same && !done;
        if (cycle && (max_iter - (it + 1)) % 2 != 0) {
#pragma unroll
          for (int k = 0; k < D; ++k) next[k] = c[s][k];
        }
        nfin[s] = count;  // a live seed is never frozen
        flags[s] = done ? (kFrozen | kHalted) : (cycle ? kHalted : 0);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          prev[s][k] = c[s][k];
          c[s][k] = next[k];
        }
        niter[s] = it + 1;
      }
      __syncthreads();
    }

    if (rank == 0) {
      for (int i = threadIdx.x; i < gs * D; i += kFitThreads)
        centers_out[(size_t)s0 * D + i] = c[i / D][i % D];
      for (int s = threadIdx.x; s < gs; s += kFitThreads) {
        n_final_out[s0 + s] = nfin[s];
        frozen_out[s0 + s] = flags[s] & kFrozen ? 1 : 0;
        n_iter_out[s0 + s] = niter[s];
      }
    }
    __syncthreads();  // the next group overwrites the state
  }
  // no block leaves while another may still read its partials
  cluster.sync();
}

cudaLaunchConfig_t fit_config(int smem, int clusters, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * clusters);
  cfg.blockDim = dim3(kFitThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Seeds per group and clusters in the grid: as many clusters as the card
// holds at once, and groups small enough that S seeds give every cluster a
// group (capped by the registers a group's accumulators take). Neither
// changes a seed's arithmetic.
template <int D>
int fit_plan(int S, int N, FitPlan* p) {
  const int share = (N + kCluster - 1) / kCluster;
  const int cap = kPointBytes / ((D + 1) * 4) / kFitThreads * kFitThreads;
  p->resident = share < cap ? share : cap;
  p->smem = p->resident * (D + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(mean_shift_fit_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fit_config(p->smem, 1, 0, &attr);
  int max_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&max_clusters, mean_shift_fit_kernel<D>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (max_clusters < 1) return (int)cudaErrorInvalidConfiguration;
  int group = (S + max_clusters - 1) / max_clusters;
  group = group < 1 ? 1 : (group > MaxGroup<D>::value ? MaxGroup<D>::value : group);
  const int groups = (S + group - 1) / group;
  p->group = group;
  p->clusters = groups < max_clusters ? groups : max_clusters;
  return 0;
}

template <int D>
int plan_out(int S, int N, int* out) {
  FitPlan p;
  const int rc = fit_plan<D>(S, N, &p);
  if (rc != 0) return rc;
  out[0] = p.group;
  out[1] = p.clusters;
  out[2] = p.resident;
  out[3] = p.smem;
  return 0;
}

template <int D>
int fit_launch(const float* seeds, const float* x, const float* x_norm, const uint8_t* valid,
               float bw2, float stop, int max_iter, int S, int N, float* centers,
               float* n_final, uint8_t* frozen, int* n_iter, cudaStream_t stream) {
  FitPlan p;
  const int rc = fit_plan<D>(S, N, &p);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fit_config(p.smem, p.clusters, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, mean_shift_fit_kernel<D>, seeds, x, x_norm, valid,
                                       bw2, stop, max_iter, S, N, p.resident, p.group, centers,
                                       n_final, frozen, n_iter);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dispatch on d = 1..8 to CALL(D), a launch of the template for D
#define CELLULUS_FOR_EACH_DIM(d, CALL)          \
  switch (d) {                                  \
    case 1: return CALL(1);                     \
    case 2: return CALL(2);                     \
    case 3: return CALL(3);                     \
    case 4: return CALL(4);                     \
    case 5: return CALL(5);                     \
    case 6: return CALL(6);                     \
    case 7: return CALL(7);                     \
    case 8: return CALL(8);                     \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// All pointers are device pointers to contiguous f32 (valid: one byte per
// point, 0 or 1). Returns the CUDA error code (0 = ok).
int ball_stats_launch(const void* c, const void* c_norm, const void* x, const void* x_norm,
                      const void* valid, float bw2, int S, int N, int d, void* counts,
                      void* sums, void* stream) {
  if (S <= 0) return 0;
#define CALL(D)                                                                          \
  launch<D>((const float*)c, (const float*)c_norm, (const float*)x, (const float*)x_norm, \
            (const uint8_t*)valid, bw2, S, N, (float*)counts, (float*)sums, (cudaStream_t)stream)
  CELLULUS_FOR_EACH_DIM(d, CALL)
#undef CALL
}

// The whole mean-shift fit: seeds (S, d), points x (N, d), x_norm (N,),
// valid (N,) bytes; out centers (S, d) f32, n_final (S,) f32, frozen (S,)
// bytes, n_iter (S,) int32. `cluster` must be the compiled cluster size.
int mean_shift_fit_launch(const void* seeds, const void* x, const void* x_norm,
                          const void* valid, float bw2, float stop, int max_iter, int S, int N,
                          int d, int cluster, void* centers, void* n_final, void* frozen,
                          void* n_iter, void* stream) {
  if (cluster != kCluster) return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
#define CALL(D)                                                                                \
  fit_launch<D>((const float*)seeds, (const float*)x, (const float*)x_norm,                    \
                (const uint8_t*)valid, bw2, stop, max_iter, S, N, (float*)centers,             \
                (float*)n_final, (uint8_t*)frozen, (int*)n_iter, (cudaStream_t)stream)
  CELLULUS_FOR_EACH_DIM(d, CALL)
#undef CALL
}

// The launch plan the fit takes for (S, N, d): out[0..3] = seeds per group,
// clusters, resident points per block, dynamic shared memory bytes.
int mean_shift_fit_plan(int S, int N, int d, void* out) {
#define CALL(D) plan_out<D>(S > 0 ? S : 1, N, (int*)out)
  CELLULUS_FOR_EACH_DIM(d, CALL)
#undef CALL
}

}  // extern "C"
