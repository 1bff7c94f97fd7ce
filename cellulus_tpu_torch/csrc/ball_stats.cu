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
// mean_shift_fit_kernel (the whole fit and recount in one launch), its
// design:
// - Clusters of C blocks of T threads (the plan below, a function of N and
//   d alone). Each block keeps a fixed share of the points for the whole
//   fit: the launch first lays the points out as d + 1 rows (each
//   coordinate, then |x|^2, +inf where a point is invalid or padding), and
//   each block copies its share of every row into shared memory with one
//   bulk copy (cp.async.bulk on an mbarrier), as much of it as fits; the
//   rest is read from L2 every iteration.
// - A cluster holds M seed slots. Every iteration each block computes the
//   partial (count, sums) of every held seed over its share; a slot whose
//   seed froze, or halted unfrozen and was recounted, takes the cluster's
//   next seed at the next iteration (cluster k takes seeds k, k + K, k + 2K,
//   ... of the K clusters in the grid, as slots free): halted seeds cost
//   nothing and no slot waits for a group's slowest seed. Each seed counts
//   its own iterations (max_iter, n_iter and the period-2 cycle's phase use
//   that count), so a seed that enters late behaves as in the global loop.
//   The held seeds are packed by position (their rank among the held slots)
//   and walked in passes of 8 (4 or 2 at larger d), then 4, 2, 1: a pass
//   computes exactly its seeds, its points' loop unrolled where few seeds
//   leave it bound by latency.
// - Partials meet without a cluster barrier in the loop: each warp reduces
//   its threads' partials by the butterfly's tree (for more than 8 values run
//   as a reduce-scatter, each step handing half the values to the partner
//   lane), one named barrier, then warp 0 sums the warps in index order and
//   pushes the block's partials into this rank's slot of every other rank's
//   receive buffer with st.async, which completes on the receiving rank's
//   mbarrier (its own slot: plain stores). Each rank waits on its own
//   mbarrier only (parity from the iteration), sums the ranks' partials in
//   rank order and updates the slots itself, so every rank computes the same
//   centers and nothing is broadcast. Receive buffers alternate by iteration
//   parity: a rank pushes iteration i + 1 only after it has read i, and
//   cannot pass the wait of i + 2 before every rank has pushed i + 1. One
//   cluster.sync() before the first push (every rank's barriers initialized
//   and armed), one before exit. No atomics: two launches give the same
//   bits.
// - Slot state lives in warp 0's registers (lane m holds slot m; the next
//   seeds' coordinates are loaded a pass ahead), and the held centers and
//   |c|^2 go to shared memory for the other warps: two block barriers an
//   iteration. Registers are held to 128 a thread, so two blocks share an SM
//   where their shares fit its shared memory.

// The order contract: a seed's sums depend only on N, d and the launch plan,
// which is itself a function of (N, d) alone; never on S, on which cluster
// or slot ran the seed, or on when it ran:
//   1. block r of the cluster owns points [r * share, min((r + 1) * share, N)),
//      share = ceil(N / C) rounded up to a multiple of 4;
//   2. thread t of the block adds, in increasing j, the points of local index
//      t + j * T that lie in the ball, into a register that starts at 0
//      (counts: +1 per point; sums: + x[n][k]);
//   3. each warp reduces by the butterfly's tree: pairs of lanes that differ
//      in bit 4 of the lane index, then bit 3, .. bit 0;
//   4. the block sums its warps in index order, starting from warp 0's value;
//   5. every block sums the ranks' partials in rank order, starting from
//      rank 0's.
// Because of that, the results equal those of one global loop over all
// seeds in any order of claims (tests/mean_shift_fit_emu.py emulates this
// order in numpy, its cluster size and threads from ops/mean_shift_fit.py's
// mirror of the plan).
//
// Its bound: 2d + 4 operations per live (seed, point) pair plus d + 1 adds
// per point in a ball, over the CUDA cores' 67 TFLOP/s. That rate counts
// fused multiply-adds as two; under --fmad=false every operation is its own
// instruction, so the reachable floor is about twice the bound.
//
// The step per live seed is cellulus_tpu/ops/mean_shift.py `_make_step`:
// means = sums / max(count, 1); shift = sqrt of the sum of squared
// differences in index order; the seed freezes on an empty ball or
// shift < stop (recording its count); an exact period-2 cycle
// (new == prev) jumps to the phase it would hold at max_iter and halts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "wgmma.cuh"

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

// ---- K3 plan begin: plain C++ (the CPU tests build it with g++) ----------
// The launch plan of a fit over N points in d dimensions, a function of
// (N, d) alone (ops/mean_shift_fit.py mirrors it): 128 threads a block where
// kMaxCluster blocks of them cover N at kPointsPerThread points a thread,
// else kFitThreads; the cluster doubled from 1 until a thread's points an
// iteration are at most kPointsPerThread (or the cluster is kMaxCluster
// blocks); each block's share of the points a multiple of 4 (its rows start
// 16-byte aligned for the bulk copy), as much of it resident in shared
// memory as kPointBytes holds (a block whose share needs more than half an
// SM's shared memory runs alone on its SM).
constexpr int kFitThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kPointsPerThread = 16;
constexpr int kPointBytes = 200 * 1024;

struct FitPlan {
  int cluster;   // blocks per cluster
  int threads;   // threads per block
  int slots;     // seed slots per cluster
  int share;     // points per block (the last blocks padded)
  int resident;  // points of the share held in shared memory
  int smem;      // dynamic shared memory per block, bytes
};

inline int fit_slots(int d) { return d <= 3 ? 16 : 8; }
inline int fit_share(int N, int cluster) {
  const int share = ((N + cluster - 1) / cluster + 3) / 4 * 4;
  return share < 4 ? 4 : share;
}
inline int fit_resident(int share, int d) {
  const int cap = kPointBytes / (4 * (d + 1)) / 4 * 4;
  return share < cap ? share : cap;
}
// the ranks' partials (two iterations' worth), the warps' partials, the
// resident points' d + 1 rows
inline int fit_smem_bytes(int d, int cluster, int threads, int resident) {
  const int values = fit_slots(d) * (d + 1);
  return 4 * (2 * cluster * values + threads / 32 * values + (d + 1) * resident);
}
inline FitPlan fit_plan_for(int N, int d) {
  FitPlan p;
  p.threads = N <= kMaxCluster * 128 * kPointsPerThread ? 128 : kFitThreads;
  p.cluster = 1;
  while (p.cluster < kMaxCluster &&
         (N + p.cluster * p.threads - 1) / (p.cluster * p.threads) > kPointsPerThread)
    p.cluster *= 2;
  p.slots = fit_slots(d);
  p.share = fit_share(N, p.cluster);
  p.resident = fit_resident(p.share, d);
  p.smem = fit_smem_bytes(d, p.cluster, p.threads, p.resident);
  return p;
}
// ---- K3 plan end ---------------------------------------------------------

template <int D>
struct FitShape {
  static constexpr int V = D + 1;                          // count + d sums
  static constexpr int M = D <= 3 ? 16 : 8;                // seed slots (fit_slots)
  static constexpr int K = M * V;                          // a block's partials
  static constexpr int SC = D <= 3 ? 8 : (D <= 7 ? 4 : 2);  // most seeds a pass over the points
  static_assert(K % 4 == 0 && K / 4 <= 32 && M % SC == 0 && M <= 32, "fit shape");
};

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// the address of shared-memory address `local` in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}
// 16 bytes into (another) block's shared memory, completing on its mbarrier
__device__ __forceinline__ void st_async_v4(uint32_t addr, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done != 0;
}
// wait for the phase of parity `parity`, acquiring what the cluster's
// st.async wrote; a wait of 4 s can only be a fault: trap
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = wg::smem_u32(bar);
  if (mbar_try_wait_cluster(a, parity)) return;
  const uint64_t t0 = wg::global_ns();
  while (!mbar_try_wait_cluster(a, parity))
    if (wg::global_ns() - t0 > 4000000000ull) __trap();
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One step of the warp's reduce-scatter: lanes that differ in bit `m` sum
// their values pairwise, each keeping half of them (the upper half where
// the bit is set). After the steps m = 16 .. 1, lane l holds values
// R l .. R l + R - 1, each the butterfly's tree sum over the 32 lanes.
template <int H, int P>
__device__ __forceinline__ void rs_step(float (&a)[P], int lane, int m) {
  const bool up = (lane & m) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? a[i] : a[i + H];
    const float keep = up ? a[i + H] : a[i];
    a[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m));
  }
}
template <int P>
__device__ __forceinline__ void reduce_scatter(float (&a)[P], int lane) {
  rs_step<P / 2>(a, lane, 16);
  rs_step<P / 4>(a, lane, 8);
  rs_step<P / 8>(a, lane, 4);
  rs_step<P / 16>(a, lane, 2);
  rs_step<P / 32>(a, lane, 1);
}

// the points as d + 1 rows of `stride` floats: each coordinate, then |x|^2
// (+inf for an invalid point and for the padding, 0 coordinates)
template <int D>
__global__ void fit_rows_kernel(const float* __restrict__ x, const float* __restrict__ x_norm,
                                const uint8_t* __restrict__ valid, int N, int stride,
                                float* __restrict__ rows) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= stride) return;
  const bool in = n < N;
#pragma unroll
  for (int k = 0; k < D; ++k) rows[(size_t)k * stride + n] = in ? x[(size_t)n * D + k] : 0.f;
  rows[(size_t)D * stride + n] = in && valid[n] ? x_norm[n] : f32_inf();
}

template <int D>
__device__ __forceinline__ void load_seed(float (&v)[D], const float* __restrict__ seeds, int S,
                                          long long idx) {
#pragma unroll
  for (int k = 0; k < D; ++k) v[k] = idx < S ? seeds[idx * D + k] : 0.f;
}

// One point against the pass's NS seeds, in the distance's order with every
// operation rounded.
template <int D, int NS, int P>
__device__ __forceinline__ void accumulate_point(float (&acc)[P], const float (&cs)[NS][D],
                                                 const float (&cn)[NS], const float (&xv)[D],
                                                 float xn, float bw2) {
  constexpr int V = D + 1;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    float cross = __fmul_rn(cs[s][0], xv[0]);
#pragma unroll
    for (int k = 1; k < D; ++k) cross = __fadd_rn(cross, __fmul_rn(cs[s][k], xv[k]));
    const float d2 = __fsub_rn(__fadd_rn(cn[s], xn), __fmul_rn(2.f, cross));
    if (d2 <= bw2) {
      acc[s * V] = __fadd_rn(acc[s * V], 1.f);
#pragma unroll
      for (int k = 0; k < D; ++k) acc[s * V + 1 + k] = __fadd_rn(acc[s * V + 1 + k], xv[k]);
    }
  }
}

// A thread's partials of one pass: its points t + j T of the block's share
// in increasing j, the resident rows from shared memory, then the rest from
// L2 (unrolled, so that several loads are in flight).
template <int D, int NS, int P>
__device__ __forceinline__ void accumulate(float (&acc)[P], const float (&cs)[NS][D],
                                           const float (&cn)[NS], const float* pts,
                                           const float* __restrict__ rows, int begin, int stride,
                                           int share, int resident, int T, float bw2) {
  int i = threadIdx.x;
  // a pass of few seeds is bound by latency: overlap several points
#pragma unroll(NS <= 2 ? 4 : 1)
  for (; i < resident; i += T) {
    float xv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = pts[k * resident + i];
    accumulate_point<D, NS, P>(acc, cs, cn, xv, pts[D * resident + i], bw2);
  }
#pragma unroll 4
  for (; i < share; i += T) {
    const float* g = rows + begin + i;
    float xv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = __ldg(g + (size_t)k * stride);
    accumulate_point<D, NS, P>(acc, cs, cn, xv, __ldg(g + (size_t)D * stride), bw2);
  }
}

// One pass over the block's share for the NS held seeds at positions pos ..
// pos + NS - 1 (their centers and |c|^2 in s_cc): the threads' partials,
// reduced over the warp by the butterfly's tree (a few values: the butterfly
// itself; more: the reduce-scatter), into this warp's row of `red` at the
// seeds' positions.
template <int D, int NS>
__device__ __forceinline__ void fit_pass(int pos, const float* s_cc, float* red_w,
                                         const float* pts, const float* __restrict__ rows,
                                         int begin, int stride, int share, int resident, int T,
                                         float bw2, int lane) {
  constexpr int V = D + 1, CV = NS * V;
  float cs[NS][D], cn[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int k = 0; k < D; ++k) cs[s][k] = s_cc[(pos + s) * V + k];
    cn[s] = s_cc[(pos + s) * V + D];
  }
  if constexpr (CV <= 8) {
    float acc[CV];
#pragma unroll
    for (int i = 0; i < CV; ++i) acc[i] = 0.f;
    accumulate<D, NS, CV>(acc, cs, cn, pts, rows, begin, stride, share, resident, T, bw2);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
#pragma unroll
      for (int i = 0; i < CV; ++i) acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], m));
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < CV; ++i) red_w[pos * V + i] = acc[i];
  } else {
    constexpr int P = (CV + 31) / 32 * 32, R = P / 32;
    float acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = 0.f;
    accumulate<D, NS, P>(acc, cs, cn, pts, rows, begin, stride, share, resident, T, bw2);
    reduce_scatter<P>(acc, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = R * lane + r;
      if (v < CV) red_w[pos * V + v] = acc[r];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFitThreads, 2)
mean_shift_fit_kernel(const float* __restrict__ seeds, const float* __restrict__ rows,
                      int stride, float bw2, float stop, int max_iter, int S, int share,
                      int resident, float* __restrict__ centers_out,
                      float* __restrict__ n_final_out, uint8_t* __restrict__ frozen_out,
                      int* __restrict__ n_iter_out) {
  using F = FitShape<D>;
  constexpr int V = F::V, M = F::M, K = F::K, SC = F::SC;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x, W = T >> 5;
  const int cid = blockIdx.x / C, n_clusters = gridDim.x / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int begin = rank * share;

  extern __shared__ __align__(16) float fit_smem[];
  float* recv = fit_smem;         // [2][C][K]: the ranks' partials, by iteration parity
  float* red = recv + 2 * C * K;  // [W][K]: the warps' partials
  float* pts = red + W * K;       // [V][resident]: the resident rows
  __shared__ __align__(8) uint64_t bars[3];  // receive buffers 0 and 1; the points
  __shared__ float s_cc[M * V];              // per held seed: its center, then |c|^2
  __shared__ unsigned s_mask;                // the slots that hold a seed

  // the other ranks' pushes into one receive buffer; this rank's own
  // partials are plain stores
  const uint32_t push_bytes = (uint32_t)((C - 1) * K * 4);
  if (threadIdx.x == 0) {
    wg::mbar_init(&bars[0], 1);
    wg::mbar_init(&bars[1], 1);
    wg::mbar_init(&bars[2], 1);
    wg::mbar_fence_init();
    wg::mbar_arrive_tx(&bars[0], push_bytes);  // iteration 0's pushes
    wg::mbar_arrive_tx(&bars[1], push_bytes);  // iteration 1's
    wg::mbar_arrive_tx(&bars[2], (uint32_t)(V * resident * 4));
    for (int k = 0; k < V; ++k)
      wg::bulk_g2s(pts + k * resident, rows + (size_t)k * stride + begin, resident * 4, &bars[2]);
  }

  // warp 0: lane m < M holds slot m (its seed, -1 for none; the seed's
  // iterations; whether its next pass is the recount; its center and the
  // previous one); lane q holds the coordinates of the cluster's q-th next
  // seed, loaded a pass ahead
  int seed = -1, iters = 0, qpos = 0;
  bool recount = false;
  float c[D], prev[D], qc[D];
  auto refill = [&]() {
    const unsigned freed = __ballot_sync(0xffffffffu, lane < M && seed < 0);
    const int j = __popc(freed & ((1u << lane) - 1u));
    float nc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) nc[k] = __shfl_sync(0xffffffffu, qc[k], j & 31);
    if ((freed >> lane) & 1u) {
      const long long idx = cid + (long long)(qpos + j) * n_clusters;
      if (idx < S) {
        seed = (int)idx;
        iters = 0;
        recount = max_iter <= 0;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          c[k] = nc[k];
          prev[k] = f32_inf();
        }
      }
    }
    qpos += __popc(freed);
    load_seed<D>(qc, seeds, S, cid + (long long)(qpos + lane) * n_clusters);
    // publish the held seeds' centers and |c|^2 at their positions
    const unsigned held = __ballot_sync(0xffffffffu, lane < M && seed >= 0);
    if (lane < M && seed >= 0) {
      const int pos = __popc(held & ((1u << lane) - 1u));
      float cn = __fmul_rn(c[0], c[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) cn = __fadd_rn(cn, __fmul_rn(c[k], c[k]));
#pragma unroll
      for (int k = 0; k < D; ++k) s_cc[pos * V + k] = c[k];
      s_cc[pos * V + D] = cn;
    }
    if (lane == 0) s_mask = held;
  };
  if (warp == 0) {
    load_seed<D>(qc, seeds, S, cid + (long long)lane * n_clusters);
    refill();
  }
  // every rank's barriers are initialized and armed before any push
  cluster.sync();
  wg::mbar_wait(&bars[2], 0);

  for (int it = 0;; ++it) {
    const unsigned mask = s_mask;
    if (mask == 0) break;
    // the held seeds by position (their rank among the held slots), in
    // passes of SC seeds, then 4, 2, 1: a pass costs what its seeds need
    const int held = __popc(mask);
    float* red_w = red + warp * K;
    int pos = 0;
    for (; pos + SC <= held; pos += SC)
      fit_pass<D, SC>(pos, s_cc, red_w, pts, rows, begin, stride, share, resident, T, bw2, lane);
    if constexpr (SC > 4) {
      if (held - pos >= 4) {
        fit_pass<D, 4>(pos, s_cc, red_w, pts, rows, begin, stride, share, resident, T, bw2, lane);
        pos += 4;
      }
    }
    if constexpr (SC > 2) {
      if (held - pos >= 2) {
        fit_pass<D, 2>(pos, s_cc, red_w, pts, rows, begin, stride, share, resident, T, bw2, lane);
        pos += 2;
      }
    }
    if (held - pos >= 1)
      fit_pass<D, 1>(pos, s_cc, red_w, pts, rows, begin, stride, share, resident, T, bw2, lane);

    const int b = it & 1;
    if (warp != 0) {
      named_arrive(1, T);
    } else {
      wg::named_sync(1, T);
      // the block's partials: the warps in index order; pushed into this
      // rank's slot of every rank's receive buffer b
      if (lane < K / 4) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (4 * lane < held * V) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = red[4 * lane + q];
#pragma unroll
          for (int w = 1; w < kFitThreads / 32; ++w)
            if (w < W)
#pragma unroll
              for (int q = 0; q < 4; ++q) v[q] = __fadd_rn(v[q], red[w * K + 4 * lane + q]);
        }
        float* mine = recv + (b * C + rank) * K + 4 * lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) mine[q] = v[q];
        const uint32_t dst = wg::smem_u32(mine);
        const uint32_t bar = wg::smem_u32(&bars[b]);
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < C && r != rank) st_async_v4(cluster_addr(dst, r), v, cluster_addr(bar, r));
      }
      mbar_wait_cluster(&bars[b], (uint32_t)(it >> 1) & 1u);
      __syncwarp();  // this rank's own partials, stored by the lanes above
      if (lane == 0) wg::mbar_arrive_tx(&bars[b], push_bytes);  // iteration it + 2's pushes

      if (lane < M && seed >= 0) {
        // the cluster's sums at the slot's position: the ranks in rank order
        const float* part = recv + b * C * K + __popc(mask & ((1u << lane) - 1u)) * V;
        float tot[V];
#pragma unroll
        for (int v = 0; v < V; ++v) tot[v] = part[v];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          if (r < C)
#pragma unroll
            for (int v = 0; v < V; ++v) tot[v] = __fadd_rn(tot[v], part[r * K + v]);
        bool finish = recount, froze = false;
        if (!recount) {
          const float count = tot[0];
          const float denom = fmaxf(count, 1.f);
          float mean[D], ss = 0.f;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            mean[k] = __fdiv_rn(tot[1 + k], denom);
            const float diff = __fsub_rn(mean[k], c[k]);
            const float sq = __fmul_rn(diff, diff);
            ss = k == 0 ? sq : __fadd_rn(ss, sq);
          }
          const bool empty = count == 0.f;
          const bool done = empty || __fsqrt_rn(ss) < stop;
          float next[D];
          bool same = true;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            next[k] = empty ? c[k] : mean[k];
            same = same && next[k] == prev[k];
          }
          // exact period-2 cycle: move to the phase held at max_iter and halt
          const bool cycle = same && !done;
          if (cycle && (max_iter - (iters + 1)) % 2 != 0) {
#pragma unroll
            for (int k = 0; k < D; ++k) next[k] = c[k];
          }
#pragma unroll
          for (int k = 0; k < D; ++k) {
            prev[k] = c[k];
            c[k] = next[k];
          }
          iters += 1;
          finish = froze = done;
          // halted unfrozen: the next pass recounts its ball
          recount = !done && (cycle || iters >= max_iter);
        }
        if (finish) {
          if (rank == 0) {
#pragma unroll
            for (int k = 0; k < D; ++k) centers_out[(size_t)seed * D + k] = c[k];
            n_final_out[seed] = tot[0];
            frozen_out[seed] = froze ? 1 : 0;
            n_iter_out[seed] = iters;
          }
          seed = -1;
        }
      }
      refill();
    }
    __syncthreads();
  }
  // no block leaves while another may still write to it
  cluster.sync();
}

cudaLaunchConfig_t fit_config(int cluster, int clusters, int threads, int smem,
                              cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's shared-memory limit, set once per (d, device) to what any
// launch shape needs (kMaxCluster blocks, every point row at its cap), and
// the clusters the card holds at once for a launch shape, queried once per
// (d, shape, shared bytes, device): no host plan at every call.
std::mutex g_fit_mu;
std::map<std::array<int, 2>, bool> g_fit_attrs;
std::map<std::array<int, 5>, int> g_fit_clusters;

template <int D>
int fit_clusters(int cluster, int threads, int smem, int* clusters) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const std::array<int, 5> key = {D, cluster, threads, smem, device};
  std::lock_guard<std::mutex> lock(g_fit_mu);
  const auto hit = g_fit_clusters.find(key);
  if (hit != g_fit_clusters.end()) {
    *clusters = hit->second;
    return 0;
  }
  if (!g_fit_attrs[{D, device}]) {
    const int most = fit_smem_bytes(D, kMaxCluster, kFitThreads, fit_resident(1 << 30, D));
    err = cudaFuncSetAttribute(mean_shift_fit_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    g_fit_attrs[{D, device}] = true;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = fit_config(cluster, 1, threads, smem, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, mean_shift_fit_kernel<D>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  g_fit_clusters[key] = n;
  *clusters = n;
  return 0;
}

template <int D>
int plan_out(int N, int* out) {
  const FitPlan p = fit_plan_for(N, D);
  int clusters = 0;
  const int rc = fit_clusters<D>(p.cluster, p.threads, p.smem, &clusters);
  if (rc != 0) return rc;
  out[0] = p.cluster;
  out[1] = p.threads;
  out[2] = p.slots;
  out[3] = p.share;
  out[4] = p.resident;
  out[5] = p.smem;
  out[6] = clusters;
  return 0;
}

template <int D>
int fit_launch(const float* seeds, const float* x, const float* x_norm, const uint8_t* valid,
               float* rows, float bw2, float stop, int max_iter, int S, int N, int cluster,
               int threads, float* centers, float* n_final, uint8_t* frozen, int* n_iter,
               cudaStream_t stream) {
  const int share = fit_share(N, cluster);
  const int resident = fit_resident(share, D);
  const int smem = fit_smem_bytes(D, cluster, threads, resident);
  const int stride = cluster * share;
  int clusters = 0;
  const int rc = fit_clusters<D>(cluster, threads, smem, &clusters);
  if (rc != 0) return rc;
  fit_rows_kernel<D><<<(stride + 255) / 256, 256, 0, stream>>>(x, x_norm, valid, N, stride, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      fit_config(cluster, clusters < S ? clusters : S, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, mean_shift_fit_kernel<D>, (const float*)seeds,
                           (const float*)rows, stride, bw2, stop, max_iter, S, share, resident,
                           centers, n_final, frozen, n_iter);
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
// valid (N,) bytes; rows: scratch of (d + 1) * cluster * fit_share(N,
// cluster) floats the launch lays the points out in; out centers (S, d)
// f32, n_final (S,) f32, frozen (S,) bytes, n_iter (S,) int32. `cluster`
// (1, 2, 4 or 8) and `threads` (128 or 256) are the launch shape, the
// plan's (mean_shift_fit_plan) on the main path.
int mean_shift_fit_launch(const void* seeds, const void* x, const void* x_norm,
                          const void* valid, void* rows, float bw2, float stop, int max_iter,
                          int S, int N, int d, int cluster, int threads, void* centers,
                          void* n_final, void* frozen, void* n_iter, void* stream) {
  if ((cluster & (cluster - 1)) != 0 || cluster < 1 || cluster > kMaxCluster ||
      (threads != 128 && threads != kFitThreads) || N < 0)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
#define CALL(D)                                                                               \
  fit_launch<D>((const float*)seeds, (const float*)x, (const float*)x_norm,                   \
                (const uint8_t*)valid, (float*)rows, bw2, stop, max_iter, S, N, cluster,      \
                threads, (float*)centers, (float*)n_final, (uint8_t*)frozen, (int*)n_iter,    \
                (cudaStream_t)stream)
  CELLULUS_FOR_EACH_DIM(d, CALL)
#undef CALL
}

// The plan for (N, d), out[0..6]: blocks per cluster, threads per block,
// seed slots, points per block, resident points per block, dynamic shared
// bytes, and the clusters the current card holds at once under it.
int mean_shift_fit_plan(int N, int d, void* out) {
#define CALL(D) plan_out<D>(N, (int*)out)
  CELLULUS_FOR_EACH_DIM(d, CALL)
#undef CALL
}

}  // extern "C"
