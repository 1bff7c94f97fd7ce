// Filter gradient of a VALID stride-1 3x3 conv for Hopper (sm_90a):
//
//   dw[ky, kx, ci, co] = sum_{b, y, x} x[b, y + ky, x + kx, ci] * g[b, y, x, co]
//
// x (B, H, W, Ci) and g (B, H-2, W-2, Co), NHWC, both float32 or both
// bfloat16; dw (3, 3, Ci, Co) float32, summed in float32. Float32 inputs are
// NOT rounded to bfloat16: the JAX package's default float32 train step
// takes XLA's float32 filter gradient, and rounding the operands would move
// float32 training off it by about 1e-2 relative. Bfloat16 inputs are
// exactly what the TPU kernel feeds its matrix unit.
//
// Replaces: cellulus_tpu/ops/pallas_dw.py `_dw_kernel` / `conv3x3_dw`, the
// backward of `conv_valid_pallas` (cellulus_tpu/ops/conv_vjp.py). The TPU
// kernel's packed (3Ci, 3Co) output block, its 8-aligned width padding and
// its halo gather exist only for Mosaic and are not carried over.
//
// What bounds it on the H100: operations. The function is one GEMM per tap,
// dw[tap] (Ci x Co) = X_tap^T (Ci x P) . G (P x Co), with a very tall
// K = P = B*Ho*Wo (pixels); at the train step's widths it does 300-1100
// FLOP per byte of x and g, far above the card's ridge point, so the least
// time is the FLOPs over the tensor-core peak of the input type (bf16
// 989 TFLOP/s; float32 as 3xTF32, 495 / 3 = 165 TFLOP/s).
//
// Two plans, chosen by shape before launch (conv3x3_dw_plan):
//
// 1. Tensor cores (Ci >= 8, Ci and Co multiples of 8: every shape of the
//    train step but the first conv's Ci = 1). M = (tap, ci), N = co,
//    K = pixels. A block owns 64 input x 64 output channels for all nine
//    taps and walks a contiguous range of pixel chunks (8 x 16 output
//    pixels of one image). Each chunk's g patch and x patch (with its
//    2-pixel halo) come in by cp.async into a ring of 3 (bf16) or 2 (f32)
//    stages, so the next chunk loads while this one multiplies. 12 warps:
//    warp (ky, m) owns the three taps (ky, 0..2) of 16 input channels x 64
//    output channels (96 f32 accumulators a thread), so one B fragment of g
//    serves three taps, and the A fragment of each tap is the x patch read
//    at the tap-shifted pixel rows (ldmatrix takes one row address per
//    lane, so the shift costs nothing). bf16: mma.sync m16n8k16 with
//    fragments by ldmatrix.trans (both operands are pixel-major in shared
//    memory). f32: 3xTF32 (mma_tile.cuh) with fragments by 32-bit shared
//    loads, one tap at a time, the three products issued in three passes
//    over four n8 tiles so that no mma waits on the one before; each
//    chunk's sum starts from zero and is added to the running sum in
//    float32 (the tensor cores' own accumulation rounds toward zero and
//    drifts over a long K). Pixel pitches are 72 elements (16 B multiples,
//    conflict-free for both ldmatrix rows and the f32 fragment pattern).
// 2. CUDA cores (every other shape; on the main path only Ci = 1, which is
//    bound by reading g). Each thread owns one input channel and 8 output
//    channels, all 9 taps (72 f32 accumulators), and walks a row of its
//    chunk with a sliding 3x3 window of x in registers; the g patch comes
//    in by 16-byte cp.async.
//
// Both plans split K over pixel chunks: each block writes its partial tile
// to a float32 workspace slot, and conv_dw_reduce_kernel sums the slots in a
// fixed order. No atomics: the result is deterministic, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

// ---------------------------------------------------------------------------
// Plan 1: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcCi = 64;              // input channels per block (4 m16 tiles)
constexpr int kTcCo = 64;              // output channels per block (8 n8 tiles)
constexpr int kTcTY = 8, kTcTX = 16;   // output pixels per chunk
constexpr int kTcWarps = 3 * (kTcCi / 16);
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcXW = kTcTX + 2;                       // x patch width
constexpr int kTcXPix = (kTcTY + 2) * kTcXW;           // x patch pixels
constexpr int kTcGPix = kTcTY * kTcTX;                 // g patch pixels
constexpr int kTcPitch = 72;                           // elements per staged pixel
constexpr int kTcStageElems = (kTcXPix + kTcGPix) * kTcPitch;

template <typename T> struct TcStages;
template <> struct TcStages<__nv_bfloat16> { static constexpr int n = 3; };
template <> struct TcStages<float> { static constexpr int n = 2; };

template <typename T>
constexpr size_t tc_smem_bytes() {
  return (size_t)TcStages<T>::n * kTcStageElems * sizeof(T);
}

__host__ __device__ inline bool use_tensor_cores(int Ci, int Co) {
  return Ci >= 8 && Ci % 8 == 0 && Co % 8 == 0;
}

// Chunk c's x patch and g patch into one stage, zeros outside the image
// and past Ci / Co (whole 16-byte vectors: Ci and Co are multiples of 8).
template <typename T>
__device__ __forceinline__ void tc_load_chunk(T* stage, const T* __restrict__ x,
                                              const T* __restrict__ g, int c, int H, int W,
                                              int Ci, int Co, int ci0, int co0, int chunks_y,
                                              int chunks_x) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int Ho = H - 2, Wo = W - 2;
  const int b = c / (chunks_y * chunks_x);
  const int rem = c - b * chunks_y * chunks_x;
  const int y0 = (rem / chunks_x) * kTcTY;
  const int x0 = (rem % chunks_x) * kTcTX;
  T* xs = stage;
  T* gs = stage + kTcXPix * kTcPitch;
  constexpr int xv = kTcCi / V, gv = kTcCo / V;
  for (int idx = threadIdx.x; idx < kTcXPix * xv; idx += kTcThreads) {
    const int px = idx / xv, ci = ci0 + (idx % xv) * V;
    const int iy = y0 + px / kTcXW, ix = x0 + px % kTcXW;
    const bool ok = iy < H && ix < W && ci < Ci;
    const T* src = ok ? x + (((size_t)b * H + iy) * W + ix) * Ci + ci : x;
    cp_async16(xs + px * kTcPitch + (ci - ci0), src, ok ? 16 : 0);
  }
  for (int idx = threadIdx.x; idx < kTcGPix * gv; idx += kTcThreads) {
    const int px = idx / gv, co = co0 + (idx % gv) * V;
    const int gy = y0 + px / kTcTX, gx = x0 + px % kTcTX;
    const bool ok = gy < Ho && gx < Wo && co < Co;
    const T* src = ok ? g + (((size_t)b * Ho + gy) * Wo + gx) * Co + co : g;
    cp_async16(gs + px * kTcPitch + (co - co0), src, ok ? 16 : 0);
  }
}

// One chunk: warp (ky, mt) adds the taps (ky, 0..2) of its 16 input
// channels x 64 output channels.
__device__ __forceinline__ void tc_chunk(const __nv_bfloat16* stage, int ky, int mt,
                                         float acc[3][8][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* xs = stage;
  const __nv_bfloat16* gs = stage + kTcXPix * kTcPitch;
  // ldmatrix row of this lane: A (x, stored pixel x ci) and B (g, pixel x co)
  const int a_k = (lane & 7) + ((lane >> 4) << 3), a_m = ((lane >> 3) & 1) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
#pragma unroll 2
  for (int s = 0; s < kTcTY; ++s) {  // one k16 step = one output row
    uint32_t a[3][4];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      ldmatrix_x4_trans(a[kx], xs + ((s + ky) * kTcXW + a_k + kx) * kTcPitch + mt * 16 + a_m);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, gs + (s * kTcTX + b_k) * kTcPitch + np * 16 + b_n);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        mma_bf16(acc[kx][2 * np], a[kx], b);
        mma_bf16(acc[kx][2 * np + 1], a[kx], b + 2);
      }
    }
  }
}

// f32: the tensor cores round a float32 accumulator toward zero, so over
// the long K of a split the error would grow with the number of mma steps.
// Each tap's chunk sum (128 pixels) therefore starts from zero and is added
// to the running sum with an ordinary float32 add (round to nearest).
__device__ __forceinline__ void tc_chunk(const float* stage, int ky, int mt,
                                         float acc[3][8][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float* xs = stage;
  const float* gs = stage + kTcXPix * kTcPitch;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
#pragma unroll 2
    for (int s8 = 0; s8 < 2 * kTcTY; ++s8) {  // one k8 step = half an output row
      const int s = s8 >> 1, px0 = (s8 & 1) * 8;
      const float* p = xs + ((s + ky) * kTcXW + px0 + tq + kx) * kTcPitch + mt * 16 + gq;
      const float va[4] = {p[0], p[8], p[4 * kTcPitch], p[4 * kTcPitch + 8]};
      uint32_t a_hi[4], a_lo[4];
      split_frag<4>(va, a_hi, a_lo);
      // four n8 tiles' fragments first, then the three products in three
      // passes over them, so that no mma waits on the one before it
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* q = gs + (s * kTcTX + px0 + tq) * kTcPitch + (j0 + j) * 8 + gq;
          const float vb[2] = {q[0], q[4 * kTcPitch]};
          split_frag<2>(vb, b_hi[j], b_lo[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[j0 + j], a_lo, b_hi[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[j0 + j], a_hi, b_lo[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[j0 + j], a_hi, b_hi[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[kx][j][r] += part[j][r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
conv_dw_mma_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws,
                   int B, int H, int W, int Ci, int Co, int n_ci_blocks, int chunks_y,
                   int chunks_x, int chunks_per_split) {
  constexpr int S = TcStages<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = warp / (kTcCi / 16), mt = warp % (kTcCi / 16);
  const int ci0 = (blockIdx.x % n_ci_blocks) * kTcCi;
  const int co0 = (blockIdx.x / n_ci_blocks) * kTcCo;

  float acc[3][8][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[kx][j][r] = 0.f;

  const int n_chunks = B * chunks_y * chunks_x;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int n = min(n_chunks, c_begin + chunks_per_split) - c_begin;

  // prologue: S - 1 chunks in flight (empty groups keep the count uniform)
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n)
      tc_load_chunk(smem + i * kTcStageElems, x, g, c_begin + i, H, W, Ci, Co, ci0, co0,
                    chunks_y, chunks_x);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and chunk i - 1 is no longer read
    const int next = i + S - 1;
    if (next < n)
      tc_load_chunk(smem + (next % S) * kTcStageElems, x, g, c_begin + next, H, W, Ci, Co,
                    ci0, co0, chunks_y, chunks_x);
    cp_async_commit();
    tc_chunk(smem + (i % S) * kTcStageElems, ky, mt, acc);
  }
  cp_async_wait<0>();

  // partial tile -> this split's workspace slot
  const int gq = lane >> 2, tq = lane & 3;
  float* out = ws + (size_t)blockIdx.y * 9 * Ci * Co;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    const int tap = ky * 3 + kx;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + j * 8 + 2 * tq;
      if (co >= Co) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + mt * 16 + gq + 8 * h;
        if (ci < Ci)
          *reinterpret_cast<float2*>(out + ((size_t)tap * Ci + ci) * Co + co) =
              make_float2(acc[kx][j][2 * h], acc[kx][j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Plan 2: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kCoPerThread = 8;
constexpr int kAcc = 9 * kCoPerThread;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Eight consecutive elements as float (32-byte aligned for f32, 16 for bf16).
__device__ __forceinline__ void load8(const float* p, float a[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float a[8]) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

// The block's shape, fixed by (Ci, Co): tci threads along input channels,
// tco along groups of 8 output channels, ks groups along pixel rows.
struct Plan {
  int tci, tco, ks, nb, ty, tx;
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

__host__ __device__ inline Plan make_plan(int Ci, int Co) {
  Plan p;
  p.tci = Ci >= 16 ? 16 : pow2_at_least(Ci);
  const int groups = (Co + kCoPerThread - 1) / kCoPerThread;
  p.tco = groups >= 8 ? 8 : pow2_at_least(groups);
  p.ks = kThreads / (p.tci * p.tco);
  p.nb = p.tco * kCoPerThread;
  const int rows_per_group = p.ks >= 8 ? 1 : 8 / p.ks;
  p.ty = p.ks * rows_per_group;
  p.tx = p.ks >= 16 ? 8 : 32;
  return p;
}

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T>
size_t smem_bytes(const Plan& p) {
  const size_t g = round16((size_t)p.ty * p.tx * p.nb * sizeof(T));
  const size_t x = round16((size_t)(p.ty + 2) * (p.tx + 2) * p.tci * sizeof(T));
  const size_t red = (size_t)(p.ks - 1) * kAcc * (p.tci * p.tco) * sizeof(float);
  return g + x > red ? g + x : red;
}

template <typename T, int TX>
__global__ void __launch_bounds__(kThreads, 2)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws,
                       int B, int H, int W, int Ci, int Co, Plan p, int n_ci_blocks,
                       int chunks_y, int chunks_x, int chunks_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + round16((size_t)p.ty * TX * p.nb * sizeof(T)));

  const int Ho = H - 2, Wo = W - 2;
  const int t = threadIdx.x;
  const int lanes = p.tci * p.tco;
  const int ci_l = t % p.tci;
  const int cog = (t / p.tci) % p.tco;
  const int ks_id = t / lanes;
  const int ci0 = (blockIdx.x % n_ci_blocks) * p.tci;
  const int co0 = (blockIdx.x / n_ci_blocks) * p.nb;
  const int xw = TX + 2;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int n_chunks = B * chunks_y * chunks_x;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  for (int c = c_begin; c < c_end; ++c) {
    const int b = c / (chunks_y * chunks_x);
    const int rem = c - b * chunks_y * chunks_x;
    const int y0 = (rem / chunks_x) * p.ty;
    const int x0 = (rem % chunks_x) * TX;

    __syncthreads();  // the previous chunk's reads are done
    // g patch (ty, TX, nb): zeros outside the image and past Co; by
    // 16-byte cp.async where Co allows it (g is most of what this plan reads)
    constexpr int V = 16 / sizeof(T);
    if (Co % V == 0) {
      const int nv = p.nb / V, n_g = p.ty * TX * nv;
      for (int idx = t; idx < n_g; idx += kThreads) {
        const int px = idx / nv, co_l = (idx - px * nv) * V;
        const int gy = y0 + px / TX, gx = x0 + px % TX, co = co0 + co_l;
        const bool ok = gy < Ho && gx < Wo && co < Co;
        const T* src = ok ? g + (((size_t)b * Ho + gy) * Wo + gx) * Co + co : g;
        cp_async16(gs + px * p.nb + co_l, src, ok ? 16 : 0);
      }
      cp_async_commit();
    } else {
      const int n_g = p.ty * TX * p.nb;
      for (int idx = t; idx < n_g; idx += kThreads) {
        const int co_l = idx % p.nb;
        const int px = idx / p.nb;
        const int gy = y0 + px / TX, gx = x0 + px % TX, co = co0 + co_l;
        T v = zero<T>();
        if (gy < Ho && gx < Wo && co < Co) v = g[(((size_t)b * Ho + gy) * Wo + gx) * Co + co];
        gs[idx] = v;
      }
    }
    // x patch (ty + 2, TX + 2, tci): zeros outside the image and past Ci
    const int n_x = (p.ty + 2) * xw * p.tci;
    for (int idx = t; idx < n_x; idx += kThreads) {
      const int c_l = idx % p.tci;
      const int px = idx / p.tci;
      const int iy = y0 + px / xw, ix = x0 + px % xw, ci = ci0 + c_l;
      T v = zero<T>();
      if (iy < H && ix < W && ci < Ci) v = x[(((size_t)b * H + iy) * W + ix) * Ci + ci];
      xs[idx] = v;
    }
    cp_async_wait<0>();
    __syncthreads();

    for (int ly = ks_id; ly < p.ty; ly += p.ks) {
      const T* xrow[3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) xrow[ky] = xs + (size_t)(ly + ky) * xw * p.tci + ci_l;
      const T* grow = gs + (size_t)ly * TX * p.nb + cog * kCoPerThread;
      float w0[3], w1[3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        w0[ky] = to_f(xrow[ky][0]);
        w1[ky] = to_f(xrow[ky][p.tci]);
      }
#pragma unroll 4
      for (int lx = 0; lx < TX; ++lx) {
        float w2[3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) w2[ky] = to_f(xrow[ky][(lx + 2) * p.tci]);
        float gv[kCoPerThread];
        load8(grow + lx * p.nb, gv);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int j = 0; j < kCoPerThread; ++j) {
            acc[(ky * 3 + 0) * kCoPerThread + j] = fmaf(w0[ky], gv[j], acc[(ky * 3 + 0) * kCoPerThread + j]);
            acc[(ky * 3 + 1) * kCoPerThread + j] = fmaf(w1[ky], gv[j], acc[(ky * 3 + 1) * kCoPerThread + j]);
            acc[(ky * 3 + 2) * kCoPerThread + j] = fmaf(w2[ky], gv[j], acc[(ky * 3 + 2) * kCoPerThread + j]);
          }
          w0[ky] = w1[ky];
          w1[ky] = w2[ky];
        }
      }
    }
  }

  // sum the ks row groups in a fixed order: group 0 adds groups 1, 2, ...
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int slot = t % lanes;
  if (ks_id > 0) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) red[((size_t)(ks_id - 1) * kAcc + i) * lanes + slot] = acc[i];
  }
  __syncthreads();
  if (ks_id != 0) return;
  for (int s = 1; s < p.ks; ++s) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += red[((size_t)(s - 1) * kAcc + i) * lanes + slot];
  }
  const int ci = ci0 + ci_l;
  if (ci >= Ci) return;
  float* out = ws + (size_t)blockIdx.y * 9 * Ci * Co;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int j = 0; j < kCoPerThread; ++j) {
      const int co = co0 + cog * kCoPerThread + j;
      if (co < Co) out[((size_t)tap * Ci + ci) * Co + co] = acc[tap * kCoPerThread + j];
    }
  }
}

// ---------------------------------------------------------------------------
// Both plans
// ---------------------------------------------------------------------------

// dw[i] = sum over splits s of ws[s][i], s = 0, 1, ... in order.
__global__ void conv_dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                      size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[(size_t)k * n + i];
    dw[i] = s;
  }
}

struct Grid {
  bool tc;
  Plan plan;  // CUDA-core plan only
  int n_ci_blocks, n_co_blocks, chunks_y, chunks_x;
  long long n_chunks;
};

Grid make_grid(int B, int H, int W, int Ci, int Co) {
  Grid gr;
  gr.tc = use_tensor_cores(Ci, Co);
  int ci_tile, co_tile, ty, tx;
  if (gr.tc) {
    ci_tile = kTcCi;
    co_tile = kTcCo;
    ty = kTcTY;
    tx = kTcTX;
  } else {
    gr.plan = make_plan(Ci, Co);
    ci_tile = gr.plan.tci;
    co_tile = gr.plan.nb;
    ty = gr.plan.ty;
    tx = gr.plan.tx;
  }
  gr.n_ci_blocks = (Ci + ci_tile - 1) / ci_tile;
  gr.n_co_blocks = (Co + co_tile - 1) / co_tile;
  gr.chunks_y = (H - 2 + ty - 1) / ty;
  gr.chunks_x = (W - 2 + tx - 1) / tx;
  gr.n_chunks = (long long)B * gr.chunks_y * gr.chunks_x;
  return gr;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch_partial(const void* x, const void* g, float* ws, int B, int H, int W, int Ci, int Co,
                   int splits, const Grid& gr, cudaStream_t stream) {
  const int per_split = (int)((gr.n_chunks + splits - 1) / splits);
  dim3 grid(gr.n_ci_blocks * gr.n_co_blocks, splits);
  if (gr.tc) {
    const size_t smem = tc_smem_bytes<T>();
    const int rc = set_smem(conv_dw_mma_kernel<T>, smem);
    if (rc != 0) return rc;
    conv_dw_mma_kernel<T><<<grid, kTcThreads, smem, stream>>>(
        (const T*)x, (const T*)g, ws, B, H, W, Ci, Co, gr.n_ci_blocks, gr.chunks_y,
        gr.chunks_x, per_split);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes<T>(gr.plan);
  const int rc = gr.plan.tx == 8 ? set_smem(conv_dw_partial_kernel<T, 8>, smem)
                                 : set_smem(conv_dw_partial_kernel<T, 32>, smem);
  if (rc != 0) return rc;
  if (gr.plan.tx == 8)
    conv_dw_partial_kernel<T, 8><<<grid, kThreads, smem, stream>>>(
        (const T*)x, (const T*)g, ws, B, H, W, Ci, Co, gr.plan, gr.n_ci_blocks, gr.chunks_y,
        gr.chunks_x, per_split);
  else
    conv_dw_partial_kernel<T, 32><<<grid, kThreads, smem, stream>>>(
        (const T*)x, (const T*)g, ws, B, H, W, Ci, Co, gr.plan, gr.n_ci_blocks, gr.chunks_y,
        gr.chunks_x, per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, float* ws, float* dw, int B, int H, int W, int Ci, int Co,
           int splits, cudaStream_t stream) {
  const Grid gr = make_grid(B, H, W, Ci, Co);
  const int rc = launch_partial<T>(x, g, ws, B, H, W, Ci, Co, splits, gr, stream);
  if (rc != 0) return rc;
  const size_t n = (size_t)9 * Ci * Co;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  conv_dw_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if (Ci, Co) takes the tensor-core plan, 0 if the CUDA-core plan.
int conv3x3_dw_plan(int Ci, int Co) { return use_tensor_cores(Ci, Co) ? 1 : 0; }

// Workspace slots (pixel splits) for these shapes, at most one per pixel
// chunk: one wave of tensor-core blocks (one per SM), or about four
// CUDA-core blocks per SM.
int conv3x3_dw_splits(int B, int H, int W, int Ci, int Co) {
  const Grid gr = make_grid(B, H, W, Ci, Co);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = gr.n_ci_blocks * gr.n_co_blocks;
  long long splits = gr.tc ? sms / tiles : (4LL * sms + tiles - 1) / tiles;
  if (splits > gr.n_chunks) splits = gr.n_chunks;
  return splits < 1 ? 1 : (int)splits;
}

// x (B, H, W, Ci), g (B, H-2, W-2, Co) contiguous; ws holds splits * 9*Ci*Co
// floats; dw (3, 3, Ci, Co) float32. dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error code (0 = ok).
int conv3x3_dw_launch(const void* x, const void* g, void* ws, void* dw, int B, int H, int W,
                      int Ci, int Co, int splits, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, g, (float*)ws, (float*)dw, B, H, W, Ci, Co, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, (float*)ws, (float*)dw, B, H, W, Ci, Co, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
