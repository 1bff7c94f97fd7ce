// Filter gradient of a VALID stride-1 3x3 conv for Hopper (sm_90a):
//
//   dw[ky, kx, ci, co] = sum_{b, y, x} x[b, y + ky, x + kx, ci] * g[b, y, x, co]
//
// x (B, H, W, Ci) and g (B, H-2, W-2, Co), NHWC, both float32 or both
// bfloat16; dw (3, 3, Ci, Co) float32. Products and sums are float32 for
// both input types. Float32 inputs are NOT rounded to bfloat16: the JAX
// package's default float32 train step takes XLA's float32 filter gradient,
// and rounding the operands would move float32 training off it by about
// 1e-2 relative. Bfloat16 inputs are exactly what the TPU kernel feeds its
// matrix unit.
//
// Replaces: cellulus_tpu/ops/pallas_dw.py `_dw_kernel` / `conv3x3_dw`, the
// backward of `conv_valid_pallas` (cellulus_tpu/ops/conv_vjp.py). The TPU
// kernel's packed (3Ci, 3Co) output block, its 8-aligned width padding and
// its halo gather exist only for Mosaic and are not carried over.
//
// What bounds it on the H100: operations. The function is one GEMM with
// M = 9*Ci (tap x input channel), N = Co and a very tall K = B*Ho*Wo
// (pixels); at the train step's widths it does 300-1100 FLOP per byte of
// x and g, far above the card's ridge point, so the least time is the
// FLOPs over the peak of the input type. This version runs on the CUDA
// cores (f32 FMA), for bfloat16 too; the tensor cores (mma/wgmma, TMA) are
// later work.
//
// What the design does about it:
// - Split K over pixel chunks. A block owns one (Ci block x Co block) tile of
//   the output for all nine taps and walks a contiguous range of chunks; a
//   chunk is a TY x TX patch of output pixels of one image. The block stages
//   the chunk's g patch and its x patch with a 2-row, 2-column halo in
//   shared memory.
// - Each thread owns one input channel and 8 output channels, all 9 taps:
//   72 f32 accumulators in registers. It walks a row of the patch with a
//   sliding 3x3 window of x values in registers, so a pixel costs 3 shared
//   loads of x and two 16-byte loads of g for 72 FMAs.
// - Threads that share a (ci, co) slot but walk different rows (KS groups)
//   are summed in shared memory in a fixed order at the end; each block
//   writes its partial tile to a float32 workspace slot, and a second kernel
//   sums the slots in a fixed order. No atomics: the result is
//   deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    // g patch (ty, TX, nb): zeros outside the image and past Co
    const int n_g = p.ty * TX * p.nb;
    for (int idx = t; idx < n_g; idx += kThreads) {
      const int co_l = idx % p.nb;
      const int px = idx / p.nb;
      const int gy = y0 + px / TX, gx = x0 + px % TX, co = co0 + co_l;
      T v = zero<T>();
      if (gy < Ho && gx < Wo && co < Co) v = g[(((size_t)b * Ho + gy) * Wo + gx) * Co + co];
      gs[idx] = v;
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
  Plan plan;
  int n_ci_blocks, n_co_blocks, chunks_y, chunks_x;
  long long n_chunks;
};

Grid make_grid(int B, int H, int W, int Ci, int Co) {
  Grid gr;
  gr.plan = make_plan(Ci, Co);
  gr.n_ci_blocks = (Ci + gr.plan.tci - 1) / gr.plan.tci;
  gr.n_co_blocks = (Co + gr.plan.nb - 1) / gr.plan.nb;
  gr.chunks_y = (H - 2 + gr.plan.ty - 1) / gr.plan.ty;
  gr.chunks_x = (W - 2 + gr.plan.tx - 1) / gr.plan.tx;
  gr.n_chunks = (long long)B * gr.chunks_y * gr.chunks_x;
  return gr;
}

template <typename T, int TX>
int launch_partial(const void* x, const void* g, float* ws, int B, int H, int W, int Ci, int Co,
                   int splits, const Grid& gr, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(gr.plan);
  cudaError_t err = cudaFuncSetAttribute(conv_dw_partial_kernel<T, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_split = (int)((gr.n_chunks + splits - 1) / splits);
  dim3 grid(gr.n_ci_blocks * gr.n_co_blocks, splits);
  conv_dw_partial_kernel<T, TX><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)g, ws, B, H, W, Ci, Co, gr.plan, gr.n_ci_blocks, gr.chunks_y,
      gr.chunks_x, per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, float* ws, float* dw, int B, int H, int W, int Ci, int Co,
           int splits, cudaStream_t stream) {
  const Grid gr = make_grid(B, H, W, Ci, Co);
  const int rc = gr.plan.tx == 8
                     ? launch_partial<T, 8>(x, g, ws, B, H, W, Ci, Co, splits, gr, stream)
                     : launch_partial<T, 32>(x, g, ws, B, H, W, Ci, Co, splits, gr, stream);
  if (rc != 0) return rc;
  const size_t n = (size_t)9 * Ci * Co;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  conv_dw_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace slots (pixel splits) for these shapes: about four blocks per SM
// in all, at most one slot per pixel chunk.
int conv3x3_dw_splits(int B, int H, int W, int Ci, int Co) {
  const Grid gr = make_grid(B, H, W, Ci, Co);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = gr.n_ci_blocks * gr.n_co_blocks;
  long long splits = (4LL * sms + tiles - 1) / tiles;
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
