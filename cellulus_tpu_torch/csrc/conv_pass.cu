// Fused U-Net conv pass for Hopper (sm_90a): one launch computes
//
//   conv3x3+b -> ReLU -> conv1x1+b -> ReLU -> conv1x1+b -> ReLU -> conv3x3+b -> ReLU
//
// all VALID, NHWC, (B, H, W, Cin) -> (B, H-4, W-4, C); weights (kh, kw, cin, C)
// in the compute type, biases f32; f32 accumulation, bias and ReLU in the
// epilogue, every intermediate stored in the compute type (f32 or bf16).
//
// Replaces: cellulus_tpu/ops/pallas_conv.py `_pass_call` / `conv_pass_2d`
// (one Pallas program per row strip, the four stages in VMEM).
//
// What bounds it on the H100: operations. At the main path's widths a pass
// does 30-150 FLOP per byte it must move (input once, output once), far
// above the card's ridge point, so the least time is the FLOPs over the
// peak of the compute type. This version runs on the CUDA cores (f32 FMA,
// 67 TFLOP/s peak), for bf16 too; moving the products onto the tensor
// cores (mma/wgmma) is later work.
//
// What the design does about it: the three intermediates never touch device
// memory. A block owns a TH x TW output tile of one image and keeps the
// (TH+4) x (TW+4) x Cin input tile and the (TH+2) x (TW+2) x C
// intermediates in shared memory, pixel-major with the channel pitch padded
// by 4 (so 8 neighbouring pixels fall in distinct bank groups); the input
// buffer is reused for the stage-2 output, so the footprint is
// A + max(IN, B) plus one weight chunk. Each stage is an implicit GEMM
// (pixels x channels, K = kh*kw*cin): the block stages 32 rows of the
// weights in shared memory as f32, and each thread accumulates a 4-pixel x
// 4-channel register tile from 128-bit shared loads (8 loads per 64 FMAs).
// A warp tile is 32 pixels x 16 channels: lanes sharing pixels read them by
// broadcast, lanes sharing channels read the weights by broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TM = 4;           // pixels per thread, 8 apart within a warp tile
constexpr int TN = 4;           // consecutive channels per thread
constexpr int WT_P = 8 * TM;    // pixels per warp tile
constexpr int WT_C = 4 * TN;    // channels per warp tile
constexpr int MAXT = 4;         // warp tiles a warp carries through one pass over K
constexpr int KC = 32;          // weight rows staged per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void load4(const float* p, float a[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float a[4]) {
  uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 l = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  a[0] = l.x; a[1] = l.y; a[2] = h.x; a[3] = h.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__host__ __device__ inline int pitch_of(int c) { return c % 4 == 0 ? c + 4 : c; }
__host__ __device__ inline int round16(int c) { return (c + 15) / 16 * 16; }
__host__ __device__ inline size_t round8(size_t n) { return (n + 7) / 8 * 8; }

// Shared memory layout: A (stages 1 and 3), X (input tile, then stage 2),
// both in elements of the compute type, then the f32 weight chunk.
__host__ __device__ inline void buffer_elems(int cin, int C, int th, int tw, size_t* a,
                                             size_t* x, size_t* w) {
  const size_t mid = (size_t)(th + 2) * (tw + 2) * pitch_of(C);
  const size_t in = (size_t)(th + 4) * (tw + 4) * pitch_of(cin);
  *a = round8(mid);
  *x = round8(in > mid ? in : mid);
  *w = (size_t)KC * round16(C);
}

// One K x K VALID conv stage of the block's tile.
//   src: (sh, sw) pixels of pitch sp in shared memory, cin channels
//   dst: (oh, ow) pixels of pitch dp in shared memory, or, when
//        gout != nullptr, the image's NHWC output at tile origin
//        (gy0, gx0), clipped to (h_out, w_out)
template <typename T, int K, bool VEC>
__device__ void conv_stage(const T* src, int sw, int sp, int cin,
                           const T* __restrict__ w, const float* __restrict__ b,
                           int oh, int ow, int C, float* wbuf, T* dst, int dp,
                           T* __restrict__ gout, int gy0, int gx0, int h_out, int w_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pg = lane >> 2, cg = lane & 3;
  const int P = oh * ow;
  const int C16 = round16(C);
  const int n_tc = C16 / WT_C;
  const int n_tiles = ((P + WT_P - 1) / WT_P) * n_tc;
  const int ktot = K * K * cin;

  for (int round0 = 0; round0 < n_tiles; round0 += kWarps * MAXT) {
    float acc[MAXT][TM][TN];
    int src_off[MAXT][TM];
    int c0[MAXT];
#pragma unroll
    for (int m = 0; m < MAXT; ++m) {
      const int t = min(round0 + warp + kWarps * m, n_tiles - 1);
      const int tp = t / n_tc;
      c0[m] = (t % n_tc) * WT_C + cg * TN;
      float bias[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bias[j] = c0[m] + j < C ? b[c0[m] + j] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int p = min(tp * WT_P + pg + 8 * i, P - 1);
        src_off[m][i] = ((p / ow) * sw + p % ow) * sp;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[m][i][j] = bias[j];
      }
    }

    for (int k0 = 0; k0 < ktot; k0 += KC) {
      const int kn = min(KC, ktot - k0);
      __syncthreads();  // the previous chunk is no longer read
      for (int idx = threadIdx.x; idx < KC * C16; idx += kThreads) {
        const int kk = idx / C16, c = idx - kk * C16;
        wbuf[idx] = (kk < kn && c < C) ? to_f(w[(size_t)(k0 + kk) * C + c]) : 0.f;
      }
      __syncthreads();
      const int kyx0 = k0 / cin, ci0 = k0 - kyx0 * cin;
#pragma unroll
      for (int m = 0; m < MAXT; ++m) {
        if (round0 + warp + kWarps * m >= n_tiles) continue;  // warp-uniform
        int kyx = kyx0, ci = ci0;
        for (int kk = 0; kk < kn; kk += (VEC ? 4 : 1)) {
          const int soff = ((kyx / K) * sw + kyx % K) * sp + ci;
          if (VEC) {
            float a[TM][4], wv[4][TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) load4(src + src_off[m][i] + soff, a[i]);
#pragma unroll
            for (int q = 0; q < 4; ++q) load4(wbuf + (kk + q) * C16 + c0[m], wv[q]);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[m][i][j] = fmaf(a[i][q], wv[q][j], acc[m][i][j]);
            ci += 4;
          } else {
            float wv[TN];
            load4(wbuf + kk * C16 + c0[m], wv);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float a = to_f(src[src_off[m][i] + soff]);
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[m][i][j] = fmaf(a, wv[j], acc[m][i][j]);
            }
            ci += 1;
          }
          if (ci == cin) {
            ci = 0;
            ++kyx;
          }
        }
      }
    }

#pragma unroll
    for (int m = 0; m < MAXT; ++m) {
      const int t = round0 + warp + kWarps * m;
      if (t >= n_tiles) continue;
      const int tp = t / n_tc;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int p = tp * WT_P + pg + 8 * i;
        if (p >= P) continue;
        float v[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = fmaxf(acc[m][i][j], 0.f);
        T* out;
        if (gout == nullptr) {
          out = dst + p * dp + c0[m];
        } else {
          const int gy = gy0 + p / ow, gx = gx0 + p % ow;
          if (gy >= h_out || gx >= w_out) continue;
          out = gout + ((size_t)gy * w_out + gx) * C + c0[m];
        }
        if (C % 4 == 0) {
          if (c0[m] < C) store4(out, v);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (c0[m] + j < C) out[j] = from_f<T>(v[j]);
        }
      }
    }
  }
}

template <typename T, int K>
__device__ __forceinline__ void stage(const T* src, int sw, int sp, int cin, const T* w,
                                      const float* b, int oh, int ow, int C, float* wbuf,
                                      T* dst, int dp, T* gout, int gy0, int gx0, int h_out,
                                      int w_out) {
  if (cin % 4 == 0)
    conv_stage<T, K, true>(src, sw, sp, cin, w, b, oh, ow, C, wbuf, dst, dp, gout, gy0, gx0,
                           h_out, w_out);
  else
    conv_stage<T, K, false>(src, sw, sp, cin, w, b, oh, ow, C, wbuf, dst, dp, gout, gy0, gx0,
                            h_out, w_out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv_pass_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 const T* __restrict__ w3, const float* __restrict__ b3,
                 const T* __restrict__ w4, const float* __restrict__ b4, T* __restrict__ out,
                 int H, int W, int cin, int C, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t a_elems, x_elems, w_elems;
  buffer_elems(cin, C, th, tw, &a_elems, &x_elems, &w_elems);
  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_x = buf_a + a_elems;
  float* wbuf = reinterpret_cast<float*>(buf_x + x_elems);

  const int h_out = H - 4, w_out = W - 4;
  const int tiles_x = (w_out + tw - 1) / tw;
  const int gy0 = (blockIdx.x / tiles_x) * th;
  const int gx0 = (blockIdx.x % tiles_x) * tw;
  const int img = blockIdx.y;
  const T* xin = x + (size_t)img * H * W * cin;

  // input tile (th+4, tw+4, cin) at pitch pitch_of(cin); zeros past the
  // image edge only feed outputs that are clipped away
  const int iw = tw + 4, ip = pitch_of(cin);
  const int n_in = (th + 4) * iw * cin;
  for (int idx = threadIdx.x; idx < n_in; idx += kThreads) {
    const int p = idx / cin, ci = idx - p * cin;
    const int gy = gy0 + p / iw, gx = gx0 + p % iw;
    buf_x[p * ip + ci] =
        (gy < H && gx < W) ? xin[((size_t)gy * W + gx) * cin + ci] : from_f<T>(0.f);
  }
  // (the first weight chunk's __syncthreads orders these writes before use)
  const int mh = th + 2, mw = tw + 2, mp = pitch_of(C);
  stage<T, 3>(buf_x, iw, ip, cin, w1, b1, mh, mw, C, wbuf, buf_a, mp, nullptr, 0, 0, 0, 0);
  __syncthreads();
  stage<T, 1>(buf_a, mw, mp, C, w2, b2, mh, mw, C, wbuf, buf_x, mp, nullptr, 0, 0, 0, 0);
  __syncthreads();
  stage<T, 1>(buf_x, mw, mp, C, w3, b3, mh, mw, C, wbuf, buf_a, mp, nullptr, 0, 0, 0, 0);
  __syncthreads();
  stage<T, 3>(buf_a, mw, mp, C, w4, b4, th, tw, C, wbuf, nullptr, 0,
              out + (size_t)img * h_out * w_out * C, gy0, gx0, h_out, w_out);
}

template <typename T>
size_t smem_bytes(int cin, int C, int th, int tw) {
  size_t a_elems, x_elems, w_elems;
  buffer_elems(cin, C, th, tw, &a_elems, &x_elems, &w_elems);
  return (a_elems + x_elems) * sizeof(T) + w_elems * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           const void* w3, const float* b3, const void* w4, const float* b4, void* out, int B,
           int H, int W, int cin, int C, int th, int tw, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(cin, C, th, tw);
  cudaError_t err = cudaFuncSetAttribute(conv_pass_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((H - 4 + th - 1) / th) * ((W - 4 + tw - 1) / tw);
  dim3 grid(tiles, B);
  conv_pass_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)w3, b3, (const T*)w4, b4,
      (T*)out, H, W, cin, C, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for a th x tw output tile;
// elem_bytes is 4 (float32) or 2 (bfloat16).
long long conv_pass_2d_smem_bytes(int cin, int C, int th, int tw, int elem_bytes) {
  return (long long)(elem_bytes == 2 ? smem_bytes<__nv_bfloat16>(cin, C, th, tw)
                                     : smem_bytes<float>(cin, C, th, tw));
}

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code (0 = ok).
int conv_pass_2d_launch(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, const void* w4,
                        const void* b4, void* out, int B, int H, int W, int cin, int C,
                        int th, int tw, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w1, (const float*)b1, w2, (const float*)b2, w3, (const float*)b3,
                         w4, (const float*)b4, out, B, H, W, cin, C, th, tw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, (const float*)b1, w2, (const float*)b2, w3,
                                 (const float*)b3, w4, (const float*)b4, out, B, H, W, cin, C,
                                 th, tw, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
