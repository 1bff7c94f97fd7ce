// Fused U-Net conv pass for Hopper (sm_90a): one launch computes
//
//   conv3x3+b -> ReLU -> conv1x1+b -> ReLU -> conv1x1+b -> ReLU -> conv3x3+b -> ReLU
//
// all VALID, NHWC, (B, H, W, Cin) -> (B, H-4, W-4, C); weights (kh, kw, cin, C)
// in the compute type, biases f32; f32 accumulation, bias and ReLU in the
// epilogue, every intermediate stored in the compute type (f32 or bf16), so
// the rounding points are those of conv_pass_2d_plain.
//
// Replaces: cellulus_tpu/ops/pallas_conv.py `_pass_call` / `conv_pass_2d`
// (one Pallas program per row strip, the four stages in VMEM).
//
// What bounds it on the H100: operations. At the main path's widths a pass
// does 30-150 FLOP per byte it must move (input once, output once), far
// above the card's ridge point, so the least time is the FLOPs over the
// tensor-core peak of the compute type (bf16 989 TFLOP/s; float32 as
// 3xTF32, 495 / 3 = 165 TFLOP/s).
//
// What the design does about it:
// - The three intermediates never touch device memory. A block owns a
//   TH x TW output tile of one image and keeps the (TH+4) x (TW+4) input
//   tile and the (TH+2) x (TW+2) intermediates in shared memory,
//   pixel-major, channels zero-padded to a multiple of 16 and the pixel
//   pitch padded so that eight neighbouring pixels fall in distinct banks
//   (bf16: +8 elements, odd 16-byte units for ldmatrix rows; f32: +4).
//   The input buffer is reused for the stage-2 output, so the footprint is
//   A + max(IN, B) plus the weight ring. A block's time is mostly per
//   weight chunk and round of warp units, not per pixel, so the tile sets
//   the speed (on the H100 the bf16 up pass takes 62 ms at 8 x 8, 22 ms at
//   14 x 14 and 29 ms at 16 x 16, whose stage 1 needs a second round:
//   scripts/torch_kernel_check.py tiles). The wrapper takes, of the square
//   tiles that fit (conv_pass_2d_smem_bytes), the one conv_pass_2d_cost
//   rates cheapest.
// - A wide input (cin >= 128, the up pass) is not held: stage 1 streams it
//   through the ring, 16 (bf16) or 8 (f32) channels of the input tile at a
//   time with their weight rows for all 9 taps, and only the two
//   intermediates stay resident. That takes the up pass from 12 x 12 to
//   16 x 16 tiles in bf16 and from 8 x 8 to 14 x 14 in f32.
// - A wide pass whose fused plan fits no tile (the 256-fmap model's bottom
//   pass, 256 -> 768: its ring stage alone holds 9 x scb weight rows of
//   width C) takes the staged route, chosen by shape in the wrapper: one
//   launch per stage (conv_stage_kernel), each intermediate in device memory
//   in the compute type, so the rounding points stay those of
//   conv_pass_2d_plain. A block owns a 16 x 16 tile of the stage's output
//   and NB = 64 (bf16) or 32 (f32) of its channels, and streams its input
//   tile through the ring scb channels at a time (4 x scb for a 1 x 1 stage)
//   with the weight rows of those channels and its NB columns, so its shared
//   memory does not grow with C or cin. At C = 768 a pass does several
//   hundred FLOP per byte whether or not its intermediates leave the chip.
// - Each stage is an implicit GEMM on the tensor cores: M = pixels of the
//   stage's output grid, N = C, K = kh * kw * cinp (cin zero-padded to the
//   mma depth, 16 in bf16 and 8 in f32, which is how the down pass's
//   cin = 1 reaches it). The 8
//   warps take units of the stage's output in rounds: bf16, 32 pixels x 64
//   channels (two m16 by eight n8 tiles); f32, 32 pixels x 32 channels,
//   since its tiles are smaller (8 x 8 at C = 192) and a wider unit would
//   leave warps idle (and spill: 64 accumulators and 64 partial sums). M rows past the grid read a clamped pixel
//   and are not stored. A fragments come from the activation tile at the
//   tap-shifted pixel of each row (one row address per lane), B fragments
//   from the weights, which stream through a cp.async ring (3 stages in
//   bf16, 2 in f32) of 64-row chunks (32 for C > 64) in the compute type,
//   so the next chunk loads while this one multiplies. Each k step's
//   fragments are loaded before the previous step's mma's are issued.
// - bf16: mma.sync m16n8k16, A by ldmatrix, B by ldmatrix.trans. f32:
//   3xTF32 (mma_tile.cuh) with fragments by 32-bit shared loads, the three
//   products issued in three passes over the unit's n8 tiles so that no
//   mma waits on the one before; each chunk is summed from zero and added
//   to the running sum in float32, since the tensor cores round their
//   accumulator toward zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int kThreads = 256;
constexpr int KC_MAX = 144;  // weight rows per ring stage, at most

// Per compute type: the warp's unit (mt m16 tiles of pixels x nt n8 tiles
// of channels), ring stages, activation pitch padding, input channels per
// ring stage when stage 1 streams its input, and the multiple of the mma
// depth that each tap's input channels are zero-padded to in K.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int mt = 2, nt = 8, stages = 3, pad = 8, scb = 16, kpad = 16;
};
template <> struct Cfg<float> {
  static constexpr int mt = 2, nt = 4, stages = 2, pad = 4, scb = 8, kpad = 8;
};

// Weight rows per ring stage: 64 where the rows are narrow (C <= 64), so a
// barrier is passed half as often; 32 for wider C, whose rows would not fit.
__host__ __device__ inline int kc_rows(int C) { return C <= 64 ? 64 : 32; }

__host__ __device__ inline int round16(int c) { return (c + 15) / 16 * 16; }
__host__ __device__ inline size_t round8(size_t n) { return (n + 7) / 8 * 8; }

// elements per pixel of an activation tile with c channels
template <typename T>
__host__ __device__ inline int act_pitch(int c) { return round16(c) + Cfg<T>::pad; }
// elements per row of a weight chunk with C output channels
__host__ __device__ inline int w_pitch(int C) { return round16(C) + 8; }

// A wide input (the up pass, cin = 256): stage 1 streams its input through
// the ring, scb channels of the (TH+4) x (TW+4) tile at a time with their
// 9 * scb weight rows, instead of holding the whole input tile (150 KB in
// f32 at 8 x 8), so a larger output tile fits. Chosen by shape.
template <typename T>
__host__ __device__ inline bool stream_input(int cin) {
  return cin >= 128 && cin % Cfg<T>::scb == 0;
}
// elements per pixel of a streamed input slice of SB channels (odd 16-byte
// units for ldmatrix rows; 8 pixels x 4 lanes over 32 banks for the f32
// fragments)
template <typename T, int SB>
__host__ __device__ inline int slice_pitch() { return SB + Cfg<T>::pad; }
template <typename T, int SB>
__host__ __device__ inline size_t slice_elems(int ih, int iw) {
  return round8((size_t)ih * iw * slice_pitch<T, SB>());
}

// Elements of one ring stage: a weight chunk, or a streamed input slice and
// its weight rows.
template <typename T>
__host__ __device__ inline size_t ring_stage_elems(int cin, int C, int th, int tw) {
  const size_t chunk = (size_t)kc_rows(C) * w_pitch(C);
  if (!stream_input<T>(cin)) return chunk;
  const size_t streamed =
      slice_elems<T, Cfg<T>::scb>(th + 4, tw + 4) + (size_t)9 * Cfg<T>::scb * w_pitch(C);
  return streamed > chunk ? streamed : chunk;
}

// The staged route: output channels per block, and input channels per ring
// stage of a K x K stage whose input has cin channels (a 1 x 1 stage takes
// 4 x scb where cin allows, so that a ring stage holds 64 or 32 rows of K).
template <typename T>
__host__ __device__ inline constexpr int staged_nb() { return 8 * Cfg<T>::nt; }
template <typename T>
__host__ __device__ inline int staged_sb(int K, int cin) {
  return K == 1 && cin % (4 * Cfg<T>::scb) == 0 ? 4 * Cfg<T>::scb : Cfg<T>::scb;
}
// Elements of one ring stage of the staged route: the (th+K-1) x (tw+K-1)
// input slice and its K * K * SB weight rows of NB columns.
template <typename T, int K, int SB>
__host__ __device__ inline size_t staged_ring_elems(int th, int tw) {
  return slice_elems<T, SB>(th + K - 1, tw + K - 1) + (size_t)K * K * SB * w_pitch(staged_nb<T>());
}

// Shared memory layout, in elements of the compute type: A (stages 1 and
// 3), X (input tile unless stage 1 streams it, then stage 2), the ring.
template <typename T>
__host__ __device__ inline void buffer_elems(int cin, int C, int th, int tw, size_t* a,
                                             size_t* x, size_t* w) {
  const size_t mid = (size_t)(th + 2) * (tw + 2) * act_pitch<T>(C);
  const size_t in =
      stream_input<T>(cin) ? 0 : (size_t)(th + 4) * (tw + 4) * act_pitch<T>(cin);
  *a = round8(mid);
  *x = round8(in > mid ? in : mid);
  *w = (size_t)Cfg<T>::stages * ring_stage_elems<T>(cin, C, th, tw);
}

// Rows [k0, k0 + kc_rows(C)) of one stage's weights, K ordered (tap, ci < cinp),
// into a ring stage: zeros for ci >= cin, k >= ktot and columns >= C. A row
// of w is ldc elements apart (ldc = C but in the staged route, whose block
// takes C of the stage's ldc columns).
template <typename T>
__device__ __forceinline__ void load_w_chunk(T* dst, const T* __restrict__ w, int k0, int ktot,
                                             int cin, int cinp, int C, int ldc) {
  constexpr int V = 16 / sizeof(T);
  const int C16 = round16(C), wp = w_pitch(C);
  const int nv = C16 / V, KC = kc_rows(C);
  if (C % V == 0 && ldc % V == 0) {
    for (int idx = threadIdx.x; idx < KC * nv; idx += kThreads) {
      const int r = idx / nv, col = (idx - r * nv) * V;
      const int k = k0 + r, tap = k / cinp, ci = k - tap * cinp;
      const bool ok = k < ktot && ci < cin && col < C;
      const T* src = ok ? w + ((size_t)tap * cin + ci) * ldc + col : w;
      cp_async16(dst + r * wp + col, src, ok ? 16 : 0);
    }
  } else {  // rows not 16-byte aligned: plain loads (ordered by the ring's barrier)
    for (int idx = threadIdx.x; idx < KC * C16; idx += kThreads) {
      const int r = idx / C16, col = idx - r * C16;
      const int k = k0 + r, tap = k / cinp, ci = k - tap * cinp;
      const bool ok = k < ktot && ci < cin && col < C;
      dst[r * wp + col] = ok ? w[((size_t)tap * cin + ci) * ldc + col] : T(0.f);
    }
  }
}

// Ring stage for input channels [cb, cb + SB) of a streamed K x K stage:
// the slice of the ih x iw input tile at slice_pitch (zeros past the image
// edge), then the weight rows (tap, ci) of those channels (row stride ldc).
template <typename T, int K, int SB>
__device__ __forceinline__ void load_stream_chunk(T* dst, const T* __restrict__ xin, int H,
                                                  int W, int cin, int gy0, int gx0, int ih,
                                                  int iw, const T* __restrict__ w, int cb,
                                                  int C, int ldc) {
  constexpr int V = 16 / sizeof(T), SP = SB + Cfg<T>::pad;
  const int n_pix = ih * iw;
  for (int idx = threadIdx.x; idx < n_pix * (SB / V); idx += kThreads) {
    const int p = idx / (SB / V), c = (idx % (SB / V)) * V;
    const int gy = gy0 + p / iw, gx = gx0 + p % iw;
    const bool ok = gy < H && gx < W;
    const T* src = ok ? xin + ((size_t)gy * W + gx) * cin + cb + c : xin;
    cp_async16(dst + p * SP + c, src, ok ? 16 : 0);
  }
  T* wd = dst + slice_elems<T, SB>(ih, iw);
  const int C16 = round16(C), wp = w_pitch(C);
  if (C % V == 0 && ldc % V == 0) {
    const int nv = C16 / V;
    for (int idx = threadIdx.x; idx < K * K * SB * nv; idx += kThreads) {
      const int r = idx / nv, col = (idx - r * nv) * V;
      const int tap = r / SB, ci = cb + r % SB;
      const bool ok = col < C;
      const T* src = ok ? w + ((size_t)tap * cin + ci) * ldc + col : w;
      cp_async16(wd + r * wp + col, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < K * K * SB * C16; idx += kThreads) {
      const int r = idx / C16, col = idx - r * C16;
      const int tap = r / SB, ci = cb + r % SB;
      wd[r * wp + col] = col < C ? w[((size_t)tap * cin + ci) * ldc + col] : T(0.f);
    }
  }
}

// Offset in a source tile of pixel p of a stage's (oh, ow) output grid
// (rows past P clamp to P - 1; their results are not stored).
__device__ __forceinline__ int pixel_offset(int p, int P, int ow, int sw, int sp) {
  p = min(p, P - 1);
  return ((p / ow) * sw + p % ow) * sp;
}

struct StageGeom {
  int sw, sp, cinp, n0, C16, wp;
};

// Where a streamed stage reads its input: the image, its size, the block's
// input tile origin and the input tile's size.
template <typename T>
struct StreamSrc {
  const T* x;
  int H, W, gy0, gx0, ih, iw;
};

// Source offset of row k0 + kk of a K x K stage's K order (tap, ci), where
// the chunk starts at tap0, ci0; a streamed chunk (SB = scb) is 9 taps of
// SB channels from tap 0, so its tap and channel are known at compile time.
template <int K, int SB>
__device__ __forceinline__ int tap_shift(const StageGeom& s, int tap0, int ci0, int kk) {
  int tap, ci;
  if (SB > 0) {
    tap = kk / SB;
    ci = kk % SB;
  } else {
    tap = tap0;
    ci = ci0 + kk;
    while (ci >= s.cinp) {
      ci -= s.cinp;
      ++tap;
    }
  }
  return ((tap / K) * s.sw + tap % K) * s.sp + ci;
}

// Ring stage rows 0 .. kn - 1 (kn a multiple of 16; the stage starts at
// tap0, ci0 of the K order) into acc. The fragments of the next k step are
// loaded before the mma's of this one are issued.
// bf16: off[mi][0] is the source offset of this lane's ldmatrix row of m16
// tile mi, with its k half.
constexpr int kMtB = Cfg<__nv_bfloat16>::mt, kNtB = Cfg<__nv_bfloat16>::nt;
template <int K, int SB>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* src, const int off[kMtB][2],
                                          const __nv_bfloat16* wc, int tap0, int ci0, int kn,
                                          const StageGeom& s, float acc[kMtB][kNtB][4]) {
  const int lane = threadIdx.x & 31;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  uint32_t a[2][kMtB][4], b[2][kNtB / 2][4];
  auto load = [&](int buf, int kk) {
    const int shift = tap_shift<K, SB>(s, tap0, ci0, kk);
#pragma unroll
    for (int mi = 0; mi < kMtB; ++mi) ldmatrix_x4(a[buf][mi], src + off[mi][0] + shift);
#pragma unroll
    for (int np = 0; np < kNtB / 2; ++np)
      if (s.n0 + np * 16 < s.C16)
        ldmatrix_x4_trans(b[buf][np], wc + (kk + b_k) * s.wp + s.n0 + np * 16 + b_n);
  };
  load(0, 0);
#pragma unroll
  for (int kk = 0; kk < KC_MAX; kk += 16) {
    if (kk >= kn) break;
    const int cur = (kk / 16) & 1;
    if (kk + 16 < kn) load(cur ^ 1, kk + 16);
#pragma unroll
    for (int np = 0; np < kNtB / 2; ++np) {
      if (s.n0 + np * 16 >= s.C16) break;
#pragma unroll
      for (int mi = 0; mi < kMtB; ++mi) {
        mma_bf16(acc[mi][2 * np], a[cur][mi], b[cur][np]);
        mma_bf16(acc[mi][2 * np + 1], a[cur][mi], b[cur][np] + 2);
      }
    }
  }
}

// f32: off[mi][h] is the source offset of row g + 8h of m16 tile mi. The
// tensor cores round a float32 accumulator toward zero, so the chunk's sum
// starts from zero and is added to acc with an ordinary (round to nearest)
// float32 add: over K = 9 * 256 the drift would otherwise reach 1e-4. The
// three products go in three passes over the n8 tiles, so that no mma waits
// on the one before it.
constexpr int kMtF = Cfg<float>::mt, kNtF = Cfg<float>::nt;
template <int K, int SB>
__device__ __forceinline__ void mma_chunk(const float* src, const int off[kMtF][2],
                                          const float* wc, int tap0, int ci0, int kn,
                                          const StageGeom& s, float acc[kMtF][kNtF][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float part[kMtF][kNtF][4];
#pragma unroll
  for (int mi = 0; mi < kMtF; ++mi)
#pragma unroll
    for (int j = 0; j < kNtF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[mi][j][r] = 0.f;
  float ra[2][kMtF][4], rb[2][kNtF][2];
  auto load = [&](int buf, int kk) {
    const int shift = tap_shift<K, SB>(s, tap0, ci0, kk) + tq;
#pragma unroll
    for (int mi = 0; mi < kMtF; ++mi) {
      const float* p0 = src + off[mi][0] + shift;
      const float* p1 = src + off[mi][1] + shift;
      ra[buf][mi][0] = p0[0];
      ra[buf][mi][1] = p1[0];
      ra[buf][mi][2] = p0[4];
      ra[buf][mi][3] = p1[4];
    }
#pragma unroll
    for (int j = 0; j < kNtF; ++j) {  // tiles past C16 read the last one, unused
      const float* p = wc + (kk + tq) * s.wp + min(s.n0 + j * 8, s.C16 - 8) + gq;
      rb[buf][j][0] = p[0];
      rb[buf][j][1] = p[4 * s.wp];
    }
  };
  load(0, 0);
#pragma unroll
  for (int kk = 0; kk < KC_MAX; kk += 8) {
    if (kk >= kn) break;
    const int cur = (kk / 8) & 1;
    uint32_t a_hi[kMtF][4], a_lo[kMtF][4], b_hi[kNtF][2], b_lo[kNtF][2];
#pragma unroll
    for (int mi = 0; mi < kMtF; ++mi) split_frag<4>(ra[cur][mi], a_hi[mi], a_lo[mi]);
#pragma unroll
    for (int j = 0; j < kNtF; ++j) split_frag<2>(rb[cur][j], b_hi[j], b_lo[j]);
    if (kk + 8 < kn) load(cur ^ 1, kk + 8);
#pragma unroll
    for (int j = 0; j < kNtF; ++j)
#pragma unroll
      for (int mi = 0; mi < kMtF; ++mi) mma_tf32(part[mi][j], a_lo[mi], b_hi[j]);
#pragma unroll
    for (int j = 0; j < kNtF; ++j)
#pragma unroll
      for (int mi = 0; mi < kMtF; ++mi) mma_tf32(part[mi][j], a_hi[mi], b_lo[j]);
#pragma unroll
    for (int j = 0; j < kNtF; ++j)
#pragma unroll
      for (int mi = 0; mi < kMtF; ++mi) mma_tf32(part[mi][j], a_hi[mi], b_hi[j]);
  }
#pragma unroll
  for (int mi = 0; mi < kMtF; ++mi)
#pragma unroll
    for (int j = 0; j < kNtF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] += part[mi][j][r];
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 round_to(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// One K x K VALID conv stage of the block's tile.
//   src: (sh, sw) pixels of pitch sp in shared memory, cin channels
//   dst: (oh, ow) pixels of pitch dp in shared memory, or, when
//        gout != nullptr, the image's NHWC output at tile origin
//        (gy0, gx0), clipped to (h_out, w_out)
// C output channels, whose weight rows and output pixels are ldc elements
// apart in device memory (ldc = C but in the staged route). Warps take
// units of (MT*16 pixels x NT*8 channels) in rounds; every round streams
// the stage's weights through the ring once, ring stages of ring_stride
// elements. SB > 0: src is the global input in ss, streamed through the
// ring SB channels at a time (sw, sp describe the slice).
template <typename T, int K, int SB = 0>
__device__ __forceinline__ void conv_stage(const T* src, int sw, int sp, int cin,
                                           const T* __restrict__ w, const float* __restrict__ bias,
                                           int oh, int ow, int C, int ldc, T* ring,
                                           int ring_stride, T* dst, int dp, T* __restrict__ gout,
                                           int gy0, int gx0, int h_out, int w_out,
                                           StreamSrc<T> ss = {}) {
  constexpr int S = Cfg<T>::stages, MT = Cfg<T>::mt, NT = Cfg<T>::nt;
  constexpr int WARPS = kThreads / 32, UM = 16 * MT, UN = 8 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int P = oh * ow;
  StageGeom s;
  s.sw = sw;
  s.sp = sp;
  s.cinp = (cin + Cfg<T>::kpad - 1) / Cfg<T>::kpad * Cfg<T>::kpad;
  s.C16 = round16(C);
  s.wp = w_pitch(C);
  const int ktot = K * K * s.cinp;
  const int KC = SB > 0 ? K * K * SB : kc_rows(C);
  const int n_chunks = SB > 0 ? cin / SB : (ktot + KC - 1) / KC;
  // a streamed ring stage holds the input slice first, its weights after it
  const int w_at = SB > 0 ? (int)slice_elems<T, (SB > 0 ? SB : 1)>(ss.ih, ss.iw) : 0;
  auto load = [&](int i) {
    T* dst_i = ring + (i % S) * ring_stride;
    if constexpr (SB > 0)
      load_stream_chunk<T, K, SB>(dst_i, ss.x, ss.H, ss.W, cin, ss.gy0, ss.gx0, ss.ih, ss.iw, w,
                                  i * SB, C, ldc);
    else
      load_w_chunk(dst_i, w, i * KC, ktot, cin, s.cinp, C, ldc);
  };
  const int n_m = (P + UM - 1) / UM, n_n = (s.C16 + UN - 1) / UN;
  const int n_units = n_m * n_n;

  for (int round0 = 0; round0 < n_units; round0 += WARPS) {
    const int unit = round0 + warp;
    const bool active = unit < n_units;
    const int m0 = (unit % n_m) * UM;
    s.n0 = (unit / n_m) * UN;
    int off[MT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (sizeof(T) == 2) {  // ldmatrix: this lane's row, and its k half
        const int m = (lane & 7) + ((lane >> 3) & 1) * 8;
        off[mi][0] = pixel_offset(m0 + mi * 16 + m, P, ow, sw, sp) + (lane >> 4) * 8;
        off[mi][1] = 0;
      } else {
        off[mi][0] = pixel_offset(m0 + mi * 16 + gq, P, ow, sw, sp);
        off[mi][1] = pixel_offset(m0 + mi * 16 + gq + 8, P, ow, sw, sp);
      }
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;

    __syncthreads();  // the ring's previous contents and src are settled
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < n_chunks) load(i);
      cp_async_commit();
    }
    for (int kc = 0; kc < n_chunks; ++kc) {
      cp_async_wait<S - 2>();
      __syncthreads();
      if (kc + S - 1 < n_chunks) load(kc + S - 1);
      cp_async_commit();
      if (active) {
        const T* stage = ring + (kc % S) * ring_stride;
        if (SB > 0) {
          mma_chunk<K, SB>(stage, off, stage + w_at, 0, 0, KC, s, acc);
        } else {
          const int tap0 = kc * KC / s.cinp;
          mma_chunk<K, SB>(src, off, stage, tap0, kc * KC - tap0 * s.cinp,
                           min(KC, ktot - kc * KC), s, acc);
        }
      }
    }
    if (!active) continue;

    // bias + ReLU, rounded to the compute type; padded channels (C..C16)
    // come out as zeros, which the next stage's zero weight rows ignore
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ch = s.n0 + j * 8 + 2 * tq;
      if (s.n0 + j * 8 >= s.C16) break;
      const float b0 = ch < C ? bias[ch] : 0.f, b1 = ch + 1 < C ? bias[ch + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + mi * 16 + gq + 8 * h;
          if (p >= P) continue;
          const float v0 = fmaxf(acc[mi][j][2 * h] + b0, 0.f);
          const float v1 = fmaxf(acc[mi][j][2 * h + 1] + b1, 0.f);
          if (gout == nullptr) {
            store_pair(dst + p * dp + ch, v0, v1);
          } else {
            const int gy = gy0 + p / ow, gx = gx0 + p % ow;
            if (gy >= h_out || gx >= w_out) continue;
            T* o = gout + ((size_t)gy * w_out + gx) * ldc;
            if (ch < C) o[ch] = round_to(v0, o);
            if (ch + 1 < C) o[ch + 1] = round_to(v1, o);
          }
        }
      }
    }
  }
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
  buffer_elems<T>(cin, C, th, tw, &a_elems, &x_elems, &w_elems);
  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_x = buf_a + a_elems;
  T* ring = buf_x + x_elems;
  const int ring_stride = (int)ring_stage_elems<T>(cin, C, th, tw);

  const int h_out = H - 4, w_out = W - 4;
  const int tiles_x = (w_out + tw - 1) / tw;
  const int gy0 = (blockIdx.x / tiles_x) * th;
  const int gx0 = (blockIdx.x % tiles_x) * tw;
  const int img = blockIdx.y;
  const T* xin = x + (size_t)img * H * W * cin;

  const int iw = tw + 4, mh = th + 2, mw = tw + 2, mp = act_pitch<T>(C);
  if (stream_input<T>(cin)) {
    const StreamSrc<T> ss = {xin, H, W, gy0, gx0, th + 4, iw};
    conv_stage<T, 3, Cfg<T>::scb>(nullptr, iw, slice_pitch<T, Cfg<T>::scb>(), cin, w1, b1, mh,
                                  mw, C, C, ring, ring_stride, buf_a, mp, nullptr, 0, 0, 0, 0,
                                  ss);
    conv_stage<T, 1>(buf_a, mw, mp, C, w2, b2, mh, mw, C, C, ring, ring_stride, buf_x, mp,
                     nullptr, 0, 0, 0, 0);
    conv_stage<T, 1>(buf_x, mw, mp, C, w3, b3, mh, mw, C, C, ring, ring_stride, buf_a, mp,
                     nullptr, 0, 0, 0, 0);
    conv_stage<T, 3>(buf_a, mw, mp, C, w4, b4, th, tw, C, C, ring, ring_stride, nullptr, 0,
                     out + (size_t)img * h_out * w_out * C, gy0, gx0, h_out, w_out);
    return;
  }

  // input tile (th+4, tw+4, cin16) at pitch act_pitch(cin); zeros past the
  // image edge (they only feed outputs that are clipped away) and past cin
  constexpr int V = 16 / sizeof(T);
  const int ip = act_pitch<T>(cin), cin16 = round16(cin);
  const int n_pix = (th + 4) * iw;
  if (cin % V == 0) {
    const int nv = cin16 / V;
    for (int idx = threadIdx.x; idx < n_pix * nv; idx += kThreads) {
      const int p = idx / nv, ci = (idx - p * nv) * V;
      const int gy = gy0 + p / iw, gx = gx0 + p % iw;
      const bool ok = gy < H && gx < W && ci < cin;
      const T* src = ok ? xin + ((size_t)gy * W + gx) * cin + ci : xin;
      cp_async16(buf_x + p * ip + ci, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < n_pix * cin16; idx += kThreads) {
      const int p = idx / cin16, ci = idx - p * cin16;
      const int gy = gy0 + p / iw, gx = gx0 + p % iw;
      buf_x[p * ip + ci] =
          (gy < H && gx < W && ci < cin) ? xin[((size_t)gy * W + gx) * cin + ci] : T(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  // (the first stage's barrier orders these writes before use)
  conv_stage<T, 3>(buf_x, iw, ip, cin, w1, b1, mh, mw, C, C, ring, ring_stride, buf_a, mp,
                   nullptr, 0, 0, 0, 0);
  conv_stage<T, 1>(buf_a, mw, mp, C, w2, b2, mh, mw, C, C, ring, ring_stride, buf_x, mp, nullptr,
                   0, 0, 0, 0);
  conv_stage<T, 1>(buf_x, mw, mp, C, w3, b3, mh, mw, C, C, ring, ring_stride, buf_a, mp, nullptr,
                   0, 0, 0, 0);
  conv_stage<T, 3>(buf_a, mw, mp, C, w4, b4, th, tw, C, C, ring, ring_stride, nullptr, 0,
                   out + (size_t)img * h_out * w_out * C, gy0, gx0, h_out, w_out);
}

// One K x K stage of the staged route: (B, H, W, cin) -> (B, H-K+1, W-K+1, C)
// in the compute type. Block (tile, channel block, image) computes a th x tw
// output tile and NB output channels, its input streamed through the ring.
template <typename T, int K, int SB>
__global__ void __launch_bounds__(kThreads, 1)
conv_stage_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ b,
                  T* __restrict__ out, int H, int W, int cin, int C, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NB = staged_nb<T>();
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int ring_stride = (int)staged_ring_elems<T, K, SB>(th, tw);
  const int h_out = H - K + 1, w_out = W - K + 1;
  const int tiles_x = (w_out + tw - 1) / tw;
  const int gy0 = (blockIdx.x / tiles_x) * th;
  const int gx0 = (blockIdx.x % tiles_x) * tw;
  const int n0 = blockIdx.y * NB, img = blockIdx.z;
  const int ih = th + K - 1, iw = tw + K - 1;
  const StreamSrc<T> ss = {x + (size_t)img * H * W * cin, H, W, gy0, gx0, ih, iw};
  conv_stage<T, K, SB>(nullptr, iw, slice_pitch<T, SB>(), cin, w + n0, b + n0, th, tw,
                       min(NB, C - n0), C, ring, ring_stride, nullptr, 0,
                       out + (size_t)img * h_out * w_out * C + n0, gy0, gx0, h_out, w_out, ss);
}

// Relative cost of a pass with th x tw tiles over an H x W input: blocks x
// (rounds x K rows) summed over the four stages. A block's time is mostly
// per weight chunk and round, so this orders the tiles that fit as the card
// does (scripts/torch_kernel_check.py tiles).
template <typename T>
long long pass_cost(int cin, int C, int th, int tw, int H, int W) {
  constexpr int WARPS = kThreads / 32, UM = 16 * Cfg<T>::mt, UN = 8 * Cfg<T>::nt;
  const int kp = Cfg<T>::kpad;
  const int n_n = (round16(C) + UN - 1) / UN;
  auto rounds = [&](int P) { return ((P + UM - 1) / UM * n_n + WARPS - 1) / WARPS; };
  const long long cinp = (cin + kp - 1) / kp * kp, Cp = (C + kp - 1) / kp * kp;
  const long long rows = rounds((th + 2) * (tw + 2)) * (9 * cinp + 2 * Cp) +
                         rounds(th * tw) * 9 * Cp;
  const long long tiles = (long long)((H - 4 + th - 1) / th) * ((W - 4 + tw - 1) / tw);
  return tiles * rows;
}

template <typename T>
size_t smem_bytes(int cin, int C, int th, int tw) {
  size_t a_elems, x_elems, w_elems;
  buffer_elems<T>(cin, C, th, tw, &a_elems, &x_elems, &w_elems);
  return (a_elems + x_elems + w_elems) * sizeof(T);
}

template <typename T, int K, int SB>
int launch_stage(const T* x, const T* w, const float* b, T* out, int B, int H, int W, int cin,
                 int C, int th, int tw, cudaStream_t stream) {
  const size_t smem = Cfg<T>::stages * staged_ring_elems<T, K, SB>(th, tw) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(conv_stage_kernel<T, K, SB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((H - K + 1 + th - 1) / th) * ((W - K + 1 + tw - 1) / tw);
  dim3 grid(tiles, (C + staged_nb<T>() - 1) / staged_nb<T>(), B);
  conv_stage_kernel<T, K, SB><<<grid, kThreads, smem, stream>>>(x, w, b, out, H, W, cin, C, th,
                                                                tw);
  return (int)cudaGetLastError();
}

template <typename T>
size_t staged_smem_bytes(int K, int cin, int th, int tw) {
  constexpr int scb = Cfg<T>::scb;
  const size_t elems = K == 3 ? staged_ring_elems<T, 3, scb>(th, tw)
                       : staged_sb<T>(1, cin) == scb ? staged_ring_elems<T, 1, scb>(th, tw)
                                                     : staged_ring_elems<T, 1, 4 * scb>(th, tw);
  return Cfg<T>::stages * elems * sizeof(T);
}

// The staged route: the pass's four stages, one launch each, x -> s0 -> s1
// -> s0 -> out; s0 and s1 hold (B, H-2, W-2, C) in the compute type.
template <typename T>
int launch_staged(const void* x, const void* const* w, const float* const* b, void* out,
                  void* s0, void* s1, int B, int H, int W, int cin, int C, int th, int tw,
                  cudaStream_t stream) {
  constexpr int scb = Cfg<T>::scb;
  T* t0 = (T*)s0;
  T* t1 = (T*)s1;
  int rc = launch_stage<T, 3, scb>((const T*)x, (const T*)w[0], b[0], t0, B, H, W, cin, C, th,
                                   tw, stream);
  const T* src = t0;
  for (int i = 1; i <= 2 && rc == 0; ++i) {
    T* dst = i == 1 ? t1 : t0;
    rc = staged_sb<T>(1, C) == scb
             ? launch_stage<T, 1, scb>(src, (const T*)w[i], b[i], dst, B, H - 2, W - 2, C, C, th,
                                       tw, stream)
             : launch_stage<T, 1, 4 * scb>(src, (const T*)w[i], b[i], dst, B, H - 2, W - 2, C, C,
                                           th, tw, stream);
    src = dst;
  }
  if (rc == 0)
    rc = launch_stage<T, 3, scb>(src, (const T*)w[3], b[3], (T*)out, B, H - 2, W - 2, C, C, th,
                                 tw, stream);
  return rc;
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

// Relative cost of th x tw tiles for an H x W input (lower is faster); the
// wrapper takes the cheapest tile that fits.
long long conv_pass_2d_cost(int cin, int C, int th, int tw, int H, int W, int elem_bytes) {
  return elem_bytes == 2 ? pass_cost<__nv_bfloat16>(cin, C, th, tw, H, W)
                         : pass_cost<float>(cin, C, th, tw, H, W);
}

// Bytes of dynamic shared memory one block of the staged route needs for a
// K x K stage (K = 1 or 3) with cin input channels and a th x tw output tile.
long long conv_pass_2d_staged_smem_bytes(int K, int cin, int th, int tw, int elem_bytes) {
  return (long long)(elem_bytes == 2 ? staged_smem_bytes<__nv_bfloat16>(K, cin, th, tw)
                                     : staged_smem_bytes<float>(K, cin, th, tw));
}

// The staged route (one launch per stage); s0, s1: scratch of B x (H-2) x
// (W-2) x C elements each. cin and C must be multiples of 16 (bf16) or 8
// (f32). Returns the first CUDA error code (0 = ok).
int conv_pass_2d_staged_launch(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* w3, const void* b3, const void* w4,
                               const void* b4, void* out, void* s0, void* s1, int B, int H,
                               int W, int cin, int C, int th, int tw, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* w[4] = {w1, w2, w3, w4};
  const float* b[4] = {(const float*)b1, (const float*)b2, (const float*)b3, (const float*)b4};
  if (dtype == 0) return launch_staged<float>(x, w, b, out, s0, s1, B, H, W, cin, C, th, tw, s);
  if (dtype == 1)
    return launch_staged<__nv_bfloat16>(x, w, b, out, s0, s1, B, H, W, cin, C, th, tw, s);
  return (int)cudaErrorInvalidValue;
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
