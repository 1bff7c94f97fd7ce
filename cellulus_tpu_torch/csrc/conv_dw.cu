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
// What bounds it on the H100: operations at the train step's widths. The
// function is one GEMM per tap, dw[tap] (Ci x Co) = X_tap^T (Ci x P) .
// G (P x Co), with a very tall K = P = B*Ho*Wo (pixels); at Ci = Co = 64 in
// bf16 it does about 290 FLOP per byte of x and g, at the card's ridge
// point, and more at wider channels, so the least time is the FLOPs over
// the tensor-core peak of the input type (bf16 989 TFLOP/s; float32 as
// 3xTF32, 495 / 3 = 165 TFLOP/s). At Ci < 8 (the first conv) it is bound by
// reading g.
//
// The design: M = input channels, N = output channels, K = pixels, on
// wgmma.mma_async with A from registers and B from shared memory by
// descriptor. A block walks a contiguous range of pixel chunks (TY x TX
// output pixels of one image) of its split; each chunk's g tile and x tile
// (with its 2-pixel halo) arrive in a ring of stages on full and empty
// mbarriers, by TMA boxes (zeros where a box leaves the image or the
// channels) that one thread issues, or, where TMA cannot stride the tensor
// (C * elem not a multiple of 16 bytes), by element copies. No
// __syncthreads per chunk. Two routes, chosen by Ci before launch
// (conv3x3_dw_plan):
//
// 1. Taps (Ci >= 8): a block owns 64 input channels x NB output channels
//    (bf16 64, f32 32) for all nine taps: three consumer warpgroups, one per
//    tap column kx, each holding the taps (0..2, kx) (bf16 3 x m64n64, 96
//    accumulator registers; f32 3 x m64n32 and the chunk's partial sums).
//    A k step is KS pixels of one output row s of the chunk (bf16 16, f32
//    8); the tap (ky, kx) reads x row s + ky shifted by kx, so x row r
//    serves the taps (0, kx), (1, kx), (2, kx) of output rows r, r - 1,
//    r - 2: a warpgroup loads each x row of the chunk once per column into
//    registers (a window of three rows) and issues three wgmmas on one B
//    descriptor of g row s. A tile's pixel is one 128-byte row of channels
//    (64 bf16, or 32 f32: two x boxes), its 16-byte units XORed with the
//    pixel's index mod 8, as TMA's 128-byte swizzle writes a box: one box
//    brings a whole tile, and the 8 pixels an ldmatrix or a 32-bit load
//    reads fall in distinct banks. So the tap-shifted A rows cost only an
//    address: bf16 by ldmatrix.x4.trans, f32 by 32-bit loads split into
//    tf32 hi and lo in registers. TMA then moves whole 128-byte rows; boxes
//    of 16-byte channel groups would move 16 bytes of each pixel row at a
//    time, at about half the rate the bf16 route needs. g in bf16 is read
//    MN-major through a 128-byte swizzle descriptor (imm-trans-b = 1;
//    8-pixel groups 1024 bytes apart). f32 cannot be read MN-major (.tf32 takes B K-major
//    only), and g is an activation the wrapper cannot pre-pack: the
//    consumers split each chunk's landed g tile [pixel][co] once into
//    K-major tf32 hi and lo slabs [pixel / 4][co][4] (LBO 16 NB bytes,
//    SBO 128; two buffers, chunk parity), then fence the async proxy and
//    meet at a named barrier before the wgmmas read them. No producer
//    warp: thread 0 issues the first chunks' boxes, then, at chunk i, those
//    of chunk i - 1 + stages into the slot chunk i - 1 leaves (its empty
//    barrier: every consumer warp has left it); element copies, where TMA
//    cannot stride, are made by all consumers at the chunk, behind a
//    named barrier.
// 2. Folded (Ci < 8, 9 Ci <= 64): (tap, ci) is wgmma's M, 9 Ci rows of one
//    m64 tile, each A row read at its own tap shift (element loads from a
//    dense x tile in registers, rows past 9 Ci zero). One data path with
//    route 1's g ring and B reads; two consumer warpgroups split a chunk's
//    16 k steps, each step's A gathered while the one before multiplies,
//    and their sums are added in a fixed order at the end. A producer
//    warpgroup copies the narrow x tile element by element (TMA cannot
//    stride Ci * elem < 16 bytes) beside the g tile's TMA box. The route is
//    bound by reading g: its stages hold the small x tile, not route 1's
//    64-channel one, so the ring is 6 (bf16) or 7 (f32) stages deep.
//
// f32: the tensor cores truncate an f32 accumulator, so each chunk's
// product starts from zero (scale-d = 0) and is added to the running sum
// in f32 (round to nearest); 3xTF32 is lo*hi + hi*lo + hi*hi, hi rounded
// on the bit pattern, lo = v - hi, as in K1.
//
// Split-K: the grid is (tiles, splits), one wave of blocks (one a SM);
// each block writes its partial tile to a float32 workspace slot and
// conv_dw_reduce_kernel sums the slots in a fixed order. No atomics: the
// result is deterministic, bit for bit.
//
// Registers: both routes launch 384 threads, so ptxas may give each 168.
// A producer warp beside route 1's three warpgroups (416 threads) put four
// warps on one SM sub-partition and held every thread to 128: the bf16
// kernel spilled and ptxas serialised its wgmmas (C7512). No setmaxnreg.
// ptxas (-Xptxas -v, as chip_smoke.py prints it at its build): route 1
// bf16 156 and f32 168 registers, route 2 bf16 127 and f32 103, the
// reduction 32; no spills, no serialised wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

// ---- K2 plan begin: plain C++ (the CPU tests build it with g++) ----------

constexpr int kCi = 64;             // input channels of a route-1 block (wgmma M)
constexpr int kBarBytes = 128;      // the mbarriers, after the ring and the slabs
constexpr int kAlign = 1024;        // the ring's alignment (128-byte swizzle)
constexpr int kMaxStages = 8;      // 8 full and 8 empty barriers fill kBarBytes
constexpr long long kMaxSmem = 232448;

// Per element size (2: bfloat16, 4: float32): pixels per k step, output
// channels of a block (128 bytes of a pixel: one swizzled row), the chunk
// (TY rows x TX pixels), and route 1's buffers of A rows.
template <int E>
struct Dw;
template <>
struct Dw<2> {
  static constexpr int KS = 16, NB = 64, TY = 16, TX = 16, NBUF = 4;
};
template <>
struct Dw<4> {
  static constexpr int KS = 8, NB = 32, TY = 8, TX = 16, NBUF = 3;
};

__host__ __device__ inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
__host__ __device__ inline int r1024(int n) { return (n + 1023) / 1024 * 1024; }

// Byte b (0..127) of row p of a tile of 128-byte rows, as TMA's SWIZZLE_128B
// lays it out from a 1024-byte aligned base: the row's 16-byte units XORed
// with p mod 8.
__host__ __device__ inline int sw128(int p, int b) {
  return p * 128 + ((((b >> 4) ^ p) & 7) << 4) + (b & 15);
}

// route 2 when (tap, ci) fits one m64 tile
__host__ __device__ inline int dw_fold(int Ci) { return 9 * Ci <= 64 ? 1 : 0; }
// TMA boxes need 16-byte strides
__host__ __device__ inline int dw_tma_ok(int C, int esz) { return C * esz % 16 == 0 ? 1 : 0; }
// bit 0 route 2, bit 1 x by TMA, bit 2 g by TMA (for 16-byte aligned tensors)
__host__ __device__ inline int dw_plan_bits(int Ci, int Co, int esz) {
  const int fold = dw_fold(Ci);
  return fold | (!fold && dw_tma_ok(Ci, esz)) << 1 | dw_tma_ok(Co, esz) << 2;
}

// Shared memory, from a 1024-byte aligned base: the ring of stages, each
// the x area (route 1: 128-byte swizzled rows of 64 bf16 or 32 f32
// channels a pixel, one box of (TY + 2) x (TX + 2) pixels per 128 bytes of
// channels; route 2: the dense x tile of at most 7 channels, so that its
// stages are small and many) and the g tile (TY x TX pixels of NB
// channels: bf16 swizzled, f32 plain); (f32) two buffers of the hi and lo
// slabs; the barriers. The total adds the base's alignment.
struct DwLayout {
  int xbox;    // bytes of one x box (128-byte rows), 1024-aligned
  int xbytes;  // x area of a stage
  int gbytes;  // g tile of a stage
  int stage;   // bytes of a stage
  int slab;    // f32: bytes of one tf32 slab (hi or lo) of a chunk; 0 in bf16
  int stages;
  int slabs;   // offset of the slabs
  int bars;    // offset of the barriers
  long long total;
};

template <int E>
__host__ __device__ inline DwLayout dw_layout(int fold) {
  typedef Dw<E> C;
  DwLayout L;
  L.xbox = r1024(128 * (C::TY + 2) * (C::TX + 2));
  L.xbytes = fold ? r1024((C::TY + 2) * (C::TX + 2) * 7 * E) : kCi * E / 128 * L.xbox;
  L.gbytes = C::TY * C::TX * C::NB * E;
  L.stage = L.xbytes + L.gbytes;
  L.slab = E == 4 ? C::TY * C::TX * C::NB * 4 : 0;
  long long s = (kMaxSmem - kAlign - kBarBytes - 4LL * L.slab) / L.stage;
  L.stages = (int)(s > kMaxStages ? kMaxStages : s);
  L.slabs = L.stages * L.stage;
  L.bars = L.slabs + 4 * L.slab;
  L.total = (long long)L.bars + kBarBytes + kAlign;
  return L;
}

struct DwGrid {
  int fold, n_ci_blocks, n_co_blocks, chunks_y, chunks_x;
  long long n_chunks;
};

template <int E>
__host__ __device__ inline DwGrid dw_grid(int B, int H, int W, int Ci, int Co) {
  DwGrid gr;
  gr.fold = dw_fold(Ci);
  gr.n_ci_blocks = gr.fold ? 1 : cdiv(Ci, kCi);
  gr.n_co_blocks = cdiv(Co, Dw<E>::NB);
  gr.chunks_y = cdiv(H - 2, Dw<E>::TY);
  gr.chunks_x = cdiv(W - 2, Dw<E>::TX);
  gr.n_chunks = (long long)B * gr.chunks_y * gr.chunks_x;
  return gr;
}

// Pixel splits: one wave of blocks over `sms` SMs, at least one chunk
// each, and no split left empty: every split but the last takes
// per_split = ceil(chunks / splits) chunks.
template <int E>
__host__ __device__ inline int dw_splits(int B, int H, int W, int Ci, int Co, int sms) {
  const DwGrid gr = dw_grid<E>(B, H, W, Ci, Co);
  const long long tiles = (long long)gr.n_ci_blocks * gr.n_co_blocks;
  long long s = sms / tiles;
  if (s > gr.n_chunks) s = gr.n_chunks;
  if (s < 1) s = 1;
  const long long per = (gr.n_chunks + s - 1) / s;
  return cdiv(gr.n_chunks, per);
}

// chunk c: image b, output origin (y0, x0)
template <int E>
__host__ __device__ inline void dw_chunk(long long c, int chunks_y, int chunks_x, int& b, int& y0,
                                         int& x0) {
  const long long per_image = (long long)chunks_y * chunks_x;
  b = (int)(c / per_image);
  const int rem = (int)(c - b * per_image);
  y0 = rem / chunks_x * Dw<E>::TY;
  x0 = rem % chunks_x * Dw<E>::TX;
}

// ---- K2 plan end ---------------------------------------------------------

// Threads: route 1 three consumer warpgroups (thread 0 also feeds the
// ring); route 2 two consumer warpgroups and a producer warpgroup, whose
// threads copy the narrow x tile.
template <bool FOLD>
struct Roles {
  static constexpr int consumers = FOLD ? 256 : 384;
  static constexpr int producers = FOLD ? 128 : 0;
  static constexpr int threads = consumers + producers;
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

struct Args {
  int B, H, W, Ci, Co, n_ci_blocks, chunks_y, chunks_x, per_split, tma_x, tma_g;
};

// Thread pt of NP's element copies of chunk (b, y0, x0) into stage st, in
// the layout the TMA boxes give, zeros outside the image and past the
// channels: the x tile (route 1 swizzled rows, route 2 dense [pixel][Ci])
// and the g tile (bf16 swizzled rows, f32 [pixel][NB]).
template <typename T, bool FOLD>
__device__ __forceinline__ void copy_x(unsigned char* st, const T* __restrict__ x, const Args& a,
                                       const DwLayout& L, int b, int y0, int x0, int ci0, int pt,
                                       int NP) {
  typedef Dw<sizeof(T)> C;
  constexpr int XW = C::TX + 2, XP = (C::TY + 2) * XW;
  T* xs = reinterpret_cast<T*>(st);
  if (FOLD) {
    const int n = XP * a.Ci;
#pragma unroll 4
    for (int i = pt; i < n; i += NP) {
      const int p = i / a.Ci, ci = i - p * a.Ci;
      const int iy = y0 + p / XW, ix = x0 + p % XW;
      xs[i] = iy < a.H && ix < a.W ? x[(((long long)b * a.H + iy) * a.W + ix) * a.Ci + ci]
                                   : from_f<T>(0.f);
    }
  } else {
    constexpr int E = sizeof(T);
    for (int i = pt; i < kCi * XP; i += NP) {
      const int c = i % kCi, p = i / kCi;  // channel of the block, pixel of the tile
      const int ci = ci0 + c, iy = y0 + p / XW, ix = x0 + p % XW;
      T* dst = reinterpret_cast<T*>(st + c * E / 128 * L.xbox + sw128(p, c * E % 128));
      *dst = ci < a.Ci && iy < a.H && ix < a.W
                 ? x[(((long long)b * a.H + iy) * a.W + ix) * a.Ci + ci]
                 : from_f<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_g(unsigned char* gs_raw, const T* __restrict__ g,
                                       const Args& a, int b, int y0, int x0, int co0, int pt,
                                       int NP) {
  typedef Dw<sizeof(T)> C;
  constexpr int P = C::TY * C::TX, E = sizeof(T);
  const int Ho = a.H - 2, Wo = a.W - 2;
  for (int i = pt; i < P * C::NB; i += NP) {
    const int n = i % C::NB, p = i / C::NB;
    const int gy = y0 + p / C::TX, gx = x0 + p % C::TX, co = co0 + n;
    T* dst = reinterpret_cast<T*>(gs_raw + (E == 2 ? sw128(p, n * E) : p * 128 + n * E));
    *dst = gy < Ho && gx < Wo && co < a.Co ? g[(((long long)b * Ho + gy) * Wo + gx) * a.Co + co]
                                           : from_f<T>(0.f);
  }
}

// f32: the chunk's g tile [pixel][NB] into K-major tf32 slabs hi and lo,
// [pixel / 4][NB][4] each, by the consumer threads (ct of n_ct).
__device__ __forceinline__ void split_g(const float* raw, float* hi, float* lo, int ct, int n_ct) {
  typedef Dw<4> C;
  constexpr int P = C::TY * C::TX, NB = C::NB;
  for (int i = ct; i < P / 4 * NB; i += n_ct) {
    const int n = i % NB, p4 = i / NB;
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(raw[(4 * p4 + j) * NB + n], h[j], l[j]);
    *reinterpret_cast<uint4*>(hi + (size_t)i * 4) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + (size_t)i * 4) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Route 1, bf16, one chunk of warpgroup kx: for each column of KS pixels,
// the x rows 0 .. TY+1 by ldmatrix.trans into a window of NBUF buffers and,
// per output row s, the taps (0..2, kx) on one MN-major descriptor of g.
__device__ __forceinline__ void taps_bf16(const unsigned char* st, const DwLayout& L, int kx,
                                          int warp, int lane, float (&acc)[3][32]) {
  typedef Dw<2> C;
  constexpr int XW = C::TX + 2;
  // this lane's ldmatrix row: pixel (lane & 7) + 8 (lane >> 4) of the step,
  // shifted by kx, and the 16 bytes of channels 16 warp + 8 ((lane >> 3) & 1)
  const int a_p = (lane & 7) + ((lane >> 4) << 3) + kx;
  const int a_b = (2 * warp + ((lane >> 3) & 1)) * 16;
  const unsigned char* gs = st + L.xbytes;
#pragma unroll 1
  for (int c = 0; c < C::TX / C::KS; ++c) {
    const int p0 = c * C::KS + a_p;
    uint32_t a[C::NBUF][4];
    ldmatrix_x4_trans(a[0], st + sw128(p0, a_b));
    ldmatrix_x4_trans(a[1], st + sw128(p0 + XW, a_b));
#pragma unroll
    for (int s = 0; s < C::TY; ++s) {
      ldmatrix_x4_trans(a[(s + 2) % C::NBUF], st + sw128(p0 + (s + 2) * XW, a_b));
      const uint64_t d = desc_mn_sw128(gs + (s * C::TX + c * C::KS) * 128, 1024);
      wgmma_fence();
      wgmma_bf16<1>(acc[0], a[s % C::NBUF], d, 1);
      wgmma_bf16<1>(acc[1], a[(s + 1) % C::NBUF], d, 1);
      wgmma_bf16<1>(acc[2], a[(s + 2) % C::NBUF], d, 1);
      wgmma_commit();
      wgmma_wait<C::NBUF - 3>();
    }
    wgmma_wait<0>();
  }
}

// Route 1, f32, one chunk of warpgroup kx: the same walk with 32-bit A
// loads split into hi and lo, three products a tap (lo*hi, hi*lo, hi*hi)
// into the chunk's partial sums, which start from zero.
__device__ __forceinline__ void taps_f32(const unsigned char* st, const float* hi, const float* lo,
                                         const DwLayout& L, int kx, int warp, int lane,
                                         float (&part)[3][16]) {
  typedef Dw<4> C;
  constexpr int XW = C::TX + 2;
  const int gq = lane >> 2, t = lane & 3;
  // this lane's A rows, input channels 16 warp + gq and + 8: in box warp / 2,
  // at bytes ba and bb of the pixel's 128-byte row
  const unsigned char* xh = st + (warp >> 1) * L.xbox;
  const int ba = ((16 * warp + gq) & 31) * 4, bb = ba + 32;
#pragma unroll 1
  for (int c = 0; c < C::TX / C::KS; ++c) {
    uint32_t ah[C::NBUF][4], al[C::NBUF][4];
    const int p0 = c * C::KS + t + kx;
#define K2_LOAD_ROW(buf, r)                                                                    \
  split_tf32(*reinterpret_cast<const float*>(xh + sw128(p0 + (r) * XW, ba)), ah[buf][0],       \
             al[buf][0]);                                                                      \
  split_tf32(*reinterpret_cast<const float*>(xh + sw128(p0 + (r) * XW, bb)), ah[buf][1],       \
             al[buf][1]);                                                                      \
  split_tf32(*reinterpret_cast<const float*>(xh + sw128(p0 + (r) * XW + 4, ba)), ah[buf][2],   \
             al[buf][2]);                                                                      \
  split_tf32(*reinterpret_cast<const float*>(xh + sw128(p0 + (r) * XW + 4, bb)), ah[buf][3],   \
             al[buf][3]);
    K2_LOAD_ROW(0, 0)
    K2_LOAD_ROW(1, 1)
#pragma unroll
    for (int s = 0; s < C::TY; ++s) {
      K2_LOAD_ROW((s + 2) % C::NBUF, s + 2)
      const int kb = (s * C::TX + c * C::KS) / 4;  // 4-pixel group of the step
      const uint64_t dh = desc_kmajor(hi + kb * C::NB * 4, C::NB * 16, 128);
      const uint64_t dl = desc_kmajor(lo + kb * C::NB * 4, C::NB * 16, 128);
      const int sd = c > 0 || s > 0;
      wgmma_fence();
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) wgmma_tf32_n32(part[ky], al[(s + ky) % C::NBUF], dh, sd);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) wgmma_tf32_n32(part[ky], ah[(s + ky) % C::NBUF], dl, 1);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) wgmma_tf32_n32(part[ky], ah[(s + ky) % C::NBUF], dh, 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
#undef K2_LOAD_ROW
  }
}

// Route 2: this lane's two A rows m = 16 warp + lane / 4 (+ 8) as (tap, ci),
// their offsets in the dense x tile and whether they exist (m < 9 Ci).
struct FoldRows {
  int off[2];
  bool ok[2];
};
template <int E>
__device__ __forceinline__ FoldRows fold_rows(int Ci, int warp, int lane) {
  constexpr int XW = Dw<E>::TX + 2;
  FoldRows f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + (lane >> 2) + 8 * h;
    f.ok[h] = m < 9 * Ci;
    const int tap = f.ok[h] ? m / Ci : 0, ci = f.ok[h] ? m - tap * Ci : 0;
    f.off[h] = ((tap / 3) * XW + tap % 3) * Ci + ci;
  }
  return f;
}

// Route 2: a chunk is 16 k steps (TY * TX / KS in both types); warpgroup
// wgi takes q = wgi, wgi + 2, ..., unrolled, each step's A gathered into one
// of two buffers while the step before it multiplies (one wgmma group in
// flight behind the one being issued).
constexpr int kFoldSteps = 16;
static_assert(Dw<2>::TY * Dw<2>::TX / Dw<2>::KS == kFoldSteps, "bf16 chunk");
static_assert(Dw<4>::TY * Dw<4>::TX / Dw<4>::KS == kFoldSteps, "f32 chunk");

// Route 2, bf16.
__device__ __forceinline__ void fold_bf16(const unsigned char* st, const DwLayout& L, int Ci,
                                          const FoldRows& f, int wgi, int lane, float (&acc)[32]) {
  typedef Dw<2> C;
  constexpr int XW = C::TX + 2, CPR = C::TX / C::KS;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
  const unsigned char* gs = st + L.xbytes;
  const int t = lane & 3;
  const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
  uint32_t a[2][4];
#pragma unroll
  for (int i = 0; i < kFoldSteps / 2; ++i) {
    const int q = wgi + 2 * i, s = q / CPR, c = q % CPR;
    const __nv_bfloat16* base = xs + (s * XW + c * C::KS) * Ci;
    __nv_bfloat16 v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 2 * t + (j & 1) + 8 * (j >> 1);
        v[h][j] = f.ok[h] ? base[k * Ci + f.off[h]] : z;
      }
    uint32_t(&ai)[4] = a[i & 1];
    ai[0] = pack_bf16(v[0][0], v[0][1]);
    ai[1] = pack_bf16(v[1][0], v[1][1]);
    ai[2] = pack_bf16(v[0][2], v[0][3]);
    ai[3] = pack_bf16(v[1][2], v[1][3]);
    const uint64_t d = desc_mn_sw128(gs + (s * C::TX + c * C::KS) * 128, 1024);
    wgmma_fence();
    wgmma_bf16<1>(acc, ai, d, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// Route 2, f32: the same with 3xTF32 into the chunk's partial sum.
__device__ __forceinline__ void fold_f32(const unsigned char* st, const float* hi, const float* lo,
                                         int Ci, const FoldRows& f, int wgi, int lane,
                                         float (&part)[16]) {
  typedef Dw<4> C;
  constexpr int XW = C::TX + 2, CPR = C::TX / C::KS;
  const float* xs = reinterpret_cast<const float*>(st);
  const int t = lane & 3;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < kFoldSteps / 2; ++i) {
    const int q = wgi + 2 * i, s = q / CPR, c = q % CPR;
    const float* base = xs + (s * XW + c * C::KS) * Ci;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a[j] = (row h = j & 1, pixel t + 4 (j >> 1))
      const int h = j & 1, k = t + 4 * (j >> 1);
      split_tf32(f.ok[h] ? base[k * Ci + f.off[h]] : 0.f, ah[i & 1][j], al[i & 1][j]);
    }
    const int kb = (s * C::TX + c * C::KS) / 4;
    const uint64_t dh = desc_kmajor(hi + kb * C::NB * 4, C::NB * 16, 128);
    const uint64_t dl = desc_kmajor(lo + kb * C::NB * 4, C::NB * 16, 128);
    wgmma_fence();
    wgmma_tf32_n32(part, al[i & 1], dh, i > 0);
    wgmma_tf32_n32(part, ah[i & 1], dl, 1);
    wgmma_tf32_n32(part, ah[i & 1], dh, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// D fragment rows 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
// of an m64 tile into the workspace slot: rows map to (tap, ci) by row_of.
template <int R, typename RowOf>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float (&d)[R], int Ci,
                                           int Co, int co0, int warp, int lane, RowOf row_of) {
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int co = co0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tap, ci;
      if (!row_of(16 * warp + gq + 8 * h, tap, ci) || co >= Co) continue;
      float* p = out + ((size_t)tap * Ci + ci) * Co + co;
      if (co + 1 < Co && Co % 2 == 0)
        *reinterpret_cast<float2*>(p) = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      else {
        p[0] = d[4 * j + 2 * h];
        if (co + 1 < Co) p[1] = d[4 * j + 2 * h + 1];
      }
    }
  }
}

// Route 1: the TMA boxes of chunk (b, y0, x0) into stage st, completing on
// bar with the bytes they bring (none: a plain arrival).
template <int E>
__device__ __forceinline__ void issue_tma(unsigned char* st, const CUtensorMap* xmap,
                                          const CUtensorMap* gmap, const Args& a,
                                          const DwLayout& L, int ci0, int co0, int b, int y0,
                                          int x0, uint64_t* bar) {
  typedef Dw<E> C;
  const uint32_t tx = (a.tma_x ? kCi * E * (C::TY + 2) * (C::TX + 2) : 0) +
                      (a.tma_g ? L.gbytes : 0);
  if (tx == 0) {
    mbar_arrive(bar);
    return;
  }
  mbar_arrive_tx(bar, tx);
  if (a.tma_x)  // a box per 128 bytes of channels
    for (int h = 0; h < kCi * E / 128; ++h)
      tma_load_4d(st + h * L.xbox, xmap, ci0 + h * 128 / E, x0, y0, b, bar);
  if (a.tma_g) tma_load_4d(st + L.xbytes, gmap, co0, x0, y0, b, bar);
}

template <typename T, bool FOLD>
__global__ void __launch_bounds__(Roles<FOLD>::threads, 1)
conv_dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
               const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws, Args a) {
  constexpr int E = sizeof(T);
  typedef Dw<E> C;
  constexpr int NC = Roles<FOLD>::consumers, NP = Roles<FOLD>::producers;
  extern __shared__ __align__(1024) unsigned char smem[];
  const DwLayout L = dw_layout<E>(FOLD);
  unsigned char* ring = smem + ((kAlign - (smem_u32(smem) & (kAlign - 1))) & (kAlign - 1));
  float* slabs = reinterpret_cast<float*>(ring + L.slabs);  // f32: [2][hi, lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L.bars);
  uint64_t* empty = full + kMaxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L.stages; ++i) {
      mbar_init(&full[i], FOLD ? NP : 1);
      mbar_init(&empty[i], NC / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int ci0 = (blockIdx.x % a.n_ci_blocks) * kCi;
  const int co0 = (blockIdx.x / a.n_ci_blocks) * C::NB;
  const long long n_chunks = (long long)a.B * a.chunks_y * a.chunks_x;
  const long long c_begin = (long long)blockIdx.y * a.per_split;
  const int n = (int)((n_chunks < c_begin + a.per_split ? n_chunks : c_begin + a.per_split) -
                      c_begin);
  float* out = ws + (size_t)blockIdx.y * 9 * a.Ci * a.Co;

  // the role split on a warp-uniform index: consumers first, then (route 2)
  // the producer warpgroup
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (FOLD && (int)threadIdx.x >= NC) {
    const int pt = threadIdx.x - NC;
    for (int i = 0; i < n; ++i) {
      const int slot = i % L.stages;
      int b, y0, x0;
      dw_chunk<E>(c_begin + i, a.chunks_y, a.chunks_x, b, y0, x0);
      mbar_wait(&empty[slot], ((i / L.stages) & 1) ^ 1);
      unsigned char* st = ring + (size_t)slot * L.stage;
      if (pt == 0 && a.tma_g) {
        mbar_expect_tx(&full[slot], L.gbytes);
        tma_load_4d(st + L.xbytes, &gmap, co0, x0, y0, b, &full[slot]);
      }
      copy_x<T, FOLD>(st, x, a, L, b, y0, x0, ci0, pt, NP);
      if (!a.tma_g) copy_g<T>(st + L.xbytes, g, a, b, y0, x0, co0, pt, NP);
      fence_proxy_async();
      mbar_arrive(&full[slot]);
    }
    return;
  }

  const int warp = __shfl_sync(0xffffffffu, ((int)threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  constexpr int R = C::NB / 2;  // accumulator registers of an m64 x NB tile
  if constexpr (!FOLD) {
    const int kx = wgi;
    float acc[3][R];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[k][j] = 0.f;
    // thread 0 feeds the ring: the first chunks now, then, at chunk i, chunk
    // i - 1 + stages into the slot chunk i - 1 leaves once every warp has
    // left it
    const bool manual = !a.tma_x || !a.tma_g;
    auto issue = [&](int i) {
      int b, y0, x0;
      dw_chunk<E>(c_begin + i, a.chunks_y, a.chunks_x, b, y0, x0);
      const int slot = i % L.stages;
      issue_tma<E>(ring + (size_t)slot * L.stage, &xmap, &gmap, a, L, ci0, co0, b, y0, x0,
                   &full[slot]);
    };
    if (threadIdx.x == 0)
      for (int i = 0; i < n && i < L.stages; ++i) issue(i);
    for (int i = 0; i < n; ++i) {
      const int slot = i % L.stages;
      mbar_wait(&full[slot], (i / L.stages) & 1);
      unsigned char* st = ring + (size_t)slot * L.stage;
      if (manual) {
        // what TMA cannot stride, copied by every consumer thread; a barrier
        // a chunk keeps the warpgroups within a chunk of each other, so that
        // no one still reads this slot's previous chunk
        int b, y0, x0;
        dw_chunk<E>(c_begin + i, a.chunks_y, a.chunks_x, b, y0, x0);
        if (!a.tma_x) copy_x<T, FOLD>(st, x, a, L, b, y0, x0, ci0, threadIdx.x, NC);
        if (!a.tma_g) copy_g<T>(st + L.xbytes, g, a, b, y0, x0, co0, threadIdx.x, NC);
        fence_proxy_async();
        named_sync(1, NC);
      }
      float* hi = slabs + (i & 1) * 2 * (L.slab / 4);
      float* lo = hi + L.slab / 4;
      if constexpr (E == 4) {
        split_g(reinterpret_cast<const float*>(st + L.xbytes), hi, lo, threadIdx.x, NC);
        fence_proxy_async();
        named_sync(1, NC);
      }
      // the refill, after this chunk's barriers, so that no other thread
      // waits on its copies being issued
      if (threadIdx.x == 0 && i > 0 && i - 1 + L.stages < n) {
        mbar_wait(&empty[(i - 1) % L.stages], ((i - 1) / L.stages) & 1);
        issue(i - 1 + L.stages);
      }
      if constexpr (E == 2) {
        taps_bf16(st, L, kx, warp, lane, acc);
      } else {
        float part[3][R];
        taps_f32(st, hi, lo, L, kx, warp, lane, part);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pin(part[k]);
#pragma unroll
          for (int j = 0; j < R; ++j) acc[k][j] += part[k][j];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      pin(acc[ky]);
      const int tap = ky * 3 + kx, Ci = a.Ci;
      store_tile<R>(out, acc[ky], a.Ci, a.Co, co0, warp, lane, [&](int m, int& tp, int& ci) {
        tp = tap;
        ci = ci0 + m;
        return ci < Ci;
      });
    }
  } else {
    const FoldRows f = fold_rows<E>(a.Ci, warp, lane);
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int slot = i % L.stages;
      mbar_wait(&full[slot], (i / L.stages) & 1);
      const unsigned char* st = ring + (size_t)slot * L.stage;
      if constexpr (E == 2) {
        fold_bf16(st, L, a.Ci, f, wgi, lane, acc);
      } else {
        float* hi = slabs + (i & 1) * 2 * (L.slab / 4);
        float* lo = hi + L.slab / 4;
        split_g(reinterpret_cast<const float*>(st + L.xbytes), hi, lo, threadIdx.x, NC);
        fence_proxy_async();
        named_sync(1, NC);
        float part[R];
        fold_f32(st, hi, lo, a.Ci, f, wgi, lane, part);
        pin(part);
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] += part[j];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    pin(acc);
    // warpgroup 1's sums to shared memory (the ring, no longer read), then
    // warpgroup 0 adds them to its own in that order and stores the tile
    float* red = reinterpret_cast<float*>(ring);
    const int ct = threadIdx.x & 127;
    named_sync(1, NC);
    if (wgi == 1)
#pragma unroll
      for (int j = 0; j < R; ++j) red[j * 128 + ct] = acc[j];
    named_sync(1, NC);
    if (wgi == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] += red[j * 128 + ct];
      const int Ci = a.Ci;
      store_tile<R>(out, acc, a.Ci, a.Co, co0, warp, lane, [&](int m, int& tp, int& ci) {
        tp = m / Ci;
        ci = m - tp * Ci;
        return m < 9 * Ci;
      });
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

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, bool FOLD>
int launch_partial(const CUtensorMap& xm, const CUtensorMap& gm, const T* x, const T* g, float* ws,
                   const Args& a, dim3 grid, long long smem, cudaStream_t stream) {
  // the shared-memory attribute once per device (the size never changes)
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !set[dev]) {
    err = cudaFuncSetAttribute(conv_dw_kernel<T, FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) set[dev] = true;
  }
  conv_dw_kernel<T, FOLD><<<grid, Roles<FOLD>::threads, smem, stream>>>(xm, gm, x, g, ws, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* gv, float* ws, float* dw, int B, int H, int W, int Ci,
           int Co, int splits, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  typedef Dw<E> C;
  const T* x = (const T*)xv;
  const T* g = (const T*)gv;
  const DwGrid gr = dw_grid<E>(B, H, W, Ci, Co);
  const DwLayout L = dw_layout<E>(gr.fold);
  Args a;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Ci = Ci;
  a.Co = Co;
  a.n_ci_blocks = gr.n_ci_blocks;
  a.chunks_y = gr.chunks_y;
  a.chunks_x = gr.chunks_x;
  a.per_split = cdiv(gr.n_chunks, splits);
  a.tma_x = !gr.fold && dw_tma_ok(Ci, E) && (uintptr_t)x % 16 == 0;
  a.tma_g = dw_tma_ok(Co, E) && (uintptr_t)g % 16 == 0;
  CUtensorMap xm, gm;
  memset(&xm, 0, sizeof xm);
  memset(&gm, 0, sizeof gm);
  int rc = 0;
  if (a.tma_x)
    rc = tmap::encode_nhwc(&xm, x, B, H, W, Ci, 128 / E, C::TX + 2, C::TY + 2, E, true);
  if (rc == 0 && a.tma_g)
    rc = tmap::encode_nhwc(&gm, g, B, H - 2, W - 2, Co, C::NB, C::TX, C::TY, E, E == 2);
  if (rc) return rc;
  const dim3 grid(gr.n_ci_blocks * gr.n_co_blocks, splits);
  rc = gr.fold ? launch_partial<T, true>(xm, gm, x, g, ws, a, grid, L.total, stream)
               : launch_partial<T, false>(xm, gm, x, g, ws, a, grid, L.total, stream);
  if (rc) return rc;
  const size_t n = (size_t)9 * Ci * Co;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  conv_dw_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The route for these shapes: bit 0 set when (tap, ci) is folded into M
// (route 2), bit 1 when x comes by TMA boxes, bit 2 when g does (given
// 16-byte aligned tensors); elem_bytes is 4 (float32) or 2 (bfloat16).
int conv3x3_dw_plan(int Ci, int Co, int elem_bytes) { return dw_plan_bits(Ci, Co, elem_bytes); }

// Bytes of dynamic shared memory a block of the route takes (fold: 1 for
// route 2).
long long conv3x3_dw_smem_bytes(int elem_bytes, int fold) {
  return elem_bytes == 2 ? dw_layout<2>(fold).total : dw_layout<4>(fold).total;
}

// Workspace slots (pixel splits) for these shapes on this card.
int conv3x3_dw_splits(int B, int H, int W, int Ci, int Co, int elem_bytes) {
  return elem_bytes == 2 ? dw_splits<2>(B, H, W, Ci, Co, sm_count())
                         : dw_splits<4>(B, H, W, Ci, Co, sm_count());
}

// x (B, H, W, Ci), g (B, H-2, W-2, Co) contiguous; ws holds splits * 9*Ci*Co
// floats; dw (3, 3, Ci, Co) float32. dtype: 0 = float32, 1 = bfloat16.
// Returns the error code (0 = ok; CUDA's, or 9001/9002 when a TMA map
// cannot be encoded).
int conv3x3_dw_launch(const void* x, const void* g, void* ws, void* dw, int B, int H, int W,
                      int Ci, int Co, int splits, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, g, (float*)ws, (float*)dw, B, H, W, Ci, Co, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, (float*)ws, (float*)dw, B, H, W, Ci, Co, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
