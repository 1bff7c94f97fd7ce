// Fused U-Net conv pass for Hopper (sm_90a): one launch computes
//
//   conv3x3+b -> ReLU -> conv1x1+b -> ReLU -> conv1x1+b -> ReLU -> conv3x3+b -> ReLU
//
// all VALID, NHWC, (B, H, W, Cin) -> (B, H-4, W-4, C); biases f32; f32
// accumulation, bias and ReLU in the epilogue, every intermediate stored in
// the compute type (f32 or bf16), so the rounding points are those of
// conv_pass_2d_plain.
//
// Replaces: cellulus_tpu/ops/pallas_conv.py `_pass_call` / `conv_pass_2d`
// (one Pallas program per row strip, the four stages in VMEM).
//
// What bounds it on the H100: operations. At the main path's widths a pass
// does 30-150 FLOP per byte it must move (input once, output once), far
// above the card's ridge point, so the least time is the FLOPs over the
// tensor-core peak of the compute type (bf16 989 TFLOP/s; float32 as
// 3xTF32, 495 / 3 = 165 TFLOP/s). wgmma is the only way to that peak.
//
// Each stage is an implicit GEMM: M = pixels of the stage's output grid,
// N = C in n-blocks of 64 columns, K = kh * kw * cin in the order (tap,
// channel). What held the earlier mma.sync design back, and what this one
// does about it:
// (1) The weights streamed through the ring once per round of 8 warp units
//     of 32 pixels x 64 (bf16) or 32 (f32) channels. Here both consumer
//     warpgroups take the same n-block and split the stage's m64 tiles, up
//     to MT = 4 (bf16) or 1 (f32) each, so one pass of an n-block's weights
//     feeds up to 512 (bf16) or 128 (f32) pixels; a stage takes n_nb x R
//     rounds, R = ceil(m64 tiles / 2 MT). A stage of at most MT tiles and
//     two n-blocks or more runs in pair mode where that is cheaper: the
//     warpgroups take the same tiles and an n-block each, a slot holding a
//     chunk of both, so that neither idles (the 256-fmap first pass: one
//     tile in f32 at 6 x 6, three in bf16 at 10 x 10).
// (2) A __syncthreads for every 32 rows of K. Here a ring of S slots (2..4,
//     as many as shared memory leaves; 128 K rows of one n-block in bf16, 32
//     in f32, 16 KB) runs on full and empty mbarriers: a chunk arrives by
//     cp.async.bulk (one per weight array) completing on its slot's full
//     barrier, and each consumer warp arrives on the empty barrier once its
//     warpgroup's wgmmas on the slot have completed. The producer walks
//     the chunks of every round of every stage in the consumers' order, so
//     the next stage's weights load while this one finishes.
// (3) mma.sync from 8 warps, B re-read by every warp on every k step. Here
//     two warpgroups issue wgmma.mma_async, m64n64k16 bf16 and m64n64k8
//     .tf32 three times a k step for 3xTF32 (lo*hi, hi*lo, hi*hi), B read
//     from the slot by descriptor. A comes from registers: each warp loads
//     its 16 rows at the tap-shifted pixel, ldmatrix.x4 in bf16 and 32-bit
//     loads in f32 (split into hi and lo in registers), each lane decoding
//     its own k to (tap, channel), so a k step may cross taps and channels
//     pad only to 16 bytes (cin = 1 costs 8 in bf16, 4 in f32, not 16 and
//     8). A is double buffered and one wgmma group stays in flight behind
//     the one being issued; every tile of the round reads a slot before it
//     is released. The warpgroup's tile count is a template argument
//     (consume_round<MTA>) and its index a warp-uniform shuffle, so that no
//     wgmma sits behind a branch the compiler cannot prove uniform (ptxas
//     serialises those).
//     A producer warpgroup (setmaxnreg down to 56 registers; one thread
//     issues every copy) feeds two consumer warpgroups (up to 224).
// (4) Small tiles at wide C. The ring is 64 columns wide whatever C is,
//     which lets the tiles grow (plan in ops/conv_pass.py): 64 -> 192 keeps
//     12 x 12 (bf16) and 8 x 8 (f32), 1 -> 256 in bf16 takes 10 x 10 (was
//     8 x 8), the 64-wide passes up to 20 x 20 (bf16; was 14 x 14). The
//     1x1 stages are not computed in place: an m64 tile's whole K in
//     registers costs 48-96 registers that the MT tiles' accumulators need.
//     Footprint: mid + max(in, mid) + ring; the input buffer takes stage
//     2's output and the output tile.
// (5) The staged route read each input tile once per 64 output channels,
//     16 channels and a barrier at a time. It now runs on the same producer
//     and consumers, one launch per stage: a block takes a 16 x 16 output
//     tile and one n-block, its input streamed by TMA in slices of 32 (bf16)
//     or 16 (f32) channels a 3x3 chunk, 64 or 32 a 1x1 chunk; its output
//     tile is staged in shared memory of its own.
// (6) Scalar 2-byte output stores. The last stage's tile now goes to shared
//     memory (bias, ReLU and rounding in registers), then to the image with
//     16-byte coalesced stores. Intermediates are stored as pairs.
//
// Registers: ptxas compiles the whole kernel within the launch budget of
// 384 threads, 168 registers a thread; it does not raise the consumers'
// budget after setmaxnreg.inc. So the tiles a warpgroup holds are sized to
// it: in bf16 4 m64 tiles (128 accumulator registers); in f32 one, whose
// 32 accumulators and 32 of the chunk's partial sum fit (at 2, the 64 + 64
// spilled and ptxas serialised the wgmmas: 15-30% slower on every f32
// pass). Measured against this design on the H100, one call each
// (PERF.md): a producer warp instead of a warpgroup (288 threads, still
// 168 registers) was 5-30% slower in bf16; two warpgroups alone with
// thread 0 feeding the ring (256 threads, 255 registers) were 1.5-3x
// slower, the feed's state live in every thread; bf16 at 2 tiles a
// warpgroup, which ptxas does not serialise, was within -12% to +6% by pass.
//
// Weights are packed by the wrapper once per call (ops/conv_pass.py
// pack_stage) into the layout the wgmma descriptor names: per n-block, K
// rows in 16-byte slabs, [K/kin][64][kin] (kin = 16 bytes of elements),
// K-major without swizzle (LBO = 1024 bytes between k slabs, SBO = 128
// between 8-column groups). Every core matrix is 128 contiguous bytes, so
// wgmma reads B without bank conflicts and without a swizzle, any chunk is
// one contiguous copy, and no 1024-byte alignment is needed. In f32 the
// wrapper splits w into hi = tf32(w) and lo = w - hi (the rule of to_tf32),
// two arrays of that layout one after the other.
//
// f32: the tensor cores truncate an f32 accumulator, so each chunk is
// summed from zero (scale-d = 0 on its first k step) into a partial and
// added to the running sum with an ordinary f32 add: over K = 9 * 256 the
// drift would otherwise reach 1e-4.
//
// Intermediates never touch device memory: a block owns a TH x TW output
// tile of one image and keeps the (TH+4) x (TW+4) input tile and the
// (TH+2) x (TW+2) intermediates in shared memory, pixel-major, channels
// padded to 16 bytes and the pixel pitch to an odd number of 16-byte units
// (conflict-free ldmatrix rows). A wide input (cin >= 128, the up passes)
// is not held: stage 1 streams it, a chunk being one tap row dy of SB input
// channels, a TMA 4D box (SB, TW+4, TH+2, 1) of the NHWC input at (cb, x0,
// y0 + dy, image) whose zero fill takes the image edge, followed by the
// 3 x SB weight rows of that tap row. Rows past the grid read a clamped
// pixel and are not stored; k rows past the stage's K read pixel 0 against
// zero weight rows.
//
// Registers and spills (nvcc -Xptxas -v, CUDA 12.8, as chip_smoke.py
// prints them at its build): every kernel 168 registers a thread, 2 named
// barriers; spill stores / loads in bytes: conv_pass_kernel<bf16> 176 /
// 256, conv_pass_kernel<float> 1,180 / 2,388, conv_stage_kernel<bf16> 32 /
// 32, conv_stage_kernel<float> none. ptxas reports the wgmmas of the two
// bf16 kernels serialised for register resources (C7512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int NB = 64;  // wgmma N: the columns of one n-block
constexpr int kMaxSlots = 4;
constexpr int kBarBytes = 128;  // the ring's mbarriers, at the start of shared memory
constexpr long long kMaxSmem = 232448;
constexpr int kEmptyArrivals = 8;  // one per consumer warp
// setmaxnreg: the producer warpgroup gives registers to the consumers; the
// pool is the block's 384 x 168 registers at launch
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

// Per compute type: element bytes, K rows per wgmma, elements per 16 bytes,
// m64 tiles per consumer warpgroup, K rows of a plain ring chunk, weight
// arrays (bf16 one; f32 hi and lo).
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int esz = 2, kstep = 16, kin = 8, mt = 4, kc = 128, arrays = 1;
};
template <>
struct Cfg<float> {
  static constexpr int esz = 4, kstep = 8, kin = 4, mt = 1, kc = 32, arrays = 2;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline long long r128(long long n) { return (n + 127) / 128 * 128; }
__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }

// channels padded to 16 bytes
template <typename T>
__host__ __device__ inline int cin_pad(int c) {
  return cdiv(c, Cfg<T>::kin) * Cfg<T>::kin;
}
// pixel pitch of an activation tile: an odd number of 16-byte units
template <typename T>
__host__ __device__ inline int pitch(int c) {
  return (cdiv(c, Cfg<T>::kin) | 1) * Cfg<T>::kin;
}
// input channels of one streamed chunk of a K x K stage
template <typename T>
__host__ __device__ inline int stream_sb(int K, int cin) {
  constexpr int k = Cfg<T>::kstep;
  if (K == 3) return cin % (2 * k) == 0 ? 2 * k : k;
  return cin % (4 * k) == 0 ? 4 * k : cin % (2 * k) == 0 ? 2 * k : k;
}
// the fused route streams stage 1's input when it is wide
template <typename T>
__host__ __device__ inline bool fused_streams(int cin) {
  return cin >= 128 && cin % Cfg<T>::kstep == 0;
}
// bytes of one K row of one n-block, per weight array
template <typename T>
__host__ __device__ constexpr int wrow() {
  return NB * Cfg<T>::esz;
}

// One stage as the producer and the consumers walk it.
struct Stage {
  int K, cp;          // kernel size; channels per tap in the K order
  int krows;          // K rows of one n-block (zero rows past K * K * cp)
  int kc, n_chunks;   // K rows a chunk, chunks a round
  int sb;             // > 0: streamed, sb input channels a chunk
  int slice;          // bytes of a streamed chunk's input slice, 128-aligned
  int oh, ow;         // output grid
  int sw, sp;         // A source: width in pixels, pitch in elements
  int n_nb;           // n-blocks this block computes
  int pair;           // 1: the warpgroups take two n-blocks a round (see pair_mode)
  long long lo_off;   // bytes from the hi array to the lo array (f32)
};

// A stage of few m64 tiles (at most MT, with two n-blocks or more) runs in
// pair mode where the cost model rates it cheaper: the two warpgroups take
// the same tiles and an n-block each, and a slot holds a chunk of each, so
// that neither idles (one tile) or holds half the tiles the other could;
// otherwise they split the tiles. Cost: rounds x (tiles a warpgroup + 1).
template <typename T>
__host__ __device__ inline int pair_mode(int sb, int n_nb, int oh, int ow) {
  const int n_mt = cdiv(oh * ow, 64);
  if (sb != 0 || n_nb < 2 || n_mt > Cfg<T>::mt) return 0;
  return cdiv(n_nb, 2) * (n_mt + 1) < n_nb * (cdiv(n_mt, 2) + 1);
}

template <typename T>
__host__ __device__ inline Stage make_stage(int K, int cin, int oh, int ow, int sb, int n_nb,
                                            int src_w, int src_pitch, int nb_total) {
  Stage s;
  s.K = K;
  s.oh = oh;
  s.ow = ow;
  s.sb = sb;
  s.n_nb = n_nb;
  if (sb > 0) {
    s.cp = sb;
    s.krows = K * K * cin;
    s.kc = K * sb;
    s.n_chunks = cin / sb * K;
    s.sw = ow + K - 1;
    s.sp = sb;
    s.slice = (int)r128((long long)oh * s.sw * sb * Cfg<T>::esz);
  } else {
    s.cp = cin_pad<T>(cin);
    s.krows = cdiv(K * K * s.cp, Cfg<T>::kstep) * Cfg<T>::kstep;
    s.kc = Cfg<T>::kc;
    s.n_chunks = cdiv(s.krows, s.kc);
    s.sw = src_w;
    s.sp = src_pitch;
    s.slice = 0;
  }
  s.pair = pair_mode<T>(sb, n_nb, oh, ow);
  s.lo_off = (long long)nb_total * s.krows * wrow<T>();
  return s;
}

// bytes of the ring slot a stage's largest chunk needs
template <typename T>
__host__ __device__ inline long long slot_need(const Stage& s) {
  return s.slice + (long long)s.kc * wrow<T>() * Cfg<T>::arrays * (s.pair ? 2 : 1);
}

// Stage i (0..3) of the fused route.
template <typename T>
__host__ __device__ inline Stage fused_stage(int i, int cin, int C, int th, int tw) {
  const int n = cdiv(C, NB);
  const int mw = tw + 2, mp = pitch<T>(C);
  if (i == 0)
    return fused_streams<T>(cin)
               ? make_stage<T>(3, cin, th + 2, mw, stream_sb<T>(3, cin), n, 0, 0, n)
               : make_stage<T>(3, cin, th + 2, mw, 0, n, tw + 4, pitch<T>(cin), n);
  if (i < 3) return make_stage<T>(1, C, th + 2, mw, 0, n, mw, mp, n);
  return make_stage<T>(3, C, th, tw, 0, n, mw, mp, n);
}

// Shared memory: the mbarriers, then (fused) A = the intermediate buffer and
// X = the input tile, stage 2's output and the output tile, then the ring.
struct Layout {
  long long a, x, ring, slot, total;
  int slots;
};

__host__ __device__ inline Layout finish_layout(Layout L, long long slot) {
  L.slot = r128(slot);
  long long s = (kMaxSmem - L.ring) / L.slot;
  s = s > kMaxSlots ? kMaxSlots : (s < 2 ? 2 : s);
  L.slots = (int)s;
  L.total = L.ring + s * L.slot;
  return L;
}

template <typename T>
__host__ __device__ inline Layout fused_layout(int cin, int C, int th, int tw) {
  constexpr int e = Cfg<T>::esz;
  const long long mid = r128((long long)(th + 2) * (tw + 2) * pitch<T>(C) * e);
  const long long in =
      fused_streams<T>(cin) ? 0 : r128((long long)(th + 4) * (tw + 4) * pitch<T>(cin) * e);
  Layout L;
  L.a = kBarBytes;
  L.x = L.a + mid;
  L.ring = L.x + lmax(in, mid);
  long long slot = 0;
  for (int i = 0; i < 4; ++i) slot = lmax(slot, slot_need<T>(fused_stage<T>(i, cin, C, th, tw)));
  return finish_layout(L, slot);
}

// The staged route: the barriers, the output tile's staging area, the ring.
template <typename T>
__host__ __device__ inline Layout staged_layout(int K, int cin, int th, int tw) {
  const Stage s = make_stage<T>(K, cin, th, tw, stream_sb<T>(K, cin), 1, 0, 0, 1);
  Layout L;
  L.a = L.x = kBarBytes;
  L.ring = kBarBytes + r128((long long)th * tw * pitch<T>(NB) * Cfg<T>::esz);
  return finish_layout(L, slot_need<T>(s));
}

struct Ring {
  unsigned char* base;
  int slot_bytes, slots;
  uint64_t* full;
  uint64_t* empty;
};

// Rounds of a stage: R per n-block (per pair of n-blocks in pair mode,
// where R = 1), over n_outer n-blocks (pairs).
template <typename T>
__host__ __device__ inline int rounds_per_nb(const Stage& s) {
  return s.pair ? 1 : cdiv(cdiv(s.oh * s.ow, 64), 2 * Cfg<T>::mt);
}
__host__ __device__ inline int n_outer(const Stage& s) { return s.pair ? cdiv(s.n_nb, 2) : s.n_nb; }

// The producer (one thread): every chunk of every round of stage s, in the
// order the consumers take them. w: the block's first n-block.
template <typename T>
__device__ __forceinline__ void produce(const Stage& s, const unsigned char* w, const Ring& r,
                                        int& slot, uint32_t& phase, const void* tmap, int gx0,
                                        int gy0, int img) {
  const int R = rounds_per_nb<T>(s), half = s.kc * wrow<T>() * Cfg<T>::arrays;
  const uint32_t slice_tx = s.sb ? (uint32_t)(s.oh * s.sw * s.sb * Cfg<T>::esz) : 0u;
  for (int q = 0; q < n_outer(s); ++q)
    for (int rp = 0; rp < R; ++rp)
      for (int c = 0; c < s.n_chunks; ++c) {
        mbar_wait(&r.empty[slot], phase ^ 1);
        const int rows = min(s.kc, s.krows - c * s.kc);
        const uint32_t wb = (uint32_t)(rows * wrow<T>());
        const int nb = s.pair ? 2 * q : q, n_cp = s.pair && nb + 1 < s.n_nb ? 2 : 1;
        unsigned char* dst = r.base + (size_t)slot * r.slot_bytes;
        mbar_arrive_tx(&r.full[slot], slice_tx + wb * Cfg<T>::arrays * n_cp);
        if (s.sb) tma_load_4d(dst, tmap, (c / s.K) * s.sb, gx0, gy0 + c % s.K, img, &r.full[slot]);
        for (int j = 0; j < n_cp; ++j) {
          const unsigned char* src =
              w + ((long long)(nb + j) * s.krows + (long long)c * s.kc) * wrow<T>();
          unsigned char* d = dst + s.slice + j * half;
          bulk_g2s(d, src, wb, &r.full[slot]);
          if (Cfg<T>::arrays == 2) bulk_g2s(d + wb, src + s.lo_off, wb, &r.full[slot]);
        }
        if (++slot == r.slots) {
          slot = 0;
          phase ^= 1;
        }
      }
}

// Offset in the A source of pixel p of the stage's output grid (rows past
// P clamp to P - 1; their results are not stored).
__device__ __forceinline__ int pixel_offset(const Stage& s, int p, int P) {
  p = min(p, P - 1);
  return ((p / s.ow) * s.sw + p % s.ow) * s.sp;
}

// Offset in the A source of K row kg: within the chunk (streamed: tap dx of
// the slice's tap row, channel) or of the stage (tap, channel); rows past
// the stage's K read row 0 (their weights are zero).
__device__ __forceinline__ int k_shift(const Stage& s, int kg) {
  if (s.sb) {
    const int dx = kg / s.sb;
    return dx * s.sp + (kg - dx * s.sb);
  }
  if (kg >= s.K * s.K * s.cp) kg = 0;
  const int tap = kg / s.cp;
  return ((tap / s.K) * s.sw + tap % s.K) * s.sp + (kg - tap * s.cp);
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool two) {
  if (two)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else
    p[0] = v0;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1, bool two) {
  if (two)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  else
    p[0] = __float2bfloat16_rn(v0);
}

// Where a stage's epilogue writes: a shared-memory tile of the output grid
// (pixel pitch dp, columns < dcols), columns col0 + local of C.
template <typename T>
struct Epi {
  T* dst;
  int dp, dcols;
  const float* bias;
  int C, col0;
};

// One k step of a consumer warpgroup on MTA m64 tiles: A into registers
// (buffer BUF), then the wgmmas on the slot's weights at wk, one group
// committed; the group before it is waited for, so BUF ^ 1 is free for the
// next step. kg: the step's first K row.
template <int MTA, int BUF>
__device__ __forceinline__ void kstep_bf16(const Stage& s, const __nv_bfloat16* a_src,
                                           const int (&off)[MTA][2], int kg,
                                           const unsigned char* wk, int lane,
                                           uint32_t (&a)[2][MTA][4], float (&acc)[MTA][32]) {
  const int sh = k_shift(s, kg + (lane >> 4) * 8);
#pragma unroll
  for (int mi = 0; mi < MTA; ++mi) ldmatrix_x4(a[BUF][mi], a_src + off[mi][0] + sh);
  const uint64_t db = desc_kmajor(wk, NB * 16, 128);
  wgmma_fence();
#pragma unroll
  for (int mi = 0; mi < MTA; ++mi) wgmma_bf16(acc[mi], a[BUF][mi], db, 1);
  wgmma_commit();
  wgmma_wait<1>();
}

// The same in 3xTF32: A split into hi (ah) and lo (al), the weights' hi
// array at wk and lo at wk + wb; first: the chunk's first step, which
// starts the partial sum from zero.
template <int MTA, int BUF>
__device__ __forceinline__ void kstep_tf32(const Stage& s, const float* a_src,
                                           const int (&off)[MTA][2], int kg,
                                           const unsigned char* wk, int wb, int lane,
                                           uint32_t (&ah)[2][MTA][4], uint32_t (&al)[2][MTA][4],
                                           float (&part)[MTA][32], bool first) {
  const int t = lane & 3;
  const int sh0 = k_shift(s, kg + t), sh1 = k_shift(s, kg + t + 4);
#pragma unroll
  for (int mi = 0; mi < MTA; ++mi) {
    split_tf32(a_src[off[mi][0] + sh0], ah[BUF][mi][0], al[BUF][mi][0]);
    split_tf32(a_src[off[mi][1] + sh0], ah[BUF][mi][1], al[BUF][mi][1]);
    split_tf32(a_src[off[mi][0] + sh1], ah[BUF][mi][2], al[BUF][mi][2]);
    split_tf32(a_src[off[mi][1] + sh1], ah[BUF][mi][3], al[BUF][mi][3]);
  }
  const uint64_t dh = desc_kmajor(wk, NB * 16, 128);
  const uint64_t dl = desc_kmajor(wk + wb, NB * 16, 128);
  wgmma_fence();
#pragma unroll
  for (int mi = 0; mi < MTA; ++mi) wgmma_tf32(part[mi], al[BUF][mi], dh, first ? 0 : 1);
#pragma unroll
  for (int mi = 0; mi < MTA; ++mi) wgmma_tf32(part[mi], ah[BUF][mi], dl, 1);
#pragma unroll
  for (int mi = 0; mi < MTA; ++mi) wgmma_tf32(part[mi], ah[BUF][mi], dh, 1);
  wgmma_commit();
  wgmma_wait<1>();
}

// One round of a consumer warpgroup: MTA m64 tiles from tile m_lo, n-block
// nb, its weights at byte wofs of each slot. MTA = 0: the warpgroup has no
// tile this round and only passes the slots on.
template <typename T, int MTA>
__device__ __forceinline__ void consume_round(const Stage& s, const T* src, const Ring& r,
                                              int& slot, uint32_t& phase, const Epi<T>& e,
                                              int nb, int m_lo, int wofs, int warp, int lane) {
  constexpr int KS = Cfg<T>::kstep, M = MTA > 0 ? MTA : 1;
  constexpr bool BF = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
  const int P = s.oh * s.ow;
  int off[M][2];
  float acc[M][32];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    const int row0 = (m_lo + mi) * 64 + warp * 16;
    if (BF) {
      off[mi][0] = pixel_offset(s, row0 + (lane & 7) + ((lane >> 3) & 1) * 8, P);
      off[mi][1] = 0;
    } else {
      off[mi][0] = pixel_offset(s, row0 + g, P);
      off[mi][1] = pixel_offset(s, row0 + g + 8, P);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[mi][j] = 0.f;
  }
  for (int c = 0; c < s.n_chunks; ++c) {
    mbar_wait(&r.full[slot], phase);
    if constexpr (MTA > 0) {
      const unsigned char* base = r.base + (size_t)slot * r.slot_bytes;
      const T* a_src = s.sb ? reinterpret_cast<const T*>(base) : src;
      const unsigned char* wsl = base + s.slice + wofs;
      const int rows = min(s.kc, s.krows - c * s.kc), nks = rows / KS;
      const int k0 = s.sb ? 0 : c * s.kc;
      const int step = 2 * NB * 16;  // bytes of weights a k step reads
      uint32_t a[2][MTA][4];
      int ks = 0;
      if constexpr (BF) {
#pragma unroll 1
        for (; ks + 2 <= nks; ks += 2) {
          kstep_bf16<MTA, 0>(s, a_src, off, k0 + ks * KS, wsl + ks * step, lane, a, acc);
          kstep_bf16<MTA, 1>(s, a_src, off, k0 + (ks + 1) * KS, wsl + (ks + 1) * step, lane, a,
                             acc);
        }
        if (ks < nks)
          kstep_bf16<MTA, 0>(s, a_src, off, k0 + ks * KS, wsl + ks * step, lane, a, acc);
        wgmma_wait<0>();
#pragma unroll
        for (int mi = 0; mi < MTA; ++mi) pin(acc[mi]);
      } else {
        // each chunk summed from zero, then added to the sum in f32
        const int wb = rows * wrow<T>();  // bytes from the hi weights to the lo
        uint32_t al[2][MTA][4];
        float part[MTA][32];
#pragma unroll 1
        for (; ks + 2 <= nks; ks += 2) {
          kstep_tf32<MTA, 0>(s, a_src, off, k0 + ks * KS, wsl + ks * step, wb, lane, a, al, part,
                             ks == 0);
          kstep_tf32<MTA, 1>(s, a_src, off, k0 + (ks + 1) * KS, wsl + (ks + 1) * step, wb, lane, a,
                             al, part, false);
        }
        if (ks < nks)
          kstep_tf32<MTA, 0>(s, a_src, off, k0 + ks * KS, wsl + ks * step, wb, lane, a, al, part,
                             ks == 0);
        wgmma_wait<0>();
#pragma unroll
        for (int mi = 0; mi < MTA; ++mi) {
          pin(part[mi]);
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[mi][j] += part[mi][j];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.empty[slot]);
    if (++slot == r.slots) {
      slot = 0;
      phase ^= 1;
    }
  }
  if constexpr (MTA > 0) {
    // bias + ReLU, rounded to the compute type; padded columns (C .. cin_pad)
    // come out as zeros, which the next stage's zero weight rows ignore
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * NB + 8 * j + 2 * t, gc = e.col0 + col;
      const float b0 = gc < e.C ? e.bias[gc] : 0.f, b1 = gc + 1 < e.C ? e.bias[gc + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < MTA; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (m_lo + mi) * 64 + warp * 16 + g + 8 * h;
          if (p < P && col < e.dcols)
            store_pair(e.dst + p * e.dp + col, fmaxf(acc[mi][4 * j + 2 * h] + b0, 0.f),
                       fmaxf(acc[mi][4 * j + 2 * h + 1] + b1, 0.f), col + 1 < e.dcols);
        }
    }
  }
}

// The consumers (threads 128..383): every round of stage s. src: the A tile
// (unless streamed). The two warpgroups split each n-block's m64 tiles into
// balanced ranges of at most MT, or, in pair mode, take the same tiles and
// an n-block each.
template <typename T>
__device__ __forceinline__ void consume(const Stage& s, const T* src, const Ring& r, int& slot,
                                        uint32_t& phase, const Epi<T>& e) {
  constexpr int MT = Cfg<T>::mt;
  // warp-uniform (a shuffle from lane 0), so that the branches on it are
  // uniform to the compiler and the wgmmas behind them are not serialised
  const int wgi = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7) - 1, 0);
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int n_mt = cdiv(s.oh * s.ow, 64), R = rounds_per_nb<T>(s);
  const int half = s.kc * wrow<T>() * Cfg<T>::arrays;
  for (int q = 0; q < n_outer(s); ++q)
    for (int rp = 0; rp < R; ++rp) {
      int nb, m_lo, m_cnt, wofs = 0;
      if (s.pair) {
        nb = 2 * q + wgi;
        m_lo = 0;
        m_cnt = nb < s.n_nb ? n_mt : 0;
        wofs = wgi * half;
      } else {
        const int i = 2 * rp + wgi;
        nb = q;
        m_lo = i * n_mt / (2 * R);
        m_cnt = (i + 1) * n_mt / (2 * R) - m_lo;
      }
      switch (m_cnt) {
        case 1:
          consume_round<T, 1>(s, src, r, slot, phase, e, nb, m_lo, wofs, warp, lane);
          break;
        case 2:
          consume_round<T, (MT >= 2 ? 2 : 1)>(s, src, r, slot, phase, e, nb, m_lo, wofs,
                                              warp, lane);
          break;
        case 3:
          consume_round<T, (MT >= 3 ? 3 : 1)>(s, src, r, slot, phase, e, nb, m_lo, wofs,
                                              warp, lane);
          break;
        case 4:
          consume_round<T, (MT >= 4 ? 4 : 1)>(s, src, r, slot, phase, e, nb, m_lo, wofs,
                                              warp, lane);
          break;
        default:
          consume_round<T, 0>(s, src, r, slot, phase, e, nb, m_lo, wofs, warp, lane);
      }
    }
}

// Copy the th x tw output tile staged in shared memory (pixel pitch sp,
// columns [0, n) of the image's columns [col0, col0 + n)) to the image,
// clipped to (h_out, w_out); 16-byte stores where the rows allow.
template <typename T>
__device__ __forceinline__ void store_tile(const T* st, int sp, T* __restrict__ out, int ldc,
                                           int col0, int n, int gy0, int gx0, int th, int tw,
                                           int h_out, int w_out) {
  constexpr int V = Cfg<T>::kin;
  const int tid = threadIdx.x - (kThreads - kConsumers);
  const int rows = min(th, h_out - gy0), cols = min(tw, w_out - gx0);
  if (ldc % V == 0 && n % V == 0) {
    const int vpp = n / V;
    for (int idx = tid; idx < rows * cols * vpp; idx += kConsumers) {
      const int q = idx / vpp, v = idx - q * vpp, y = q / cols, x = q - y * cols;
      *reinterpret_cast<int4*>(out + ((size_t)(gy0 + y) * w_out + gx0 + x) * ldc + col0 + v * V) =
          *reinterpret_cast<const int4*>(st + (y * tw + x) * sp + v * V);
    }
  } else {
    for (int idx = tid; idx < rows * cols * n; idx += kConsumers) {
      const int q = idx / n, ch = idx - q * n, y = q / cols, x = q - y * cols;
      out[((size_t)(gy0 + y) * w_out + gx0 + x) * ldc + col0 + ch] = st[(y * tw + x) * sp + ch];
    }
  }
}

// Shared setup of both kernels: barriers, then the role split. Returns the
// ring.
__device__ __forceinline__ Ring init_ring(unsigned char* smem, const Layout& L) {
  Ring r;
  r.full = reinterpret_cast<uint64_t*>(smem);
  r.empty = r.full + kMaxSlots;
  r.base = smem + L.ring;
  r.slot_bytes = (int)L.slot;
  r.slots = L.slots;
  if (threadIdx.x == 0) {
    for (int i = 0; i < r.slots; ++i) {
      mbar_init(&r.full[i], 1);
      mbar_init(&r.empty[i], kEmptyArrivals);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv_pass_kernel(const __grid_constant__ CUtensorMap tmap, const T* __restrict__ x,
                 const unsigned char* __restrict__ w1, const float* __restrict__ b1,
                 const unsigned char* __restrict__ w2, const float* __restrict__ b2,
                 const unsigned char* __restrict__ w3, const float* __restrict__ b3,
                 const unsigned char* __restrict__ w4, const float* __restrict__ b4,
                 T* __restrict__ out, int H, int W, int cin, int C, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = fused_layout<T>(cin, C, th, tw);
  const Ring r = init_ring(smem, L);
  const int h_out = H - 4, w_out = W - 4;
  const int tiles_x = cdiv(w_out, tw);
  const int gy0 = (blockIdx.x / tiles_x) * th, gx0 = (blockIdx.x % tiles_x) * tw;
  const int img = blockIdx.y;

  // the role split on a warp-uniform warpgroup index, one if / else that
  // never reconverges, so that setmaxnreg sets each side's register budget
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 0) {  // producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < 4; ++i)
        produce<T>(fused_stage<T>(i, cin, C, th, tw), i == 0 ? w1 : i == 1 ? w2 : i == 2 ? w3 : w4,
                   r, slot, phase, &tmap, gx0, gy0, img);
    }
  } else {
    regs_inc<kConsumerRegs>();
    T* buf_a = reinterpret_cast<T*>(smem + L.a);
    T* buf_x = reinterpret_cast<T*>(smem + L.x);
    const int mp = pitch<T>(C), mcols = cin_pad<T>(C);
    if (!fused_streams<T>(cin)) {
      // input tile (th+4, tw+4, cin_pad) at pitch(cin); zeros past the image
      // edge (they only feed outputs that are clipped away) and past cin
      constexpr int V = Cfg<T>::kin;
      const int tid = threadIdx.x - (kThreads - kConsumers);
      const int iw = tw + 4, n_pix = (th + 4) * iw, ip = pitch<T>(cin), cp = cin_pad<T>(cin);
      const T* xin = x + (size_t)img * H * W * cin;
      if (cin % V == 0) {
        const int nv = cp / V;
        for (int idx = tid; idx < n_pix * nv; idx += kConsumers) {
          const int p = idx / nv, v = idx - p * nv;
          const int gy = gy0 + p / iw, gx = gx0 + p % iw;
          const bool ok = gy < H && gx < W;
          cp_async16(buf_x + p * ip + v * V, ok ? xin + ((size_t)gy * W + gx) * cin + v * V : xin,
                     ok ? 16 : 0);
        }
        cp_async_wait_all();
      } else {
        for (int idx = tid; idx < n_pix * cp; idx += kConsumers) {
          const int p = idx / cp, ci = idx - p * cp;
          const int gy = gy0 + p / iw, gx = gx0 + p % iw;
          buf_x[p * ip + ci] =
              (gy < H && gx < W && ci < cin) ? xin[((size_t)gy * W + gx) * cin + ci] : T(0.f);
        }
      }
      named_sync(1, kConsumers);
    }
    int slot = 0;
    uint32_t phase = 0;
    consume<T>(fused_stage<T>(0, cin, C, th, tw), buf_x, r, slot, phase,
               {buf_a, mp, mcols, b1, C, 0});
    named_sync(1, kConsumers);
    consume<T>(fused_stage<T>(1, cin, C, th, tw), buf_a, r, slot, phase,
               {buf_x, mp, mcols, b2, C, 0});
    named_sync(1, kConsumers);
    consume<T>(fused_stage<T>(2, cin, C, th, tw), buf_x, r, slot, phase,
               {buf_a, mp, mcols, b3, C, 0});
    named_sync(1, kConsumers);
    consume<T>(fused_stage<T>(3, cin, C, th, tw), buf_a, r, slot, phase,
               {buf_x, mp, C, b4, C, 0});
    named_sync(1, kConsumers);
    store_tile<T>(buf_x, mp, out + (size_t)img * h_out * w_out * C, C, 0, C, gy0, gx0, th, tw,
                  h_out, w_out);
  }
}

// One K x K stage of the staged route: (B, H, W, cin) -> (B, H-K+1, W-K+1, C)
// in the compute type. Block (tile, n-block, image): a th x tw output tile
// and 64 of its channels, the input streamed through the ring by TMA.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv_stage_kernel(const __grid_constant__ CUtensorMap tmap, const unsigned char* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int H, int W, int K,
                  int cin, int C, int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = staged_layout<T>(K, cin, th, tw);
  const Ring r = init_ring(smem, L);
  const int h_out = H - K + 1, w_out = W - K + 1;
  const int tiles_x = cdiv(w_out, tw);
  const int gy0 = (blockIdx.x / tiles_x) * th, gx0 = (blockIdx.x % tiles_x) * tw;
  const int nb = blockIdx.y, img = blockIdx.z;

  const Stage s = make_stage<T>(K, cin, th, tw, stream_sb<T>(K, cin), 1, 0, 0, cdiv(C, NB));
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == 0) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int slot = 0;
      uint32_t phase = 0;
      produce<T>(s, w + (size_t)nb * s.krows * wrow<T>(), r, slot, phase, &tmap, gx0, gy0, img);
    }
  } else {
    regs_inc<kConsumerRegs>();
    T* stage_out = reinterpret_cast<T*>(smem + L.a);
    const int sp = pitch<T>(NB), n = min(NB, C - nb * NB);
    int slot = 0;
    uint32_t phase = 0;
    consume<T>(s, nullptr, r, slot, phase, {stage_out, sp, n, bias, C, nb * NB});
    named_sync(1, kConsumers);
    store_tile<T>(stage_out, sp, out + (size_t)img * h_out * w_out * C, C, nb * NB, n, gy0, gx0,
                  th, tw, h_out, w_out);
  }
}

// Relative cost of a pass with th x tw tiles over an H x W input: blocks x
// the k steps of the busier consumer warpgroup, summed over stages and
// rounds, each round charged one m64 tile more for its fill and epilogue.
template <typename T>
long long pass_cost(int cin, int C, int th, int tw, int H, int W) {
  long long per_block = 0;
  for (int i = 0; i < 4; ++i) {
    const Stage s = fused_stage<T>(i, cin, C, th, tw);
    const int n_mt = cdiv(s.oh * s.ow, 64), R = rounds_per_nb<T>(s);
    const int per_wg = s.pair ? n_mt : cdiv(n_mt, 2 * R);
    per_block += (long long)n_outer(s) * R * (per_wg + 1) * (s.krows / Cfg<T>::kstep);
  }
  return (long long)cdiv(H - 4, th) * cdiv(W - 4, tw) * per_block;
}

// error code of the register pool, beside CUDA's and the map's (tensor_map.cuh)
constexpr int kRegisterPool = 9003;

// setmaxnreg.inc waits until the pool holds the registers it asks for: a
// kernel launched with fewer than 168 registers a thread would wait forever.
template <typename K>
int check_register_pool(K kernel) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  const int need = kProducerRegs * (kThreads - kConsumers) + kConsumerRegs * kConsumers;
  return a.numRegs * kThreads >= need ? 0 : kRegisterPool;
}

template <typename T>
int launch_stage(const T* x, const void* w, const float* b, T* out, int B, int H, int W, int K,
                 int cin, int C, int th, int tw, cudaStream_t stream) {
  const Layout L = staged_layout<T>(K, cin, th, tw);
  int rc = check_register_pool(conv_stage_kernel<T>);
  if (rc) return rc;
  CUtensorMap map;
  rc = tmap::encode_nhwc(&map, x, B, H, W, cin, stream_sb<T>(K, cin), tw + K - 1, th, Cfg<T>::esz);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(conv_stage_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(H - K + 1, th) * cdiv(W - K + 1, tw), cdiv(C, NB), B);
  conv_stage_kernel<T><<<grid, kThreads, L.total, stream>>>(
      map, (const unsigned char*)w, b, out, H, W, K, cin, C, th, tw);
  return (int)cudaGetLastError();
}

// The staged route: the pass's four stages, one launch each, x -> s0 -> s1
// -> s0 -> out; s0 and s1 hold (B, H-2, W-2, C) in the compute type.
template <typename T>
int launch_staged(const void* x, const void* const* w, const float* const* b, void* out, void* s0,
                  void* s1, int B, int H, int W, int cin, int C, int th, int tw,
                  cudaStream_t stream) {
  T* t0 = (T*)s0;
  T* t1 = (T*)s1;
  int rc = launch_stage<T>((const T*)x, w[0], b[0], t0, B, H, W, 3, cin, C, th, tw, stream);
  if (rc == 0) rc = launch_stage<T>(t0, w[1], b[1], t1, B, H - 2, W - 2, 1, C, C, th, tw, stream);
  if (rc == 0) rc = launch_stage<T>(t1, w[2], b[2], t0, B, H - 2, W - 2, 1, C, C, th, tw, stream);
  if (rc == 0)
    rc = launch_stage<T>(t0, w[3], b[3], (T*)out, B, H - 2, W - 2, 3, C, C, th, tw, stream);
  return rc;
}

template <typename T>
int launch(const void* x, const void* const* w, const float* const* b, void* out, int B, int H,
           int W, int cin, int C, int th, int tw, cudaStream_t stream) {
  const Layout L = fused_layout<T>(cin, C, th, tw);
  const int pool = check_register_pool(conv_pass_kernel<T>);
  if (pool) return pool;
  CUtensorMap map;
  memset(&map, 0, sizeof map);
  if (fused_streams<T>(cin)) {
    const int rc = tmap::encode_nhwc(&map, x, B, H, W, cin, stream_sb<T>(3, cin), tw + 4, th + 2,
                                    Cfg<T>::esz);
    if (rc) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(conv_pass_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(H - 4, th) * cdiv(W - 4, tw), B);
  const unsigned char* const* wb = reinterpret_cast<const unsigned char* const*>(w);
  conv_pass_kernel<T><<<grid, kThreads, L.total, stream>>>(
      map, (const T*)x, wb[0], b[0], wb[1], b[1], wb[2], b[2], wb[3], b[3], (T*)out, H, W, cin, C,
      th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the fused route needs for a
// th x tw output tile; elem_bytes is 4 (float32) or 2 (bfloat16).
long long conv_pass_2d_smem_bytes(int cin, int C, int th, int tw, int elem_bytes) {
  return elem_bytes == 2 ? fused_layout<__nv_bfloat16>(cin, C, th, tw).total
                         : fused_layout<float>(cin, C, th, tw).total;
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
  return elem_bytes == 2 ? staged_layout<__nv_bfloat16>(K, cin, th, tw).total
                         : staged_layout<float>(K, cin, th, tw).total;
}

// The staged route (one launch per stage); w1..w4 packed by the wrapper for
// this route; s0, s1: scratch of B x (H-2) x (W-2) x C elements each. cin and
// C must be multiples of 16 (bf16) or 8 (f32). Returns the first error code
// (0 = ok; CUDA's, 9001/9002 when the TMA map cannot be encoded, 9003 when
// the kernel's register pool cannot serve setmaxnreg).
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

// The fused route; w1..w4 packed by the wrapper for this route. dtype: 0 =
// float32, 1 = bfloat16. Returns the error code (0 = ok).
int conv_pass_2d_launch(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, const void* w4,
                        const void* b4, void* out, int B, int H, int W, int cin, int C, int th,
                        int tw, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* w[4] = {w1, w2, w3, w4};
  const float* b[4] = {(const float*)b1, (const float*)b2, (const float*)b3, (const float*)b4};
  if (dtype == 0) return launch<float>(x, w, b, out, B, H, W, cin, C, th, tw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, out, B, H, W, cin, C, th, tw, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
