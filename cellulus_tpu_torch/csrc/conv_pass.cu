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
//     16 channels and a barrier at a time. In float32 it now runs on the
//     same producer and consumers, one launch per stage: a block takes a
//     16 x 16 output tile and one n-block, its input streamed by TMA in
//     slices of 16 channels a 3x3 chunk, 32 a 1x1 chunk; its output tile is
//     staged in shared memory of its own. bfloat16 takes its own kernel,
//     below.
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
// The bf16 staged route takes every bf16 pass where its cost model rates it
// faster than the fused tile (all passes of the 64- and 256-fmap models):
// one launch a stage, the intermediates in device memory in bf16 (the
// rounding points stay those of conv_pass_2d_plain). Its stages are large
// implicit GEMMs (the 256-fmap model at the cell's 128 copies of a 252^2
// tile: M = 128 x 250^2 / 122^2 / 238^2 pixels, K up to 9 x 1,024), so
// operations bound the 3x3 stages; the 1x1 stages of the 256-wide `down`
// pass (250^2 x 256 in and out, 32 MB a copy each way) and the 64-wide ones
// are bound by their bytes, 3.35 TB/s. Its kernels:
//
// (a) conv_stage_kernel_persistent<256> (C > 64; the bottom pass and `down`
//     after its first stage). The earlier 16 x 16 x
//     64-column block read each input slice again for every 64 output
//     columns, fed A from registers (wgmma serialised, C7512) and paid each
//     block's ring fill and epilogue alone, about 26% of the bound. Now:
//   - a tile is 128 output pixels (a box of bh x bw, the one that pads the
//     grid least: 1 x 128 at the 122-, 120-, 250- and 248-wide grids) x
//     256 output channels; two consumer warpgroups each issue wgmma
//     m64n256k16 on 64 of its pixels (128 f32 accumulators a thread), one
//     group in flight;
//   - both operands come from shared memory by descriptor, K-major in
//     128-byte swizzled rows: A for tap (dy, dx) and 64 input channels is
//     one TMA box of the NHWC input at (c0, x0 + dx, y0 + dy, image), whose
//     128-byte swizzled layout is the descriptor's and whose zero fill
//     takes the image edge (tiled boxes, not TMA's im2col mode); B is a
//     chunk of the weights packed once a call (ops/conv_pass.py
//     pack_stage_persistent) into that layout, one 32 KB bulk copy into
//     the same slot;
//   - a ring of 3 slots of 48 KB beside the 64 KB output tile, on full
//     and empty mbarriers, fed by one producer warp (288 threads);
//   - one block an SM walks the tiles with the n-tiles of an m-tile
//     neighbours (a stage's weights, at most 10.6 MB, stay in L2), the 9
//     taps of a 64-channel block in turn; each tile's epilogue (f32 bias,
//     ReLU, one rounding to bf16, conflict-free into swizzled shared
//     memory, then TMA stores clipped at the output's edge) overlaps the
//     producer's loads of the next tile.
//   Bound: at 87 FLOP a byte of L2 traffic a chunk (48 KB for 4.19
//   MFLOP), L2 feeds the ring at 75-78% of the tensor cores' peak on the
//   3x3 stages (measured, PERF.md); the 1x1 stages reach 57% (768 wide) or
//   their byte bound (256 wide, 74%).
// (b) conv_stage_kernel_persistent<64> (C <= 64: the up passes, the 64-fmap
//     model's down pass). A 64-column n-block was the fused route's only
//     width: there `up`'s 3x3 1,024 -> 64 stage (K = 9,216) ran as one
//     narrow n-block, A from registers, at about 19% of its bound. Here:
//   - a tile is two rows of 128 output pixels x 64 channels; wgmma puts the
//     pixels on N, m64n128k16 with the 64 output channels' weights as A and
//     a warpgroup's row of 128 pixels as B (64 accumulators a thread), so
//     the instruction is as wide as the stage allows;
//   - a chunk is one tap row dy x 64 input channels: the TMA box of the
//     two rows is K - 1 pixels wider than the tile (130 x 2 pixels, 33 KB)
//     and each tap dx reads it from its pixel dx on (a descriptor start one
//     or two 128-byte rows into the swizzle's period: the XOR is taken on
//     the address bits as TMA wrote them, base offset 0); its weights are
//     the tap row's three 8 KB chunks of the pack, one 24 KB bulk copy. So
//     an input slice leaves L2 once for 3 taps: 57 KB of a slot for 6.3
//     MFLOP, 110 FLOP a byte (a tap a chunk was 52 and ran at 40% of the
//     bound, L2-bound);
//   - 3 slots of 57 KB beside the 32 KB output tile (4 of 40 KB at 1x1);
//     the epilogue writes the transposed results pixel-major into the
//     swizzled staging tiles, then TMA stores as (a).
//   Bound: 3x3 stages at 62-68% of the tensor cores' peak (1,024 -> 64 at
//   66%), 1x1 stages at 75-86% of their byte bound (PERF.md).
// (c) conv_stage_kernel_first (cin % 8 != 0: the first stage of a one- or
//     three-channel image, 3x3 only), on the CUDA cores: 9 x cin K values
//     would fill a 64-channel chunk to a ninth or less (64x the work at cin
//     = 1), and TMA cannot stride the input. A thread computes 4 pixels of
//     a row x 8 channels from f32 weights in shared memory, reading each
//     input pixel of a tap row once for the three taps dx. Bound: its
//     output's bytes (32 MB a 250^2 copy at 256 channels); it runs at 46%
//     of that, about 7 FMA a picosecond (PERF.md).
//
// Where the bytes of the intermediates go: the 256-fmap `down` pass writes
// and reads three 250^2 x 256 bf16 intermediates, 24.6 GB at the cell's 128
// copies (7.3 ms at 3.35 TB/s) against the 11.5 ms its FLOPs need at peak;
// the fused route held them in shared memory but recomputed a 12 x 12 halo
// for every 10 x 10 output tile and padded 100 pixels to 128 (1.9x the work
// of its 1x1 stages). conv_pass_2d_plan weighs the two with the cost model
// between the "K1 staged plan" markers, calibrated on the H100.
//
// Registers and spills (nvcc -Xptxas -v, CUDA 12.8, as chip_smoke.py
// prints them at its build): conv_pass_kernel and conv_stage_kernel 168
// registers a thread, 2 named barriers, spill stores / loads in bytes:
// conv_pass_kernel<bf16> 176 / 256, conv_pass_kernel<float> 1,180 / 2,388,
// conv_stage_kernel<float> none; ptxas reports the wgmmas of
// conv_pass_kernel<bf16> serialised for register resources (C7512).
// conv_stage_kernel_persistent<256> 168 registers, <64> 128,
// conv_stage_kernel_first 95: no spill, no C7512.

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

// ---- K1 staged plan begin: plain C++ (the CPU tests build it with g++) ---
// The bf16 staged route, one launch a stage. A K x K stage whose input
// channels TMA can stride (cin % 8 == 0) is a persistent implicit GEMM
// (conv_stage_kernel_persistent<BN>): tiles of BM output pixels, a box of
// bh x bw, x BN output channels. BN = 256 (C > 64): BM = 128, bh = 1, 2, 4
// or 8, K in chunks of one tap x 64 input channels. BN = 64 (C <= 64): BM
// = 256 as two rows of 128, K in chunks of one tap row dy x 64 input
// channels, the input box K - 1 pixels wider than the tile so that its K
// taps dx read it shifted. A stage of fewer input channels (the first stage
// of a one-channel image) runs on the CUDA cores (conv_stage_kernel_first).
constexpr int kGemmK = 64;
constexpr int kGemmMaxSlots = 8;
constexpr int kGemmAlign = 1024;  // the 128-byte swizzle's period
constexpr long long kGemmSmemLimit = 232448;

__host__ __device__ constexpr int gemm_bm(int bn) { return bn == 64 ? 256 : 128; }
__host__ __device__ constexpr int gemm_out_bytes(int bn) { return gemm_bm(bn) * bn * 2; }
__host__ __device__ inline int gemm_bn(int C) { return C <= 64 ? 64 : 256; }

struct GemmPlan {
  int bm, bn;                   // the tile: bm output pixels x bn output channels
  int bh, bw;                   // the box of bm output pixels
  int tiles_y, tiles_x;         // boxes over one output image
  long long m_tiles;            // boxes over the batch
  int n_tiles;                  // bn-column tiles of C
  long long tiles;              // m_tiles x n_tiles, the blocks' walk
  int n_cb, chunks;             // 64-channel blocks of cin; chunks a tile
  int taps;                     // taps a chunk: K (BN = 64) or 1
  int box_w;                    // the input box's width: bw + taps - 1
  int a_tx, a_bytes, b_bytes;   // a chunk's input box (its bytes; its room, 1024-aligned), weights
  int slots;                    // ring slots of A and B
  long long smem;               // dynamic shared bytes, the alignment's slack included
};

__host__ __device__ inline int gemm_cdiv(int a, int b) { return (a + b - 1) / b; }

// The box is the one that pads the output grid least (the widest on a tie;
// two rows of 128 at BN = 64). The ring takes what shared memory leaves
// beside the output tile, the barriers and the alignment's slack.
__host__ __device__ inline GemmPlan gemm_plan(int B, int oh, int ow, int K, int cin, int C) {
  GemmPlan p;
  p.bn = gemm_bn(C);
  p.bm = gemm_bm(p.bn);
  long long best = -1;
  p.bh = 2;
  if (p.bn == 256)
    for (int bh = 1; bh <= 8; bh *= 2) {
      const int bw = p.bm / bh;
      const long long area = (long long)gemm_cdiv(oh, bh) * bh * gemm_cdiv(ow, bw) * bw;
      if (best < 0 || area < best) {
        best = area;
        p.bh = bh;
      }
    }
  p.bw = p.bm / p.bh;
  p.tiles_y = gemm_cdiv(oh, p.bh);
  p.tiles_x = gemm_cdiv(ow, p.bw);
  p.m_tiles = (long long)B * p.tiles_y * p.tiles_x;
  p.n_tiles = gemm_cdiv(C, p.bn);
  p.tiles = p.m_tiles * p.n_tiles;
  p.n_cb = gemm_cdiv(cin, kGemmK);
  p.taps = p.bn == 64 ? K : 1;
  p.chunks = K * K * p.n_cb / p.taps;
  p.box_w = p.bw + p.taps - 1;
  p.a_tx = p.bh * p.box_w * kGemmK * 2;
  p.a_bytes = gemm_cdiv(p.a_tx, kGemmAlign) * kGemmAlign;
  p.b_bytes = p.taps * p.bn * kGemmK * 2;
  const long long slot = p.a_bytes + p.b_bytes;
  const long long fixed = kGemmAlign + gemm_out_bytes(p.bn) + 2 * kGemmMaxSlots * 8;
  const long long s = (kGemmSmemLimit - fixed) / slot;
  p.slots = (int)(s < kGemmMaxSlots ? s : kGemmMaxSlots);
  p.smem = fixed + (long long)p.slots * slot;
  return p;
}

// Tile t of the walk: the n-tiles of one m-tile are neighbours, so that
// blocks running together share its input in L2 and it leaves device
// memory once; every weight tile of a stage (at most 10.6 MB at C = 768)
// stays in L2. The taps of a 64-channel block follow each other, so that
// the input rows they share are read from L2, not device memory (a tile's
// taps of all 1,024 channels, 1.6 MB at the up pass's 256 x 64 tiles,
// would not stay there across 132 SMs): chunk c of a tile is channels 64
// (c / (K x K)) at tap c % (K x K) (BN = 256), or channels 64 (c / K) at
// tap row c % K, its K taps dx (BN = 64).
__host__ __device__ inline void gemm_tile(const GemmPlan& p, long long t, int& img, int& y0,
                                          int& x0, int& nt) {
  nt = (int)(t % p.n_tiles);
  const long long m = t / p.n_tiles;
  const long long per_img = (long long)p.tiles_y * p.tiles_x;
  img = (int)(m / per_img);
  const int r = (int)(m - img * per_img);
  y0 = (r / p.tiles_x) * p.bh;
  x0 = (r % p.tiles_x) * p.bw;
}

// The CUDA-core stage: blocks of kFirstThreads threads, a thread taking
// kFirstPix neighbouring output pixels of a row x 8 output channels (one
// 16-byte store a pixel), the f32 weights in shared memory.
constexpr int kFirstThreads = 256, kFirstPix = 4;

struct FirstPlan {
  int groups;       // 8-channel groups of C: the threads of one pixel group
  int per_block;    // pixel groups a block takes at once
  long long items;  // pixel groups of the batch: kFirstPix pixels of a row
  long long smem;   // the weights, K * K * cin * C floats
};

__host__ __device__ inline FirstPlan first_plan(int B, int oh, int ow, int K, int cin, int C) {
  FirstPlan p;
  p.groups = C / 8;
  p.per_block = p.groups > 0 ? kFirstThreads / p.groups : 0;
  p.items = (long long)B * oh * gemm_cdiv(ow, kFirstPix);
  p.smem = 4LL * K * K * cin * C;
  return p;
}

// Whether the bf16 staged route takes a pass of cin -> C channels: every
// stage's output TMA-strided (C % 8 == 0), and the first stage on the
// persistent kernel (cin % 8 == 0) or on the CUDA cores (its weights in
// shared memory, a pixel's channel groups within a block).
__host__ __device__ inline bool staged_takes(int cin, int C) {
  if (C % 8 != 0) return false;
  return cin % 8 == 0 ||
         (C / 8 <= kFirstThreads && first_plan(1, 1, 1, 3, cin, C).smem <= kGemmSmemLimit);
}

// The cost model that chooses between the routes, in picoseconds on an
// H100 SXM (132 SMs, HBM 3.35 bytes a picosecond). A persistent stage:
// its busiest block's tiles x (chunks x a chunk's time (a tap's at BN =
// 64) + a tile's epilogue and first wait), or its input and output
// through HBM if that is longer; the CUDA-core stage: its FMAs at kFirstFmaPerPs, or its bytes.
// The fused route: its cost (conv_pass_2d_cost, k steps of a consumer
// warpgroup summed over an image's blocks) x kFusedUnitPs over the SMs, one
// block an SM. The times are the H100's, measured (csrc header, PERF.md).
constexpr long long kSms = 132;
constexpr long long kChunkPs256 = 646000, kTilePs256 = 1950000;
constexpr long long kTapPs64 = 384000, kTilePs64 = 870000;
constexpr long long kFirstFmaPerPs = 7;
constexpr long long kFusedUnitPs = 110000;

__host__ __device__ inline long long hbm_ps(long long bytes) { return bytes * 1000 / 3350; }

__host__ __device__ inline long long staged_stage_ps(int B, int H, int W, int K, int cin, int C) {
  const int oh = H - K + 1, ow = W - K + 1;
  const long long out = (long long)B * oh * ow * C;
  const long long io = hbm_ps(2 * ((long long)B * H * W * cin + out));
  long long t;
  if (cin % 8 != 0) {
    t = out * K * K * cin / kFirstFmaPerPs;
  } else {
    const GemmPlan p = gemm_plan(B, oh, ow, K, cin, C);
    const long long waves = (p.tiles + kSms - 1) / kSms;
    t = p.bn == 64 ? waves * (p.chunks * p.taps * kTapPs64 + kTilePs64)
                   : waves * (p.chunks * kChunkPs256 + kTilePs256);
  }
  return t > io ? t : io;
}

// the staged route's four stages: x -> s0 -> s1 -> s0 -> out
__host__ __device__ inline long long staged_pass_ps(int B, int H, int W, int cin, int C) {
  return staged_stage_ps(B, H, W, 3, cin, C) + 2 * staged_stage_ps(B, H - 2, W - 2, 1, C, C) +
         staged_stage_ps(B, H - 2, W - 2, 3, C, C);
}

__host__ __device__ inline long long fused_pass_ps(int B, long long cost) {
  return B * cost * kFusedUnitPs / kSms;
}
// ---- K1 staged plan end ----------------------------------------------------

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

// The float32 staged route: the barriers, the output tile's staging area, the ring.
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

// One K x K stage of the bf16 staged route: (B, oh + K - 1, ow + K - 1,
// cin) -> (B, oh, ow, C), a persistent implicit GEMM of BM x BN tiles
// (gemm_plan). One block an SM walks the plan's tiles (gemm_tile); a
// producer warp (warp 8) streams each tile's chunks into a ring of slots, A
// as a TMA box of the input at the chunk's tap and B as one bulk copy of
// packed weights, both completing on the slot's full barrier; two consumer
// warpgroups each take half of the tile's pixels (BM / 2) and issue, both
// operands read from the slot by descriptor, wgmma m64n256k16 (BN = 256:
// the pixels as A, the weights as B) or m64n128k16 (BN = 64: the 64 output
// channels' weights as A, the warpgroup's 128 pixels as B, so that the
// instruction is wide where the stage is), one wgmma group in flight, and
// release the slot on its empty barrier (one arrival a warp) once the group
// after it is issued. The epilogue (bias, ReLU, one rounding to bf16)
// writes the warpgroup's results to shared memory as 64-pixel x 64-channel
// tiles in 128-byte swizzled rows, which TMA stores take to the output,
// clipped at its edges; meanwhile the producer fills the ring with the next
// tile's chunks.
constexpr int kGemmThreads = 288;  // two consumer warpgroups, then the producer warp
constexpr int kGemmEmptyArrivals = 8;

template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
conv_stage_kernel_persistent(const __grid_constant__ CUtensorMap in_map,
                             const __grid_constant__ CUtensorMap out_map,
                             const unsigned char* __restrict__ w, const float* __restrict__ bias,
                             int B, int oh, int ow, int K, int cin, int C) {
  constexpr int MT = gemm_bm(BN) / 128;  // 64-pixel store tiles a consumer warpgroup
  constexpr int NS = BN / 64;  // 64-channel store tiles of a 64-pixel tile
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const GemmPlan p = gemm_plan(B, oh, ow, K, cin, C);
  // a chunk's bytes: its input box (and the box's room in the slot), its
  // weights; constants at BN = 256 (one tap, a 128-pixel box)
  const int a_tx = BN == 256 ? 128 * 128 : p.a_tx, a_bytes = BN == 256 ? 128 * 128 : p.a_bytes;
  const int b_bytes = BN == 256 ? 256 * 128 : p.b_bytes, SLOT = a_bytes + b_bytes;
  unsigned char* ring = gemm_smem + ((kGemmAlign - (smem_u32(gemm_smem) & (kGemmAlign - 1))) &
                                     (kGemmAlign - 1));
  unsigned char* staging = ring + (size_t)p.slots * SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + gemm_out_bytes(BN));
  uint64_t* empty = full + kGemmMaxSlots;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kGemmEmptyArrivals);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  int slot = 0;
  uint32_t phase = 0;
  if (warp == 8) {  // the producer: one thread issues every copy
    if (lane == 0)
      for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int img, y0, x0, nt;
        gemm_tile(p, t, img, y0, x0, nt);
        const unsigned char* wt = w + (size_t)nt * p.chunks * b_bytes;
        for (int c = 0; c < p.chunks; ++c) {
          // BN = 256: 64 channels at one tap; BN = 64: at one tap row, all its taps dx
          int cb, dx, dy;
          if constexpr (BN == 256) {
            cb = c / (K * K);
            dy = (c - cb * K * K) / K;
            dx = c - cb * K * K - dy * K;
          } else {
            cb = c / K;
            dy = c - cb * K;
            dx = 0;
          }
          mbar_wait(&empty[slot], phase ^ 1);
          unsigned char* dst = ring + (size_t)slot * SLOT;
          mbar_arrive_tx(&full[slot], (uint32_t)(a_tx + b_bytes));
          tma_load_4d(dst, &in_map, cb * kGemmK, x0 + dx, y0 + dy, img, &full[slot]);
          bulk_g2s(dst + a_bytes, wt + (size_t)c * b_bytes, b_bytes, &full[slot]);
          if (++slot == p.slots) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;  // warpgroup; warp within it
  const int g = lane >> 2, tq = lane & 3, tid = threadIdx.x & 127;
  unsigned char* st = staging + wg * (gemm_out_bytes(BN) / 2);  // MT x NS swizzled 64 x 64 tiles
  for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int img, y0, x0, nt;
    gemm_tile(p, t, img, y0, x0, nt);
    // BN = 256: D = the warpgroup's 64 pixels x 256 channels; BN = 64: D =
    // 64 channels x the warpgroup's 128 pixels (the weights as A)
    float acc[BN == 256 ? 128 : 64];
    int prev = 0;
    for (int c = 0; c < p.chunks; ++c) {
      mbar_wait(&full[slot], phase);
      const unsigned char* a = ring + (size_t)slot * SLOT;
      // rows of 128 bytes: the warpgroup's pixels of the box, the chunk's weights
      wgmma_fence();
      if constexpr (BN == 256) {
        const uint64_t dx = desc_kmajor_sw128(a + wg * 8192);
        const uint64_t dw = desc_kmajor_sw128(a + a_bytes);
#pragma unroll
        for (int k = 0; k < kGemmK / 16; ++k)  // 16 K values (32 bytes) a wgmma
          wgmma_bf16_n256_ss(acc, dx + 2 * k, dw + 2 * k, c > 0 || k > 0);
      } else {
        // tap dx: the warpgroup's row of the box from its pixel dx on. The
        // start may lie whole 128-byte rows into the swizzle's 8-row period:
        // wgmma XORs the address bits as TMA did, so the descriptor reads
        // what TMA wrote there with its base offset left 0 (on the H100 a
        // base offset of (start >> 7) & 7 gave wrong sums)
        for (int dx = 0; dx < p.taps; ++dx) {
          const uint64_t dp = desc_kmajor_sw128(a + (wg * p.box_w + dx) * 128);
          const uint64_t dw = desc_kmajor_sw128(a + a_bytes + dx * 8192);
#pragma unroll
          for (int k = 0; k < kGemmK / 16; ++k)
            wgmma_bf16_n128_ss(acc, dw + 2 * k, dp + 2 * k, c > 0 || dx > 0 || k > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one is done: its slot is free
      if (c > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = slot;
      if (++slot == p.slots) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    pin(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // the previous tile's stores have read the staging area
    if (tid == 0) bulk_wait<0, 1>();
    named_sync(1 + wg, 128);
    if constexpr (BN == 256) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = nt * BN + 8 * j + 2 * tq;
        const float b0 = col < C ? __ldg(bias + col) : 0.f;
        const float b1 = col + 1 < C ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * wq + g + 8 * h;  // the pixel, row q of the 64; q % 8 = g
          *reinterpret_cast<__nv_bfloat162*>(st + (j >> 3) * 8192 + q * 128 +
                                             (((j & 7) ^ g) << 4) + 4 * tq) =
              __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + b0, 0.f),
                                    fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f));
        }
      }
    } else {
      // acc[4 j + 2 h + e]: channel 16 wq + g + 8 h, pixel 8 j + 2 tq + e of
      // the warpgroup's 128, stored in its pixel's 128-byte row
      const int ch = 16 * wq + g;
      const float b0 = ch < C ? __ldg(bias + ch) : 0.f;
      const float b1 = ch + 8 < C ? __ldg(bias + ch + 8) : 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * tq + e;
          unsigned char* row = st + (q >> 6) * 8192 + (q & 63) * 128 + (ch & 7) * 2;
          *reinterpret_cast<__nv_bfloat16*>(row + (((ch >> 3) ^ (q & 7)) << 4)) =
              __float2bfloat16_rn(fmaxf(acc[4 * j + e] + b0, 0.f));
          *reinterpret_cast<__nv_bfloat16*>(row + ((((ch >> 3) + 1) ^ (q & 7)) << 4)) =
              __float2bfloat16_rn(fmaxf(acc[4 * j + 2 + e] + b1, 0.f));
        }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (tid == 0) {
      // store tile i holds pixels 64 i .. 64 i + 63 of the box, row-major: a
      // store box (64, sw, 64 / sw) at (sx, sy) of the box
      const int sw = p.bw < 64 ? p.bw : 64;
      for (int mi = 0; mi < MT; ++mi) {
        const int i = wg * MT + mi;
        const int sx = p.bw >= 64 ? (64 * i) % p.bw : 0;
        const int sy = p.bw >= 64 ? (64 * i) / p.bw : i * (64 / sw);
        for (int s = 0; s < NS; ++s)
          if (nt * BN + 64 * s < C)
            tma_store_4d(&out_map, st + (mi * NS + s) * 8192, nt * BN + 64 * s, x0 + sx, y0 + sy,
                         img);
      }
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0, 0>();
}

// One 3 x 3 stage of few input channels (cin % 8 != 0: the first stage of a
// one- or three-channel image, which TMA cannot stride and whose 9 x cin K
// values would fill a 64-channel chunk to a ninth or less), bf16, on the
// CUDA cores: a thread takes kFirstPix neighbouring output pixels of a row x
// 8 output channels, sums the 3 x 3 x cin products in f32 (fmaf, in the
// order (dy, channel, dx)), adds the f32 bias, applies ReLU, rounds once to
// bf16 and stores each pixel's 8 channels as 16 bytes. The weights (the
// plain (3, 3, cin, C) array) are held in shared memory as f32; the
// kFirstPix + 2 input pixels of a row and channel are read once through the
// read-only cache for the three taps dx (a warp's lanes of one pixel group
// read the same address). Bound by its output's bytes (first_plan).
__global__ void __launch_bounds__(kFirstThreads)
conv_stage_kernel_first(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B,
                        int H, int W, int cin, int C) {
  constexpr int K = 3, U = kFirstPix + K - 1;
  extern __shared__ __align__(16) float first_w[];
  const int oh = H - K + 1, ow = W - K + 1;
  const FirstPlan p = first_plan(B, oh, ow, K, cin, C);
  for (int i = threadIdx.x; i < K * K * cin * C; i += blockDim.x)
    first_w[i] = __bfloat162float(w[i]);
  __syncthreads();
  const int cg = threadIdx.x % p.groups, pg = threadIdx.x / p.groups;
  if (pg >= p.per_block) return;
  const int xg = gemm_cdiv(ow, kFirstPix);
  float b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = __ldg(bias + 8 * cg + e);
  for (long long it = (long long)blockIdx.x * p.per_block + pg; it < p.items;
       it += (long long)gridDim.x * p.per_block) {
    const int x0 = (int)(it % xg) * kFirstPix;
    const long long r = it / xg;
    const int y = (int)(r % oh), img = (int)(r / oh);
    float acc[kFirstPix][8];
#pragma unroll
    for (int q = 0; q < kFirstPix; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
    int col[U];  // input pixels past the row read its last one (their outputs are not stored)
#pragma unroll
    for (int u = 0; u < U; ++u) col[u] = min(x0 + u, W - 1) * cin;
    for (int dy = 0; dy < K; ++dy) {
      const __nv_bfloat16* row = x + ((size_t)img * H + y + dy) * W * cin;
      for (int ci = 0; ci < cin; ++ci) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = __bfloat162float(row[col[u] + ci]);
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float* wr = first_w + ((dy * K + dx) * cin + ci) * C + 8 * cg;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int q = 0; q < kFirstPix; ++q)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(v[q + dx], wv[e], acc[q][e]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kFirstPix; ++q) {
      if (x0 + q >= ow) break;
      uint4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(fmaxf(acc[q][2 * e] + b[2 * e], 0.f),
                                     fmaxf(acc[q][2 * e + 1] + b[2 * e + 1], 0.f));
      *reinterpret_cast<uint4*>(out + (((size_t)img * oh + y) * ow + x0 + q) * C + 8 * cg) = o;
    }
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

// One stage of the bf16 staged route on the persistent kernel: a block on
// each SM (or one a tile).
template <int BN>
int launch_persistent(const void* x, const void* w, const float* b, void* out, int B, int H, int W,
                      int K, int cin, int C, cudaStream_t stream) {
  const int oh = H - K + 1, ow = W - K + 1;
  const GemmPlan p = gemm_plan(B, oh, ow, K, cin, C);
  CUtensorMap in_map, out_map;
  int rc = tmap::encode_nhwc(&in_map, x, B, H, W, cin, kGemmK, p.box_w, p.bh, 2, true);
  if (rc) return rc;
  const int sw = p.bw < 64 ? p.bw : 64;
  rc = tmap::encode_nhwc(&out_map, out, B, oh, ow, C, 64, sw, 64 / sw, 2, true);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(conv_stage_kernel_persistent<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(p.tiles < sms ? p.tiles : sms);
  conv_stage_kernel_persistent<BN><<<grid, kGemmThreads, p.smem, stream>>>(
      in_map, out_map, (const unsigned char*)w, b, B, oh, ow, K, cin, C);
  return (int)cudaGetLastError();
}

// One 3 x 3 stage on the CUDA cores: enough blocks for every SM several
// times over.
int launch_first(const void* x, const void* w, const float* b, void* out, int B, int H, int W,
                 int K, int cin, int C, cudaStream_t stream) {
  const FirstPlan p = first_plan(B, H - K + 1, W - K + 1, K, cin, C);
  if (K != 3 || p.per_block < 1 || p.smem > kGemmSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_stage_kernel_first,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.items + p.per_block - 1) / p.per_block;
  const int grid = (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
  conv_stage_kernel_first<<<grid, kFirstThreads, p.smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, b, (__nv_bfloat16*)out, B, H, W, cin, C);
  return (int)cudaGetLastError();
}

// One stage of the bf16 staged route: the CUDA cores where TMA cannot
// stride the input (cin % 8 != 0), else the persistent kernel at the plan's
// tile width.
int launch_stage_bf16(const void* x, const void* w, const float* b, void* out, int B, int H,
                      int W, int K, int cin, int C, cudaStream_t stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (cin % 8 != 0) return launch_first(x, w, b, out, B, H, W, K, cin, C, stream);
  if (gemm_bn(C) == 64) return launch_persistent<64>(x, w, b, out, B, H, W, K, cin, C, stream);
  return launch_persistent<256>(x, w, b, out, B, H, W, K, cin, C, stream);
}

// The staged route: the pass's four stages, one launch each, x -> s0 -> s1
// -> s0 -> out; s0 and s1 hold (B, H-2, W-2, C) in the compute type. bf16
// takes launch_stage_bf16 (th, tw unused), float32 conv_stage_kernel.
template <typename T>
int launch_stage_any(const T* x, const void* w, const float* b, T* out, int B, int H, int W,
                     int K, int cin, int C, int th, int tw, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    return launch_stage_bf16(x, w, b, out, B, H, W, K, cin, C, stream);
  else
    return launch_stage<T>(x, w, b, out, B, H, W, K, cin, C, th, tw, stream);
}

template <typename T>
int launch_staged(const void* x, const void* const* w, const float* const* b, void* out, void* s0,
                  void* s1, int B, int H, int W, int cin, int C, int th, int tw,
                  cudaStream_t stream) {
  T* t0 = (T*)s0;
  T* t1 = (T*)s1;
  int rc = launch_stage_any<T>((const T*)x, w[0], b[0], t0, B, H, W, 3, cin, C, th, tw, stream);
  if (rc == 0)
    rc = launch_stage_any<T>(t0, w[1], b[1], t1, B, H - 2, W - 2, 1, C, C, th, tw, stream);
  if (rc == 0)
    rc = launch_stage_any<T>(t1, w[2], b[2], t0, B, H - 2, W - 2, 1, C, C, th, tw, stream);
  if (rc == 0)
    rc = launch_stage_any<T>(t0, w[3], b[3], (T*)out, B, H - 2, W - 2, 3, C, C, th, tw, stream);
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
// K x K stage (K = 1 or 3) with cin input channels and a th x tw output tile
// (float32); in bf16 the persistent kernel's 256-column variant, the same at
// every shape.
long long conv_pass_2d_staged_smem_bytes(int K, int cin, int th, int tw, int elem_bytes) {
  return elem_bytes == 2 ? gemm_plan(1, 1, 1, K, cin, 256).smem
                         : staged_layout<float>(K, cin, th, tw).total;
}

// The bf16 staged route's plan of a K x K stage with output grid oh x ow:
// out[0..15] = bm, bn, bh, bw, tiles_y, tiles_x, m_tiles, n_tiles, tiles,
// n_cb, chunks, taps, box_w, a_bytes, slots, shared bytes. Returns 0.
int conv_pass_2d_staged_plan(int B, int oh, int ow, int K, int cin, int C, long long* out) {
  const GemmPlan p = gemm_plan(B, oh, ow, K, cin, C);
  const long long v[16] = {p.bm,      p.bn,    p.bh,     p.bw,     p.tiles_y, p.tiles_x,
                           p.m_tiles, p.n_tiles, p.tiles, p.n_cb,  p.chunks,  p.taps,
                           p.box_w,   p.a_bytes, p.slots, p.smem};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
  return 0;
}

// The cost model's picoseconds of a pass on (B, H, W, cin) -> C: out[0] the
// bf16 staged route's (-1 where it cannot take the pass), out[1] the fused
// route's at a th x tw tile (-1 where no block fits). Returns 0.
int conv_pass_2d_route_cost(int B, int H, int W, int cin, int C, int th, int tw, long long* out) {
  out[0] = staged_takes(cin, C) ? staged_pass_ps(B, H, W, cin, C) : -1;
  out[1] = fused_layout<__nv_bfloat16>(cin, C, th, tw).total <= kMaxSmem
               ? fused_pass_ps(B, pass_cost<__nv_bfloat16>(cin, C, th, tw, H, W))
               : -1;
  return 0;
}

// One stage of the bf16 staged route alone: x (B, H, W, cin) -> out (B,
// H-K+1, W-K+1, C), w packed by the wrapper (pack_stage_persistent; where
// cin % 8 != 0 the plain (K, K, cin, C) bf16 array), b f32. Returns the
// error code (0 = ok).
int conv_pass_2d_stage_launch(const void* x, const void* w, const void* b, void* out, int B,
                              int H, int W, int K, int cin, int C, void* stream) {
  return launch_stage_bf16(x, w, (const float*)b, out, B, H, W, K, cin, C, (cudaStream_t)stream);
}

// The staged route (one launch per stage); w1..w4 packed by the wrapper for
// this route; s0, s1: scratch of B x (H-2) x (W-2) x C elements each. cin and
// C must be multiples of 8 (f32; bf16 where staged_takes). Returns the first error code
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
