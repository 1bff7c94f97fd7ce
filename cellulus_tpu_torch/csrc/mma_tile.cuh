// Warp-level tensor-core helpers shared by conv_dw.cu (K2) and
// conv_pass.cu (K1), for sm_90a.
//
// - cp.async 16-byte copies into shared memory, with zero fill;
// - ldmatrix fragment loads (x4, plain and transposed) for bf16 operands;
// - mma.sync m16n8k16 with bf16 inputs and f32 accumulation;
// - 3xTF32 for f32 operands: each value a splits into hi = tf32(a) (round
//   to nearest, ties away: (bits + 0x1000) & 0xFFFFE000 on the bit pattern)
//   and lo = a - hi, exact in f32, which the tensor core reads as tf32 by
//   dropping its low 13 bits; a product a*b is accumulated as
//   lo_a*hi_b + hi_a*lo_b + hi_a*hi_b with mma.sync m16n8k8 .tf32, in f32
//   (the callers issue each of the three products over several tiles in
//   turn, so that no mma waits on the one before). The dropped lo_a*lo_b
//   term and the truncation of lo leave about 2^-21 of each product, which
//   is float32-level agreement; the TF32 switches of PyTorch do not reach it.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8"),
// g = lane / 4, t = lane % 4:
//   bf16 A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//        a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..)
//   bf16 B (16x8):             b[0] = (2t..2t+1, g), b[1] = (2t+8.., g)
//   tf32 A (16x8):  a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4), a[3] = (g+8, t+4)
//   tf32 B (8x8):   b[0] = (t, g), b[1] = (t+4, g)
//   C (16x8, f32):  c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 fills the 16 bytes with
// zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// c += a * b, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b, tf32 inputs (f32 bit patterns), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Round to the nearest tf32 (10 mantissa bits), ties away from zero, on the
// bit pattern: what cvt.rna.tf32.f32 gives for finite values, in two integer
// ops at full rate (the conversion unit runs at a quarter of it, and the
// splits would hold the mma's back).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to about 2^-21: hi rounded to tf32, lo = v - hi exactly,
// which the tensor core reads as tf32 by dropping its low 13 bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A fragment of n values (4 for tf32 A, 2 for tf32 B), split in place.
template <int N>
__device__ __forceinline__ void split_frag(const float v[N], uint32_t hi[N], uint32_t lo[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(v[i], hi[i], lo[i]);
}


}  // namespace mma_tile
