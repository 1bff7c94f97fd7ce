// Host side of the TMA copies of K1 (conv_pass.cu) and K2 (conv_dw.cu): the
// tensor map of an NHWC activation, encoded with cuTensorMapEncodeTiled
// through the runtime's driver entry point, so that no library links
// libcuda. A box is (bc channels, bw pixels, bh rows, 1 image), laid out
// densely in shared memory in that order; where it leaves the tensor it is
// filled with zeros. With swizzle128 (bc * esz = 128), each pixel's
// 128-byte row has its 16-byte units XORed with the row's index mod 8 (a
// 1024-byte aligned destination). Needs C * esz a multiple of 16 bytes and
// a 16-byte aligned base.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_runtime.h>

namespace tmap {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// error codes of the map's encoding, beside CUDA's
constexpr int kNoEncoder = 9001, kEncodeFailed = 9002;

// x (B, H, W, C) of esz-byte elements (2: bfloat16, 4: float32)
inline int encode_nhwc(CUtensorMap* m, const void* x, int B, int H, int W, int C, int bc, int bw,
                       int bh, int esz, bool swizzle128 = false) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess || fn == nullptr)
      return kNoEncoder;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * esz, (cuuint64_t)W * C * esz,
                                 (cuuint64_t)H * W * C * esz};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      m, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

}  // namespace tmap
