// Host side of the tensor memory accelerator's 2-D copies (kernel 1's
// large tile, kernel 2's row ring): the tensor map of a [rows, kw] matrix
// of packed uint32 words, read in boxes of `box_words` x `box_rows`,
// 128-byte swizzled in shared memory (a box row's 16-byte units permuted
// by the row's index mod 8, so the tensor cores' fragment and `wgmma`
// reads hit distinct banks), zero outside the matrix.  The encoder is
// the driver's, found through the runtime, so no library links against
// libcuda.  Needs Kw % 4 == 0 and the matrix's first word on 16 bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace picbnn {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// box_words * 4 <= 128 bytes (the swizzle's span), box_rows <= 256
inline bool rows_map(CUtensorMap* map, const void* base, int rows, int kw,
                     int box_words, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)kw, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kw * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_words, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace picbnn
