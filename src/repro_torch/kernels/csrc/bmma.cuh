// Tensor-core building blocks of the four kernels: the 1-bit `mma.sync`
// product, and the `cp.async` copies of kernel 1 and of the block program
// of kernels 2 and 3 (mlp_block.cuh).
//
// Why 1-bit and not int8 operands: on the H100 a warp's
// `mma.sync.m16n8k256.b1.and.popc` issues at the same rate as an int8
// `mma.sync.m16n8k32` (scripts/torch_mma_probe.py: 19,044 bit-MACs and
// 2,346 int8 MACs per clock per SM), so it does 8x the bits per
// instruction, and its fragments are the packed words themselves: a
// thread's A registers are words t and t+4 of a row's 8-word K step, its
// B registers the same words of a column.  No ±1 bytes are ever built.
// Hopper has `.and.popc` only (no `.xor.popc`), so a Hamming distance is
// two products:  HD(x, w) = popc(x & ~w) + popc(~x & w).  Pad bits are
// zero in both operands, so they add nothing to either product.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace picbnn {

// d += popc(a & b) over one 16 x 256 (A, row) by 256 x 8 (B, col) step.
// Fragments (PTX ISA, mma.m16n8k256 .b1), lane = 4*g + t:
//   a[0] row g word t, a[1] row g+8 word t, a[2] row g word t+4,
//   a[3] row g+8 word t+4;  b[0] column g word t, b[1] column g word t+4;
//   d[0], d[1] row g columns 2t, 2t+1;  d[2], d[3] row g+8, same columns.
__device__ __forceinline__ void bmma_and(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += HD over one K step: popc(a & ~b) + popc(~a & b); `na` is ~a.
__device__ __forceinline__ void bmma_hd(int (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&na)[4], uint32_t b0,
                                        uint32_t b1) {
  bmma_and(d, a, ~b0, ~b1);
  bmma_and(d, na, b0, b1);
}

__device__ __forceinline__ void complement(uint32_t (&na)[4],
                                           const uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) na[i] = ~a[i];
}

// Asynchronous global -> shared copies; `src_bytes` < size zero-fills
// the rest (0: the whole granule is zero and `src` is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace picbnn
