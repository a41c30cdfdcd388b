// Kernel 1: pairwise Hamming distances between packed rows.
//
// Replaces the Pallas kernel `binary_gemm_hd` (`_binary_gemm_kernel`) in
// src/repro/kernels/binary_gemm.py:
//     out[m, n] = sum_k popcount(x[m, k] ^ w[n, k])     x [M, Kw], w [N, Kw]
//
// What bounds it on an H100: integer issue.  Each word pair costs one
// XOR, one popcount and one add, and __popc issues at 16 per clock per SM
// (a quarter of the 64/clock of XOR and add), so the popcount rate bounds
// the kernel long before memory does: at the main path's shapes every
// operand word is reused N or M times from shared memory.
//
// Design: one thread per output, 32 x 32 output tiles per block, K staged
// in 32-word steps in padded shared memory (row stride 33, so the column
// reads of the weight tile hit 32 different banks and the query reads
// broadcast).  Ragged edges are masked with zero words.  Simple first:
// no double buffering, no tensor cores.
#include "picbnn.cuh"

using namespace picbnn;

__global__ void __launch_bounds__(kTileThreads)
binary_gemm_hd_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ w, int32_t* __restrict__ out,
                      int m, int n, int kw) {
  __shared__ uint32_t xs[kTile][kKt + 1];
  __shared__ uint32_t ws[kTile][kKt + 1];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int acc[4];
  tile_hd(x, w, m, n, kw, m0, n0, xs, ws, acc);
  const int col = n0 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + threadIdx.y + 8 * i;
    if (row < m && col < n) out[(size_t)row * n + col] = acc[i];
  }
}

extern "C" int binary_gemm_hd_launch(const void* x, const void* w, void* out,
                                     int m, int n, int kw, void* stream) {
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  dim3 block(kTile, kTileThreads / kTile);
  binary_gemm_hd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int32_t*>(out), m, n, kw);
  return static_cast<int>(cudaGetLastError());
}
