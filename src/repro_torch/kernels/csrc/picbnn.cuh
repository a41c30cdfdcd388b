// Device code shared by the three PiC-BNN kernels (binary_gemm.cu,
// cam_search.cu, fused_mlp.cu).  Each .cu file is built on its own into
// a shared library with a plain C interface (see kernels/_build.py).
//
// Packed words arrive as int32 tensors holding the bit pattern of
// little-endian uint32 words; the kernels read them as uint32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace picbnn {

// Most thresholds a vote compares against (the paper's sweep has 33).
constexpr int kMaxPasses = 256;

// How the vote reads its thresholds (the three forms of the reference):
//   kThrInt     [P] int32 schedule, compare hd <= T as integers
//   kThrFloat   [P] float32 schedule, compare float(hd) <= T
//   kThrSampled [B, C, P] float32 per-(query, row, pass) samples
enum ThrMode : int { kThrInt = 0, kThrFloat = 1, kThrSampled = 2 };

// Algorithm-1 vote for one (query, row) Hamming distance:
// #{t : hd <= T_t}.  `thr_s` is the shared schedule staged in shared
// memory as raw 32-bit words; `samples` points at this pair's P sampled
// thresholds (kThrSampled only).  Shared by cam_vote (kernel 2) and the
// head stage of fused_mlp_votes (kernel 3).
template <int MODE>
__device__ __forceinline__ int vote_count(int hd, const uint32_t* thr_s,
                                          const float* samples, int p) {
  int v = 0;
  if (MODE == kThrInt) {
    const int* t = reinterpret_cast<const int*>(thr_s);
    for (int i = 0; i < p; ++i) v += (hd <= t[i]);
  } else if (MODE == kThrFloat) {
    const float* t = reinterpret_cast<const float*>(thr_s);
    const float h = static_cast<float>(hd);
    for (int i = 0; i < p; ++i) v += (h <= t[i]);
  } else {
    const float h = static_cast<float>(hd);
    for (int i = 0; i < p; ++i) v += (h <= samples[i]);
  }
  return v;
}

// Stage the shared [P] schedule into shared memory (all threads of the
// block take part; the caller synchronises before use).
__device__ __forceinline__ void load_thresholds(uint32_t* thr_s,
                                                const uint32_t* thr, int p) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int i = tid; i < p; i += nt) thr_s[i] = thr[i];
}

// Pairwise Hamming-distance tile used by kernels 1 and 2.
// A block of 32 x 8 threads owns a 32 x 32 output tile; thread (tx, ty)
// computes rows m0 + ty + 8*i (i < 4) against column n0 + tx.  K is
// walked in steps of kKt words staged in shared memory; ragged M, N and
// K edges are filled with zero words, which add nothing to a distance.
constexpr int kTile = 32;
constexpr int kKt = 32;
constexpr int kTileThreads = 256;

__device__ __forceinline__ void tile_hd(const uint32_t* __restrict__ x,
                                        const uint32_t* __restrict__ w,
                                        int m, int n, int kw, int m0, int n0,
                                        uint32_t (*xs)[kKt + 1],
                                        uint32_t (*ws)[kKt + 1],
                                        int acc[4]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0;
  for (int k0 = 0; k0 < kw; k0 += kKt) {
    for (int e = tid; e < kTile * kKt; e += kTileThreads) {
      const int r = e / kKt, k = e % kKt, gk = k0 + k;
      const int xm = m0 + r, wn = n0 + r;
      xs[r][k] = (xm < m && gk < kw) ? x[(size_t)xm * kw + gk] : 0u;
      ws[r][k] = (wn < n && gk < kw) ? w[(size_t)wn * kw + gk] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKt; ++k) {
      const uint32_t wv = ws[tx][k];  // stride 33: no bank conflicts
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += __popc(xs[ty + 8 * i][k] ^ wv);
    }
    __syncthreads();
  }
}

}  // namespace picbnn

extern "C" const char* picbnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
