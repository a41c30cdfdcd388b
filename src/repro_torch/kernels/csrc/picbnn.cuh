// Device code shared by the four PiC-BNN kernels (binary_gemm.cu,
// cam_search.cu, fused_mlp.cu, fused_conv.cu).  Each .cu file is built on
// its own into a shared library with a plain C interface (see
// kernels/_build.py).
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

// Pairwise Hamming-distance tile used by kernel 2 (cam_search.cu).
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

// ---------------------------------------------------------------------
// The FC/head tail of kernel 3 (fused_mlp.cu).  Kernel 4 fills the same
// MlpTail (`fill_tail`) and runs its own tail on the tensor cores.
// ---------------------------------------------------------------------
constexpr int kMaxLayers = 8;  // hidden FC layers the tail carries
constexpr int kQ = 8;          // queries a warp carries per output word

struct Layer {
  const uint32_t* w;  // [n_out, kw_in] packed weight rows
  const int32_t* c;   // [n_out] folded BN constants
  int n_bits;         // logical input bits (the dot width)
  int n_out;          // neurons = bits produced
  int kw_in;          // words per input row
  int kw_out;         // words per output row (next operand's width)
  int tail_bias;      // ones appended after the neurons (last layer only)
};

struct MlpTail {
  Layer layers[kMaxLayers];
  const uint32_t* head;  // [n_classes, kw_head] class rows, bias cells incl.
  int n_layers, n_classes, kw_head;
};

// Hidden layers and head vote for the block's `bq` queries (a multiple of
// kQ) that start at batch row b0.  On entry `cur` holds the queries'
// packed words densely (query r at r * kw, kw the first operand's width);
// `nxt` is the other half of the shared-memory ping-pong pair, each half
// at least bq times the widest stage.  Per hidden layer a warp produces
// one output word for kQ queries at a time: lane l owns neuron
// j = 32*word + l, reads its weight row once (read-only cache) for all kQ
// queries, whose words broadcast from shared memory, and keeps kQ
// distances in registers.  The sign bits become words with
// __ballot_sync, bit l from lane l: exactly the little-endian repack of
// the reference.  The head votes with `vote_count`.  Rows >= b are
// computed but not written.
template <int MODE>
__device__ __forceinline__ void mlp_tail(const MlpTail& net, uint32_t* cur,
                                         uint32_t* nxt, const uint32_t* thr_s,
                                         const float* __restrict__ samples,
                                         int32_t* __restrict__ out, int b,
                                         int b0, int p, int bq) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int groups = bq / kQ;

  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layers[l];
    for (int it = warp; it < L.kw_out * groups; it += n_warps) {
      const int ow = it / groups, g = it % groups;
      const int j = ow * 32 + lane;
      int acc[kQ];
#pragma unroll
      for (int r = 0; r < kQ; ++r) acc[r] = 0;
      if (j < L.n_out) {
        const uint32_t* wr = L.w + (size_t)j * L.kw_in;
        const uint32_t* xq = cur + g * kQ * L.kw_in;
        for (int k = 0; k < L.kw_in; ++k) {
          const uint32_t wv = __ldg(wr + k);
#pragma unroll
          for (int r = 0; r < kQ; ++r) acc[r] += __popc(xq[r * L.kw_in + k] ^ wv);
        }
      }
      const int cj = j < L.n_out ? __ldg(L.c + j) : 0;
#pragma unroll
      for (int r = 0; r < kQ; ++r) {
        const bool bit = j < L.n_out ? (L.n_bits - 2 * acc[r] + cj >= 0)
                                     : (j < L.n_out + L.tail_bias);
        const uint32_t word = __ballot_sync(0xffffffffu, bit);
        if (lane == r) nxt[(g * kQ + r) * L.kw_out + ow] = word;
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  const int cwords = (net.n_classes + 31) / 32;
  for (int it = warp; it < cwords * groups; it += n_warps) {
    const int cw = it / groups, g = it % groups;
    const int cls = cw * 32 + lane;
    if (cls >= net.n_classes) continue;
    int acc[kQ];
#pragma unroll
    for (int r = 0; r < kQ; ++r) acc[r] = 0;
    const uint32_t* hr = net.head + (size_t)cls * net.kw_head;
    const uint32_t* xq = cur + g * kQ * net.kw_head;
    for (int k = 0; k < net.kw_head; ++k) {
      const uint32_t hv = __ldg(hr + k);
#pragma unroll
      for (int r = 0; r < kQ; ++r) acc[r] += __popc(xq[r * net.kw_head + k] ^ hv);
    }
#pragma unroll
    for (int r = 0; r < kQ; ++r) {
      const int row = b0 + g * kQ + r;
      if (row < b) {
        const float* s = MODE == kThrSampled
                             ? samples + ((size_t)row * net.n_classes + cls) * p
                             : nullptr;
        out[(size_t)row * net.n_classes + cls] = vote_count<MODE>(acc[r], thr_s, s, p);
      }
    }
  }
}

// Fill an MlpTail from the launcher's host arrays; returns the widest
// operand in words (at least `kw0`, the input width).
inline int fill_tail(MlpTail& t, int n_layers, const void* ws_v,
                     const void* cs_v, const void* n_bits_v,
                     const void* n_out_v, const void* kw_v, const void* head,
                     int n_classes, int kw_head, int bias_cells, int kw0) {
  const void* const* ws = static_cast<const void* const*>(ws_v);
  const void* const* cs = static_cast<const void* const*>(cs_v);
  const int* n_bits = static_cast<const int*>(n_bits_v);
  const int* n_out = static_cast<const int*>(n_out_v);
  const int* kw = static_cast<const int*>(kw_v);
  t.n_layers = n_layers;
  t.head = static_cast<const uint32_t*>(head);
  t.n_classes = n_classes;
  t.kw_head = kw_head;
  int max_kw = kw0 > kw_head ? kw0 : kw_head;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = t.layers[l];
    L.w = static_cast<const uint32_t*>(ws[l]);
    L.c = static_cast<const int32_t*>(cs[l]);
    L.n_bits = n_bits[l];
    L.n_out = n_out[l];
    L.kw_in = kw[l];
    L.kw_out = l + 1 < n_layers ? kw[l + 1] : kw_head;
    L.tail_bias = l + 1 < n_layers ? 0 : bias_cells;
    if (kw[l] > max_kw) max_kw = kw[l];
  }
  return max_kw;
}

}  // namespace picbnn

extern "C" const char* picbnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
