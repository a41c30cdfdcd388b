// Definitions shared by the four PiC-BNN kernels (binary_gemm.cu,
// cam_search.cu, fused_mlp.cu, fused_conv.cu): the threshold forms and the
// vote (kernels 2, 3 and 4), and the FC/head description (`MlpTail`)
// that the FC/head stage of fc_stage.cuh reads (kernels 3 and 4).  The
// tensor-core product is in bmma.cuh (kernels 1-4).  Each .cu file is
// built on its own into a shared library with a plain C interface (see
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
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on an H100

// How the vote reads its thresholds (the three forms of the reference):
//   kThrInt     [P] int32 schedule, compare hd <= T as integers
//   kThrFloat   [P] float32 schedule, compare float(hd) <= T
//   kThrSampled [B, C, P] float32 per-(query, row, pass) samples
enum ThrMode : int { kThrInt = 0, kThrFloat = 1, kThrSampled = 2 };

// Algorithm-1 vote for one (query, row) Hamming distance:
// #{t : hd <= T_t}.  `thr_s` is the shared schedule staged in shared
// memory as raw 32-bit words; `samples` points at this pair's P sampled
// thresholds (kThrSampled only).  The head stage of kernels 3 and 4
// (fc_stage.cuh `head_votes`) and kernel 2 call it, and kernels 2 and 3
// tabulate it over every distance of their head for the shared
// schedules.
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

// The FC layers and head of a net as the FC/head stage reads them
// (fc_stage.cuh, shared by kernels 3 and 4); `fill_tail` fills it from
// the launcher's host arrays.
constexpr int kMaxLayers = 8;  // hidden FC layers the stage carries

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

struct Layer {
  const uint32_t* w;  // [n_out, kw_in] packed weight rows
  const int32_t* c;   // [n_out] folded BN constants
  int n_bits;         // logical input bits (the dot width)
  int n_out;          // neurons = bits produced
  int kw_in;          // words per input row
  int kw_out;         // words per output row (next operand's width)
  int tail_bias;      // ones appended after the neurons (last layer only)
  int ldw;            // row stride of the rows in shared memory (words)
  int soff;           // their offset in the block's row region (words)
};

struct MlpTail {
  Layer layers[kMaxLayers];
  const uint32_t* head;  // [n_classes, kw_head] class rows, bias cells incl.
  int n_layers, n_classes, kw_head;
  int head_ldw, head_soff;  // the head rows in shared memory, as in Layer
  int rows_words;           // words of every layer's rows and the head's
};

// Fill an MlpTail from the launcher's host arrays.  Rows in shared
// memory (kernel 3 where they fit) sit one layer after the other,
// zero-padded to whole n8 tiles and 8-word K steps, at a row stride of
// 4 mod 8 words.
inline void fill_tail(MlpTail& t, int n_layers, const void* ws_v,
                      const void* cs_v, const void* n_bits_v,
                      const void* n_out_v, const void* kw_v, const void* head,
                      int n_classes, int kw_head, int bias_cells) {
  const void* const* ws = static_cast<const void* const*>(ws_v);
  const void* const* cs = static_cast<const void* const*>(cs_v);
  const int* n_bits = static_cast<const int*>(n_bits_v);
  const int* n_out = static_cast<const int*>(n_out_v);
  const int* kw = static_cast<const int*>(kw_v);
  t.n_layers = n_layers;
  t.head = static_cast<const uint32_t*>(head);
  t.n_classes = n_classes;
  t.kw_head = kw_head;
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = t.layers[l];
    L.w = static_cast<const uint32_t*>(ws[l]);
    L.c = static_cast<const int32_t*>(cs[l]);
    L.n_bits = n_bits[l];
    L.n_out = n_out[l];
    L.kw_in = kw[l];
    L.kw_out = l + 1 < n_layers ? kw[l + 1] : kw_head;
    L.tail_bias = l + 1 < n_layers ? 0 : bias_cells;
    L.ldw = round8(L.kw_in) + 4;
    L.soff = off;
    off += round8(L.n_out) * L.ldw;
  }
  t.head_ldw = round8(kw_head) + 4;
  t.head_soff = off;
  t.rows_words = off + round8(n_classes) * t.head_ldw;
}

}  // namespace picbnn

extern "C" const char* picbnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
