// The block program of kernel 3 (fused_mlp.cu) on the FC/head stage of
// fc_stage.cuh.
//
// A block of 32 warps stages the shared [P] schedule, a table of the vote
// at every head distance, so that a vote is one load instead of P
// compares (`vote_count` tabulated: the same compares, so the same
// votes), and every layer's rows and the head rows where they take
// kRowsSmemMin bytes or more and fit beside the rest (else the stage
// reads them from global memory).  It then walks its query tiles (bq
// queries, bq / 16 m16 tiles; tile i of block j is j + i * gridDim),
// fetching the next tile's input words with cp.async while the current
// one runs `fc_stage`.  The grid is at most one wave.
#pragma once

#include <algorithm>

#include "fc_stage.cuh"

namespace picbnn {

// Copy rows [0, n) of `src` ([*, kw] words) into `dst` (row stride `ld`)
// as rows [0, rows) of words [0, words), asynchronously (cp.async); what
// lies past n or kw is written as zero.  Whole 16-byte granules where kw,
// `words` and the base allow, else word by word.
__device__ __forceinline__ void copy_rows_async(uint32_t* dst, int ld,
                                                const uint32_t* src, int n,
                                                int kw, int rows, int words) {
  if ((kw & 3) == 0 && (words & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int gw = words >> 2;
    for (int e = threadIdx.x; e < rows * gw; e += blockDim.x) {
      const int r = e / gw, k = 4 * (e - r * gw);
      const bool ok = r < n && k < kw;
      cp_async16(dst + r * ld + k, ok ? src + (size_t)r * kw + k : src,
                 ok ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * words; e += blockDim.x) {
    const int r = e / words, k = e - r * words;
    const bool ok = r < n && k < kw;
    cp_async4(dst + r * ld + k, ok ? src + (size_t)r * kw + k : src,
              ok ? 4 : 0);
  }
}

// 32 warps, an item one n8 tile: at the paper's widths (128 neurons,
// bq = 32) one item a warp (scripts/torch_mlp_tiles.py times 8 and 16
// warps with four and two n8 tiles an item)
constexpr int kMlpThreads = 1024;
constexpr int kMlpNT = 1;
constexpr int kMlpMinBlocks = kMlpThreads > 256 ? 1 : 2;  // an SM
constexpr int kVoteTab = 2048;    // most entries of the vote table
// Rows below this many bytes are read from global memory (through L1):
// staging them costs a block more than their K loop loses reading them
// from L1 (scripts/torch_mlp_tiles.py: faster at the MNIST MLP's 19 KB
// and a head's 1 KB, slower at the HG MLP's 67 KB).
constexpr size_t kRowsSmemMin = 32 * 1024;

struct MlpNet {
  MlpTail tail;
  int kw0;      // words per input row
  int ld_in;    // query stride of the two input tiles (round8(kw0) + 4)
  int ld_act;   // query stride of the two activation buffers
  int bq;       // queries a tile
  int n_tiles;  // query tiles of the batch
  int vtab_n;   // entries of the vote table (0: none)
};

template <int MODE, bool ROWS_GLOBAL>
__global__ void __launch_bounds__(kMlpThreads, kMlpMinBlocks)
mlp_votes_kernel(const uint32_t* __restrict__ x,
                 const __grid_constant__ MlpNet net,
                 const uint32_t* __restrict__ thr,
                 const float* __restrict__ samples,
                 int32_t* __restrict__ out, int b, int p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const MlpTail& T = net.tail;
  uint32_t* thr_s = smem;
  int* vtab = reinterpret_cast<int*>(smem + kMaxPasses);
  uint32_t* rows_s = smem + kMaxPasses + ((net.vtab_n + 3) & ~3);
  uint32_t* in = rows_s + (ROWS_GLOBAL ? 0 : T.rows_words);
  const int tile_w = net.bq * net.ld_in;
  uint32_t* act = in + 2 * tile_w;
  const int mtiles = net.bq >> 4;

  // the copies go out first; the schedule loads meanwhile
  if (!ROWS_GLOBAL) {
    for (int l = 0; l < T.n_layers; ++l) {
      const Layer& L = T.layers[l];
      copy_rows_async(rows_s + L.soff, L.ldw, L.w, L.n_out, L.kw_in,
                      round8(L.n_out), round8(L.kw_in));
    }
    copy_rows_async(rows_s + T.head_soff, T.head_ldw, T.head, T.n_classes,
                    T.kw_head, round8(T.n_classes), round8(T.kw_head));
  }
  const int r0 = blockIdx.x * net.bq;
  copy_rows_async(in, net.ld_in, x + (size_t)r0 * net.kw0, b - r0, net.kw0,
                  net.bq, round8(net.kw0));
  cp_async_commit();
  if (MODE != kThrSampled) load_thresholds(thr_s, thr, p);
  __syncthreads();  // the schedule is in
  for (int h = threadIdx.x; h < net.vtab_n; h += blockDim.x)
    vtab[h] = vote_count<MODE>(h, thr_s, nullptr, p);

  int s = 0;
  for (int tile = blockIdx.x; tile < net.n_tiles; tile += gridDim.x) {
    const int nr0 = (tile + gridDim.x) * net.bq;
    if (tile + gridDim.x < net.n_tiles)
      copy_rows_async(in + (s ^ 1) * tile_w, net.ld_in,
                      x + (size_t)nr0 * net.kw0, b - nr0, net.kw0, net.bq,
                      round8(net.kw0));
    cp_async_commit();
    cp_async_wait<1>();  // all but the next tile's copies have landed
    __syncthreads();
    fc_stage<MODE, kMlpNT, ROWS_GLOBAL>(
        T, rows_s, in + s * tile_w, net.ld_in, act, net.ld_act,
        act + net.bq * net.ld_act, net.ld_act, mtiles, tile * net.bq, b,
        thr_s, vtab, net.vtab_n, samples, p, out);
    __syncthreads();  // before the next copies overwrite what was read
    s ^= 1;
  }
  cp_async_wait<0>();
}

// Words of shared memory the block program needs besides the rows (the
// schedule, the vote table, two input tiles and two activation
// buffers);
// kernels/fused_mlp.py `block_smem_bytes` is its host twin.
inline size_t mlp_base_words(const MlpNet& net) {
  return kMaxPasses + ((net.vtab_n + 3) & ~3) +
         2 * (size_t)net.bq * (net.ld_in + net.ld_act);
}

// Lay out and launch the block program for `net.tail` (filled by
// `fill_tail`) on x [b, kw0].  Rows of at least kRowsSmemMin bytes go to
// shared memory where they fit beside the rest; others are read from
// global memory.  The grid is at most one wave: blocks walk the tiles.
inline int mlp_launch(MlpNet net, const void* x, int b, int kw0, int bq,
                      const void* thr, int thr_mode, int p,
                      const void* samples, void* out, void* stream) {
  if (bq <= 0 || bq % 16 != 0 || p < 0 || p > kMaxPasses || b <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpTail& T = net.tail;
  net.kw0 = kw0;
  net.bq = bq;
  net.n_tiles = (b + bq - 1) / bq;
  net.ld_in = round8(kw0) + 4;
  net.ld_act = 0;  // operands after the first: later layers and the head
  for (int l = 1; l <= T.n_layers; ++l) {
    const int kw = l < T.n_layers ? T.layers[l].kw_in : T.kw_head;
    if (round8(kw) + 4 > net.ld_act) net.ld_act = round8(kw) + 4;
  }
  net.vtab_n =
      thr_mode == kThrSampled ? 0 : std::min(32 * T.kw_head + 1, kVoteTab);
  const size_t base = mlp_base_words(net) * sizeof(uint32_t);
  const size_t rows = T.rows_words * sizeof(uint32_t);
  const bool global = rows < kRowsSmemMin || base + rows > kSmemLimit;
  const size_t smem = global ? base : base + rows;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);

  void (*fn)(const uint32_t*, const MlpNet, const uint32_t*, const float*,
             int32_t*, int, int);
  switch (thr_mode * 2 + global) {
    case kThrInt * 2: fn = mlp_votes_kernel<kThrInt, false>; break;
    case kThrInt * 2 + 1: fn = mlp_votes_kernel<kThrInt, true>; break;
    case kThrFloat * 2: fn = mlp_votes_kernel<kThrFloat, false>; break;
    case kThrFloat * 2 + 1: fn = mlp_votes_kernel<kThrFloat, true>; break;
    case kThrSampled * 2: fn = mlp_votes_kernel<kThrSampled, false>; break;
    case kThrSampled * 2 + 1: fn = mlp_votes_kernel<kThrSampled, true>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kMlpThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::min(net.n_tiles, std::max(per_sm, 1) * sms);
  fn<<<grid, kMlpThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), net, static_cast<const uint32_t*>(thr),
      static_cast<const float*>(samples), static_cast<int32_t*>(out), b, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace picbnn
