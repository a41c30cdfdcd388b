// Kernel 3: the whole deployed binary MLP in one launch (the main path).
//
// Replaces the Pallas kernel `fused_mlp_votes` (`_make_kernel`, `_hd_block`,
// `_repack`) in src/repro/kernels/fused_mlp.py.  Per hidden layer:
//     hd = popcount(x ^ W_j) summed over words, y = n_bits - 2*hd + C_j,
//     bit_j = (y >= 0)  (y == 0 maps to +1),
//     repack the bits into little-endian words, appending `bias_cells`
//     ones after the last hidden layer (the head's bias drive) and zeros
//     up to the next operand's width;
// then the head distance and the P-threshold vote.  Only the packed input
// enters and only the [B, C] int32 votes leave device memory.
//
// What bounds it on an H100: integer issue.  At MNIST (784-128-10) a query
// costs 128*25 + 10*6 word XOR-popcounts against 100 bytes in and 40 out,
// so the 16-per-clock-per-SM __popc rate, not the 3.35 TB/s of memory,
// sets the floor; at small batches launch latency dominates both.
//
// Design: one block of 256 threads per tile of `bq` queries.  The tile's
// activation words live in a ping-pong pair of shared-memory buffers sized
// to the widest layer.  A warp produces one output word for kQ = 8 queries
// at a time: lane l owns neuron j = 32*word + l, reads its weight row once
// (through the read-only cache) for all 8 queries, whose words broadcast
// from shared memory, and keeps 8 distances in registers.  The sign bits
// become words with __ballot_sync, bit l from lane l: exactly the
// little-endian repack of the reference.  The head stage votes with
// `vote_count`, the device function kernel 2 uses.  Hidden depth is
// bounded by kMaxLayers; the wrapper raises above it.
#include "picbnn.cuh"

using namespace picbnn;

constexpr int kMaxLayers = 8;
constexpr int kQ = 8;          // queries a warp carries per output word
constexpr int kThreads = 256;  // 8 warps per block

struct Layer {
  const uint32_t* w;  // [n_out, kw_in] packed weight rows
  const int32_t* c;   // [n_out] folded BN constants
  int n_bits;         // logical input bits (the dot width)
  int n_out;          // neurons = bits produced
  int kw_in;          // words per input row
  int kw_out;         // words per output row (next operand's width)
  int tail_bias;      // ones appended after the neurons (last layer only)
};

struct Net {
  Layer layers[kMaxLayers];
  const uint32_t* head;  // [n_classes, kw_head] class rows, bias cells incl.
  int n_layers, n_classes, kw_head, kw0, max_kw;
};

template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const uint32_t* __restrict__ x, const Net net,
                 const uint32_t* __restrict__ thr,
                 const float* __restrict__ samples, int32_t* __restrict__ out,
                 int b, int p, int bq) {
  extern __shared__ uint32_t smem[];
  uint32_t* thr_s = smem;
  uint32_t* cur = smem + kMaxPasses;
  uint32_t* nxt = cur + bq * net.max_kw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * bq;
  const int groups = bq / kQ;

  if (MODE != kThrSampled) load_thresholds(thr_s, thr, p);
  for (int e = tid; e < bq * net.kw0; e += blockDim.x) {
    const int r = e / net.kw0;
    cur[e] = (b0 + r < b) ? x[(size_t)b0 * net.kw0 + e] : 0u;
  }
  __syncthreads();

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

extern "C" int fused_mlp_votes_launch(
    const void* x, int b, int kw0, int n_layers, const void* ws_v,
    const void* cs_v, const void* n_bits_v, const void* n_out_v,
    const void* kw_v, const void* head, int n_classes, int kw_head,
    int bias_cells, const void* thr, int thr_mode, int p, const void* samples,
    void* out, int bq, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || bq <= 0 || bq % kQ != 0 ||
      p < 0 || p > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const* ws = static_cast<const void* const*>(ws_v);
  const void* const* cs = static_cast<const void* const*>(cs_v);
  const int* n_bits = static_cast<const int*>(n_bits_v);
  const int* n_out = static_cast<const int*>(n_out_v);
  const int* kw = static_cast<const int*>(kw_v);

  Net net = {};
  net.n_layers = n_layers;
  net.head = static_cast<const uint32_t*>(head);
  net.n_classes = n_classes;
  net.kw_head = kw_head;
  net.kw0 = kw0;
  int max_kw = kw0 > kw_head ? kw0 : kw_head;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = net.layers[l];
    L.w = static_cast<const uint32_t*>(ws[l]);
    L.c = static_cast<const int32_t*>(cs[l]);
    L.n_bits = n_bits[l];
    L.n_out = n_out[l];
    L.kw_in = kw[l];
    L.kw_out = l + 1 < n_layers ? kw[l + 1] : kw_head;
    L.tail_bias = l + 1 < n_layers ? 0 : bias_cells;
    if (kw[l] > max_kw) max_kw = kw[l];
  }
  net.max_kw = max_kw;

  void (*fn)(const uint32_t*, const Net, const uint32_t*, const float*,
             int32_t*, int, int, int);
  switch (thr_mode) {
    case kThrInt: fn = fused_mlp_kernel<kThrInt>; break;
    case kThrFloat: fn = fused_mlp_kernel<kThrFloat>; break;
    case kThrSampled: fn = fused_mlp_kernel<kThrSampled>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (kMaxPasses + 2 * (size_t)bq * max_kw) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (b + bq - 1) / bq;
  fn<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), net, static_cast<const uint32_t*>(thr),
      static_cast<const float*>(samples), static_cast<int32_t*>(out), b, p, bq);
  return static_cast<int>(cudaGetLastError());
}
