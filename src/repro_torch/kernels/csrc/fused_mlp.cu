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
// to the widest layer.  The layers and the head vote are `mlp_tail`
// (picbnn.cuh), which kernel 4 shares: a warp produces one output word for
// kQ = 8 queries at a time, lane l owning neuron j = 32*word + l, and the
// sign bits become words with __ballot_sync.  Hidden depth is bounded by
// kMaxLayers; the wrapper raises above it.
#include "picbnn.cuh"

using namespace picbnn;

constexpr int kThreads = 256;  // 8 warps per block

struct Net {
  MlpTail tail;
  int kw0, max_kw;
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
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * bq;

  if (MODE != kThrSampled) load_thresholds(thr_s, thr, p);
  for (int e = tid; e < bq * net.kw0; e += blockDim.x) {
    const int r = e / net.kw0;
    cur[e] = (b0 + r < b) ? x[(size_t)b0 * net.kw0 + e] : 0u;
  }
  __syncthreads();
  mlp_tail<MODE>(net.tail, cur, nxt, thr_s, samples, out, b, b0, p, bq);
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
  Net net = {};
  net.kw0 = kw0;
  net.max_kw = fill_tail(net.tail, n_layers, ws_v, cs_v, n_bits_v, n_out_v,
                         kw_v, head, n_classes, kw_head, bias_cells, kw0);

  void (*fn)(const uint32_t*, const Net, const uint32_t*, const float*,
             int32_t*, int, int, int);
  switch (thr_mode) {
    case kThrInt: fn = fused_mlp_kernel<kThrInt>; break;
    case kThrFloat: fn = fused_mlp_kernel<kThrFloat>; break;
    case kThrSampled: fn = fused_mlp_kernel<kThrSampled>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (kMaxPasses + 2 * (size_t)bq * net.max_kw) * sizeof(uint32_t);
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
