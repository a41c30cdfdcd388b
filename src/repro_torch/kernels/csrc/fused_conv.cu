// Kernel 4: the whole deployed binary CNN in one launch.
//
// Replaces the Pallas kernel `fused_conv_votes` at
// src/repro/kernels/fused_conv.py:302 (`_make_kernel`, `conv_stage_packed`,
// `_conv_layer_packed`, `conv_hd_packed`).  Per conv layer, for every
// output position (oy, ox) and output channel o:
//     hd = sum over the k*k taps and Cw channel words of
//          popcount(x[oy*s + dy, ox*s + dx, w] ^ row_o[(dy*k + dx)*Cw + w]),
//     y = n_bits - 2*hd + C_o,  bit_o = (y >= 0)  (y == 0 maps to +1),
// and the bits repack into little-endian channel words (NHWC, each pixel
// padded to whole words).  VALID padding: out_side = (side - k)/s + 1.
// The last map, read in NHWC order, is the flattened query; on the
// head-direct path the bias drive words follow it.  The FC layers and
// the P-threshold head vote are kernel 3's tail (`mlp_tail`,
// picbnn.cuh).  Only the packed input enters and only the [B, C] int32
// votes leave device memory.  Mode kStage stops after the flatten and
// writes the query rows [B, kw_q] instead (`conv_stage_packed`, which the
// noiseless cumulative staircase feeds to kernel 1).
//
// What bounds it on an H100: the __popc pipe, 16 per clock per SM.  The
// function needs ceil(k*k*c_in/32) popcounts per conv output: at
// B = 4096 the paper's HG CNN (64x64, thermometer-4, two 3x3x32 stride-2
// convs, FC 128, 20 classes) needs 155,224 per query (conv 1's 36 bits
// in 2 words), 6.36e8 in all: 0.152 ms at 132 SMs x 1.98 GHz, against
// 0.02 ms to read its 67 MB input at 3.35 TB/s.  MNIST (28x28,
// thermometer-8: 72 bits in 3 words) needs 31,260 per query, 0.031 ms.
// This design pops each pixel's padded channel words, 9 per conv-1
// output (370,488 and 63,708 popcounts per query, 2.4x and 2.0x the
// function's); packing the taps densely is a redesign left for later.
//
// Design: a block of 512 threads holds kQ = 8 queries.  Their feature
// maps live in shared memory as a ping-pong pair: map i (the input is map
// 0) sits in half i % 2, each half sized to its widest stage, queries
// stored densely.  Every conv layer's filter rows are staged once, padded
// to whole 32-channel groups with zero rows and to an odd row stride, so
// 32 lanes reading 32 rows at one offset hit 32 banks.  A warp computes
// one (output position, 32-channel group) item for all 8 queries: lane l
// owns channel 32*g + l and loads each filter word once, the 8 queries'
// input words broadcast from shared memory (one tap row's k*Cw words are
// contiguous in NHWC), and the sign bits become the channel word with
// __ballot_sync.  The popcount pipe stays the busiest unit: each popcount
// costs one broadcast shared-memory load, plus one filter load per 8.
// Depth is capped at kMaxConv conv and kMaxLayers FC layers; the wrapper
// raises above them and where 8 queries do not fit in 227 KB.
#include "picbnn.cuh"

using namespace picbnn;

constexpr int kMaxConv = 8;
constexpr int kConvThreads = 512;  // 16 warps per block
constexpr int kStage = 3;          // mode: write the flattened query
constexpr int kMetaInts = 8;       // ints per conv layer from the host
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on an H100

struct ConvLayer {
  const uint32_t* w;  // [c_out, k*k*cw_in] tap-major rows
  const int32_t* c;   // [c_out] folded BN constants
  int side, cw_in, k, stride, out_side, c_out, cw_out, n_bits;
  int taps_w;   // k*k*cw_in words per filter row
  int fstride;  // taps_w rounded up to odd: the shared-memory row stride
  int foff;     // offset of this layer's rows in the filter region
  int in_w;     // words per query of the input map (side*side*cw_in)
};

struct ConvNet {
  ConvLayer conv[kMaxConv];
  MlpTail tail;
  int n_conv;
  int flat_bias;  // bias drive bits after the flatten (head-direct), else 0
  int kw_q;       // words per query after the flatten (zero-padded)
  int buf0, buf1; // words per query of the two shared-memory halves
  int filt_words; // words of the staged filter rows
};

template <int MODE>
__global__ void __launch_bounds__(kConvThreads)
fused_conv_kernel(const uint32_t* __restrict__ x, const ConvNet net,
                  const uint32_t* __restrict__ thr,
                  const float* __restrict__ samples,
                  int32_t* __restrict__ out, int b, int p) {
  extern __shared__ uint32_t smem[];
  uint32_t* thr_s = smem;
  uint32_t* filt = smem + kMaxPasses;
  uint32_t* cur = filt + net.filt_words;  // half 0: maps 0, 2, ...
  uint32_t* nxt = cur + kQ * net.buf0;    // half 1: maps 1, 3, ...
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * kQ;

  if (MODE == kThrInt || MODE == kThrFloat) load_thresholds(thr_s, thr, p);
  for (int l = 0; l < net.n_conv; ++l) {
    const ConvLayer& L = net.conv[l];
    for (int e = tid; e < L.cw_out * 32 * L.fstride; e += blockDim.x) {
      const int r = e / L.fstride, k = e % L.fstride;
      filt[L.foff + e] = (r < L.c_out && k < L.taps_w)
                             ? __ldg(L.w + (size_t)r * L.taps_w + k)
                             : 0u;
    }
  }
  const int in_w = net.conv[0].in_w;
  for (int e = tid; e < kQ * in_w; e += blockDim.x) {
    const int r = e / in_w;
    cur[e] = (b0 + r < b) ? __ldg(x + (size_t)b0 * in_w + e) : 0u;
  }
  __syncthreads();

  for (int l = 0; l < net.n_conv; ++l) {
    const ConvLayer& L = net.conv[l];
    const bool last = l + 1 == net.n_conv;
    const int n_pos = L.out_side * L.out_side;
    const int map_w = n_pos * L.cw_out;
    const int out_w = last ? net.kw_q : map_w;  // query stride of the output
    const int row_w = L.k * L.cw_in;            // one tap row's words
    for (int it = warp; it < n_pos * L.cw_out; it += n_warps) {
      const int pos = it / L.cw_out, g = it % L.cw_out;
      const int oy = pos / L.out_side, ox = pos % L.out_side;
      const int ch = g * 32 + lane;
      const uint32_t* frow = filt + L.foff + ch * L.fstride;
      const int cj = ch < L.c_out ? __ldg(L.c + ch) : 0;
      const uint32_t* xq =
          cur + (oy * L.stride * L.side + ox * L.stride) * L.cw_in;
      int acc[kQ];
#pragma unroll
      for (int r = 0; r < kQ; ++r) acc[r] = 0;
      for (int dy = 0; dy < L.k; ++dy) {
        const uint32_t* xrow = xq + dy * L.side * L.cw_in;
        const uint32_t* frw = frow + dy * row_w;
        for (int t = 0; t < row_w; ++t) {
          const uint32_t fv = frw[t];
#pragma unroll
          for (int r = 0; r < kQ; ++r) acc[r] += __popc(xrow[r * L.in_w + t] ^ fv);
        }
      }
#pragma unroll
      for (int r = 0; r < kQ; ++r) {
        const bool bit = ch < L.c_out && (L.n_bits - 2 * acc[r] + cj >= 0);
        const uint32_t word = __ballot_sync(0xffffffffu, bit);
        if (lane == r) nxt[r * out_w + pos * L.cw_out + g] = word;
      }
    }
    if (last) {  // bias drive words (head-direct), then zeros to kw_q
      for (int e = tid; e < kQ * (out_w - map_w); e += blockDim.x) {
        const int r = e / (out_w - map_w), i = e % (out_w - map_w);
        const int ones = net.flat_bias - 32 * i;
        nxt[r * out_w + map_w + i] =
            ones >= 32 ? 0xffffffffu : (ones > 0 ? (1u << ones) - 1u : 0u);
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (MODE == kStage) {
    uint32_t* q = reinterpret_cast<uint32_t*>(out);
    for (int e = tid; e < kQ * net.kw_q; e += blockDim.x) {
      const int r = e / net.kw_q;
      if (b0 + r < b) q[(size_t)b0 * net.kw_q + e] = cur[e];
    }
    return;
  }
  mlp_tail<MODE == kStage ? kThrInt : MODE>(net.tail, cur, nxt, thr_s,
                                            samples, out, b, b0, p, kQ);
}

// conv_meta: n_conv x kMetaInts ints, per layer (side, cw_in, k, stride,
// out_side, c_out, cw_out, n_bits), as kernels/fused_conv.py ConvMeta.
// kw_q: words per query after the flatten; the FC/head operand width on
// the vote path, n_pos*cw_out + bias words on the stage path.  buf0/buf1:
// words per query of the two shared-memory halves (fused_conv.py
// `_layout`, which also checks the budget).
extern "C" int fused_conv_launch(
    const void* x, int b, int n_conv, const void* conv_ws_v,
    const void* conv_cs_v, const void* conv_meta_v, int n_layers,
    const void* ws_v, const void* cs_v, const void* n_bits_v,
    const void* n_out_v, const void* kw_v, const void* head, int n_classes,
    int kw_head, int bias_cells, int flat_bias, int kw_q, int buf0, int buf1,
    const void* thr, int mode, int p, const void* samples, void* out,
    void* stream) {
  if (n_conv < 1 || n_conv > kMaxConv || n_layers < 0 ||
      n_layers > kMaxLayers || p < 0 || p > kMaxPasses || kw_q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const* cws = static_cast<const void* const*>(conv_ws_v);
  const void* const* ccs = static_cast<const void* const*>(conv_cs_v);
  const int* meta = static_cast<const int*>(conv_meta_v);

  ConvNet net = {};
  net.n_conv = n_conv;
  net.flat_bias = flat_bias;
  net.kw_q = kw_q;
  net.buf0 = buf0;
  net.buf1 = buf1;
  int foff = 0;
  for (int l = 0; l < n_conv; ++l) {
    ConvLayer& L = net.conv[l];
    const int* m = meta + l * kMetaInts;
    L.w = static_cast<const uint32_t*>(cws[l]);
    L.c = static_cast<const int32_t*>(ccs[l]);
    L.side = m[0];
    L.cw_in = m[1];
    L.k = m[2];
    L.stride = m[3];
    L.out_side = m[4];
    L.c_out = m[5];
    L.cw_out = m[6];
    L.n_bits = m[7];
    L.taps_w = L.k * L.k * L.cw_in;
    L.fstride = L.taps_w | 1;
    L.foff = foff;
    L.in_w = L.side * L.side * L.cw_in;
    foff += L.cw_out * 32 * L.fstride;
  }
  net.filt_words = foff;
  fill_tail(net.tail, n_layers, ws_v, cs_v, n_bits_v, n_out_v, kw_v, head,
            n_classes, kw_head, bias_cells, kw_q);

  void (*fn)(const uint32_t*, const ConvNet, const uint32_t*, const float*,
             int32_t*, int, int);
  switch (mode) {
    case kThrInt: fn = fused_conv_kernel<kThrInt>; break;
    case kThrFloat: fn = fused_conv_kernel<kThrFloat>; break;
    case kThrSampled: fn = fused_conv_kernel<kThrSampled>; break;
    case kStage: fn = fused_conv_kernel<kStage>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (kMaxPasses + (size_t)foff + (size_t)kQ * (buf0 + buf1)) * sizeof(uint32_t);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (b + kQ - 1) / kQ;
  fn<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), net, static_cast<const uint32_t*>(thr),
      static_cast<const float*>(samples), static_cast<int32_t*>(out), b, p);
  return static_cast<int>(cudaGetLastError());
}
