// Kernel 4: the whole deployed binary CNN in one launch.
//
// Replaces the Pallas kernel `fused_conv_votes` at
// src/repro/kernels/fused_conv.py:302 (`_make_kernel`, `conv_stage_packed`,
// `_conv_layer_packed`, `conv_hd_packed`).  Per conv layer, for every
// output position (oy, ox) and output channel o:
//     hd = Hamming distance of the position's k*k*c_in tap bits to
//          filter o's,  y = n_bits - 2*hd + C_o,  bit_o = (y >= 0)
//          (y == 0 maps to +1),
// and the bits repack into little-endian channel words (NHWC, each pixel
// padded to whole words).  VALID padding: out_side = (side - k)/s + 1.
// The last map, read in NHWC order, is the flattened query; on the
// head-direct path the bias drive words follow it.  Then the FC layers
// and the P-threshold head vote.  Only the packed input enters and only
// the [B, C] int32 votes leave device memory.  Mode kStage stops after
// the flatten and writes the query rows [B, kw_q] instead
// (`conv_stage_packed`, which the noiseless cumulative staircase feeds
// to kernel 1).
//
// What bounds it on an H100: bytes.  Every product runs on the 1-bit
// tensor cores (`mma.sync .b1 .and.popc`, two per K step for a Hamming
// distance, bmma.cuh).  Counted by the function's own bits, the HG CNN
// (64x64 thermometer-4, two 3x3x32 stride-2 convs, FC 128, 20 classes)
// is 4.1 M MACs per query, 2 x 1.7e10 bit-MACs at B = 4096: 7 us at
// 19,044 bit-MACs per clock per SM, against 20 us to read its 67 MB
// packed input at 3.35 TB/s.  What holds it above that is integer
// issue: building the A fragments from the maps (gathers, funnel shifts)
// and the sign epilogue cost a few hundred instructions per 16 x 32
// tile against eight products (scripts/torch_conv_phases.py times each
// phase).
//
// Design: a block of 16 warps holds kQB = 16 queries, one m16 tile of
// the FC layers' products; two blocks fit an SM at the paper's widths.
//  * Input: where c_in <= 16 (one word a pixel in the global layout)
//    each pixel is compacted to `pitch` bits on the way in (c_in rounded
//    up to a power of two: HG 4 bits, 16 KB -> 2 KB a query): coalesced
//    16-byte loads, eight in flight a thread, and the lanes that hold one
//    compact word's pixels OR them together with shuffles.
//  * Dense taps: on the compacted input a conv output's K vector is
//    its k*k taps at `pitch` bits each (zero above c_in), each kernel
//    row starting a word, so HG conv 1 has its 36 bits in 3 words (one
//    256-bit K step), not 9 padded words.  Later layers take whole
//    channel words, word d = channel word d % cw_in of tap d / cw_in
//    (conv 2: 9 words, 2 steps).  Either way a dense word is one run of
//    map bits: each block tabulates, per layer and word, the run's first
//    bit and mask (`dense_word`; `kernels/fused_conv.py` `dense_plan` is
//    its host twin), so an A fragment is a table load, a funnel shift
//    and a mask, straight from the map in shared memory.  The filters
//    are re-laid into the same dense rows once per block, in shared
//    memory at a row stride of 4 mod 8 words (conflict-free B loads).
//  * Conv layers as implicit GEMM: a warp item is one query's 16
//    positions x 32 channels; per K step four n8 tiles, two products
//    each.  Per block, tables in shared memory give each position's
//    first pixel and each channel's largest distance that still sets its
//    bit (y = n_bits - 2*hd + C >= 0  <=>  hd <= (n_bits + C) >> 1), so
//    an item does no division and the epilogue is one compare a channel;
//    the 32-channel word is assembled with two quad shuffles (bit 31
//    read as uint32) and written by lanes t = 0 (row g) and t = 1
//    (row g + 8).
//  * FC layers and head: the FC/head stage of fc_stage.cuh, shared with
//    kernel 3: M = the block's 16 queries, N in n8 tiles (one per
//    warp item), B read from global (L2) straight into fragments; FC
//    sign bits are ORed into zeroed words in shared memory; the head
//    votes with `vote_count`.
//  * Maps live in shared memory as a ping-pong pair (map i in half
//    i % 2), query strides of 4 mod 8 words.  Depth is capped at
//    kMaxConv conv and kMaxLayers FC layers; the wrapper raises above
//    them and where 16 queries do not fit in 227 KB.
#include "fc_stage.cuh"

using namespace picbnn;

constexpr int kMaxConv = 8;
constexpr int kConvThreads = 512;  // 16 warps per block, two blocks an SM
constexpr int kQB = 16;            // queries per block
constexpr int kStage = 3;          // mode: write the flattened query
constexpr int kMetaInts = 8;       // ints per conv layer from the host

struct ConvLayer {
  const uint32_t* w;  // [c_out, k*k*cw_in] tap-major rows
  const int32_t* c;   // [c_out] folded BN constants
  int side, cw_in, k, stride, out_side, c_out, cw_out, n_bits;
  int pitch;    // dense bits per tap: c_in rounded up to a power of two
                // on the compacted input, else 32*cw_in (whole words)
  int store;    // bits per pixel of this layer's input map in smem
  int words;    // dense words per output position
  int woff;     // offset of this layer's entries in the word table
  int ksteps;   // 256-bit K steps
  int fstride;  // smem row stride of the dense filters (ksteps*8 + 4)
  int foff;     // offset of this layer's rows in the filter region
  int mtiles;   // m16 tiles of output positions
  int toff;     // offset of this layer's position table (mtiles*16 ints)
  int coff;     // offset of its per-channel largest distances (cw_out*32)
};

struct ConvNet {
  ConvLayer conv[kMaxConv];
  MlpTail tail;
  int n_conv;
  int flat_bias;   // bias drive bits after the flatten (head-direct), else 0
  int kw_q;        // words per query after the flatten (zero-padded)
  int buf0, buf1;  // words per query of the two smem halves
  int filt_words;  // words of the dense filter rows
  int tab_words;   // entries of the word table (dense words, all layers)
  int pos_words;   // ints of the position tables
  int hd_words;    // ints of the per-channel largest distances
};

// Dense word d of layer L's K vectors as one run of map bits: (its first
// bit past the position's first pixel, the mask of its length).  On the
// compacted input (pitch < 32) word d is kernel row d / wr's taps
// [dx0, dx0 + per), contiguous in the map; else it is channel word
// d % cw_in of tap d / cw_in.  `kernels/fused_conv.py` `dense_plan`
// computes the same runs on the host.
__device__ __forceinline__ void dense_word(const ConvLayer& L, int d,
                                           int& src, uint32_t& mask) {
  if (L.pitch >= 32) {
    const int tap = d / L.cw_in;
    src = (((tap / L.k) * L.side + tap % L.k) * L.cw_in + d % L.cw_in) * 32;
    mask = 0xffffffffu;
    return;
  }
  const int per = 32 / L.pitch, wr = (L.k + per - 1) / per;
  const int dx0 = (d % wr) * per;
  src = ((d / wr) * L.side + dx0) * L.pitch;
  mask = low_bits(min(per, L.k - dx0) * L.pitch);
}

// Dense word d of two positions' K vectors (rows g and g + 8 of an m16
// tile, whose first pixels sit at bits bg and bh of the map): the map's
// 32 bits at bit base + src[d], masked by mask[d] (the word table).
__device__ __forceinline__ void dense_pair(const uint32_t* map, int bg,
                                           int bh, const int* src,
                                           const uint32_t* mask, int words,
                                           int d, uint32_t& vg,
                                           uint32_t& vh) {
  if (d >= words) {
    vg = vh = 0u;
    return;
  }
  const int ag = bg + src[d], ah = bh + src[d];
  vg = __funnelshift_r(map[ag >> 5], map[(ag >> 5) + 1], ag & 31) & mask[d];
  vh = __funnelshift_r(map[ah >> 5], map[(ah >> 5) + 1], ah & 31) & mask[d];
}

// Dense word d of filter row o (the same layout as `dense_pair`).
__device__ __forceinline__ uint32_t dense_filter_word(const ConvLayer& L,
                                                      int o, int d) {
  const int kk = L.k * L.k;
  const uint32_t* row = L.w + (size_t)o * kk * L.cw_in;
  if (L.pitch >= 32) return d < kk * L.cw_in ? __ldg(row + d) : 0u;
  // a kernel row starts a word and fills wr words, `per` taps each
  // (cw_in == 1 here)
  const int per = 32 / L.pitch, wr = (L.k * L.pitch + 31) / 32;
  const int dy = d / wr, dx0 = (d % wr) * per;
  uint32_t v = 0u;
  for (int dx = dx0; dx < L.k && dx < dx0 + per; ++dx)
    v |= (__ldg(row + dy * L.k + dx) & low_bits(L.pitch))
         << ((dx - dx0) * L.pitch);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(kConvThreads, 2)
fused_conv_kernel(const uint32_t* __restrict__ x, const __grid_constant__ ConvNet net,
                  const uint32_t* __restrict__ thr,
                  const float* __restrict__ samples,
                  int32_t* __restrict__ out, int b, int p) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* thr_s = smem;
  int* wsrc = reinterpret_cast<int*>(smem + kMaxPasses);  // word table
  uint32_t* wmask = smem + kMaxPasses + net.tab_words;
  uint32_t* filt = wmask + net.tab_words;
  int* pos_tab = reinterpret_cast<int*>(filt + net.filt_words);
  int* hd_max = pos_tab + net.pos_words;
  uint32_t* cur = reinterpret_cast<uint32_t*>(hd_max + net.hd_words);  // half 0
  uint32_t* nxt = cur + kQB * net.buf0;  // half 1: maps 1, 3, ...
  int ld_cur = net.buf0, ld_nxt = net.buf1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * kQB;
  const int nq = min(kQB, b - b0);  // real queries of this block

  if (MODE == kThrInt || MODE == kThrFloat) load_thresholds(thr_s, thr, p);
  for (int l = 0; l < net.n_conv; ++l) {
    const ConvLayer& L = net.conv[l];
    for (int e = tid; e < L.words; e += blockDim.x)
      dense_word(L, e, wsrc[L.woff + e], wmask[L.woff + e]);
    for (int e = tid; e < L.cw_out * 32 * L.fstride; e += blockDim.x) {
      const int r = e / L.fstride, d = e % L.fstride;
      filt[L.foff + e] =
          (r < L.c_out && d < L.words) ? dense_filter_word(L, r, d) : 0u;
    }
    // each position's first pixel, in bits of the map (row tiles of 16;
    // positions past the map read position 0 and are not stored)
    const int n_pos = L.out_side * L.out_side;
    for (int e = tid; e < L.mtiles * 16; e += blockDim.x) {
      const int pos = e < n_pos ? e : 0;
      pos_tab[L.toff + e] = ((pos / L.out_side) * L.stride * L.side +
                             (pos % L.out_side) * L.stride) * L.store;
    }
    // bit_o = (n_bits - 2*hd + C_o >= 0) = (hd <= (n_bits + C_o) >> 1);
    // channels past c_out never set (hd >= 0 > -1)
    for (int e = tid; e < L.cw_out * 32; e += blockDim.x)
      hd_max[L.coff + e] = e < L.c_out ? (L.n_bits + __ldg(L.c + e)) >> 1 : -1;
  }
  {  // the input maps into half 0, compacted to `store` bits a pixel
     // where store < 32 (c_in <= 16: one word a pixel in the global map)
    const ConvLayer& L = net.conv[0];
    const int ss = L.side * L.side, row_w = ss * L.cw_in;
    const int per = L.store < 32 ? 32 / L.store : 1;  // pixels a word
    const uint32_t mask = low_bits(L.store);
    const bool vec = row_w % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (L.store >= 32) {  // whole channel words: copied as they are
      for (int e = tid; e < kQB * row_w; e += blockDim.x) {
        const int r = e / row_w, i = e % row_w;
        cur[r * ld_cur + i] =
            r < nq ? __ldg(x + (size_t)(b0 + r) * row_w + i) : 0u;
      }
    } else if (vec && per >= 4 && ss % per == 0) {
      // coalesced 16-byte loads, 8 in flight a thread; the g4 lanes whose
      // 4 pixels make one compact word OR them together with shuffles
      const int g4 = per / 4, q4 = ss / 4, total = kQB * q4;
      const int sub = lane % g4;
      for (int base = warp * 32; base < total; base += blockDim.x * 8) {
        uint4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = base + u * blockDim.x + lane, r = e / q4;
          v[u] = e < total && r < nq
                     ? __ldg(reinterpret_cast<const uint4*>(
                                 x + (size_t)(b0 + r) * row_w) + e - r * q4)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = base + u * blockDim.x + lane;
          uint32_t wd = ((v[u].x & mask) | (v[u].y & mask) << L.store |
                         (v[u].z & mask) << 2 * L.store |
                         (v[u].w & mask) << 3 * L.store)
                        << (sub * 4 * L.store);
          for (int o = 1; o < g4; o <<= 1)
            wd |= __shfl_xor_sync(0xffffffffu, wd, o);
          if (sub == 0 && e < total) {
            const int r = e / q4;
            cur[r * ld_cur + (e - r * q4) / g4] = wd;
          }
        }
      }
    } else {  // any other shape: a thread builds a word from its pixels
      const int n_w = (ss + per - 1) / per;
      for (int e = tid; e < kQB * n_w; e += blockDim.x) {
        const int r = e / n_w, i0 = (e % n_w) * per;
        uint32_t v = 0u;
        if (r < nq) {
          const uint32_t* px = x + (size_t)(b0 + r) * ss;
          for (int k = 0; k < per && i0 + k < ss; ++k)
            v |= (__ldg(px + i0 + k) & mask) << (k * L.store);
        }
        cur[r * ld_cur + e % n_w] = v;
      }
    }
  }
  __syncthreads();

  for (int l = 0; l < net.n_conv; ++l) {
    const ConvLayer& L = net.conv[l];
    const bool last = l + 1 == net.n_conv;
    const int n_pos = L.out_side * L.out_side;
    const int map_w = n_pos * L.cw_out;
    for (int j = 0; j < L.cw_out; ++j) {
      // this lane's channels' largest distances that still set the bit
      int hmax[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hmax[nt][e] = hd_max[L.coff + j * 32 + nt * 8 + 2 * t + e];
      // items (query r, tile mt), warp-strided without a division a step
      int r = warp / L.mtiles, mt = warp % L.mtiles;
      for (; r < nq; mt += n_warps) {
        while (mt >= L.mtiles) {
          mt -= L.mtiles;
          ++r;
        }
        if (r >= nq) break;
        const uint32_t* map = cur + r * ld_cur;
        const int pg = mt * 16 + g, ph = pg + 8;
        const int base_g = pos_tab[L.toff + pg];
        const int base_h = pos_tab[L.toff + ph];
        int acc[4][4] = {};
        for (int ks = 0; ks < L.ksteps; ++ks) {
          const int d = ks * 8 + t;
          uint32_t a[4];
          dense_pair(map, base_g, base_h, wsrc + L.woff, wmask + L.woff,
                     L.words, d, a[0], a[1]);
          dense_pair(map, base_g, base_h, wsrc + L.woff, wmask + L.woff,
                     L.words, d + 4, a[2], a[3]);
          uint32_t na[4];
          complement(na, a);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t* fr =
                filt + L.foff + (j * 32 + nt * 8 + g) * L.fstride + d;
            bmma_hd(acc[nt], a, na, fr[0], fr[4]);
          }
        }
        // channel nt*8 + 2t + e lands on bit nt*8 + e, then all on 2t
        uint32_t lo = 0u, hi = 0u;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            lo |= (uint32_t)(acc[nt][e] <= hmax[nt][e]) << (nt * 8 + e);
            hi |= (uint32_t)(acc[nt][2 + e] <= hmax[nt][e]) << (nt * 8 + e);
          }
        }
        lo = quad_or(lo << 2 * t);
        hi = quad_or(hi << 2 * t);
        uint32_t* o = nxt + r * ld_nxt + j;
        if (t == 0 && pg < n_pos) o[pg * L.cw_out] = lo;
        if (t == 1 && ph < n_pos) o[ph * L.cw_out] = hi;
      }
    }
    if (last) {  // bias drive words (head-direct), then zeros to kw_q
      const int tail_w = net.kw_q - map_w;
      for (int e = tid; e < kQB * tail_w; e += blockDim.x) {
        const int r = e / tail_w, i = e % tail_w;
        const int ones = net.flat_bias - 32 * i;
        nxt[r * ld_nxt + map_w + i] =
            ones >= 32 ? 0xffffffffu : (ones > 0 ? (1u << ones) - 1u : 0u);
      }
    }
    __syncthreads();
    uint32_t* tp = cur;
    cur = nxt;
    nxt = tp;
    const int tl = ld_cur;
    ld_cur = ld_nxt;
    ld_nxt = tl;
  }

  if (MODE == kStage) {
    uint32_t* q = reinterpret_cast<uint32_t*>(out);
    for (int e = tid; e < nq * net.kw_q; e += blockDim.x) {
      const int r = e / net.kw_q, i = e % net.kw_q;
      q[(size_t)(b0 + r) * net.kw_q + i] = cur[r * ld_cur + i];
    }
    return;
  }

  // the FC layers and the head vote (fc_stage.cuh, shared with kernel
  // 3): one n8 tile a warp item, rows read from global memory
  fc_stage<MODE == kStage ? kThrInt : MODE, 1, true>(
      net.tail, nullptr, cur, ld_cur, nxt, ld_nxt, cur, ld_cur, 1, b0, b,
      thr_s, nullptr, 0, samples, p, out);
}

// conv_meta: n_conv x kMetaInts ints, per layer (side, cw_in, k, stride,
// out_side, c_out, cw_out, n_bits), as kernels/fused_conv.py `_launch`
// lays them out.  kw_q: words per query after the flatten; the
// FC/head operand width on the vote path, n_pos*cw_out + bias words on
// the stage path.  buf0/buf1: words per query of the two shared-memory
// halves (fused_conv.py `_layout`, which also checks the budget).
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
    // the input is compacted to `pitch` bits a pixel where c_in <= 16
    // (fused_conv.py `dense_plans`)
    const int c_in = L.n_bits / (L.k * L.k);
    if (l == 0 && c_in <= 16) {
      L.pitch = 1;
      while (L.pitch < c_in) L.pitch <<= 1;
      L.store = L.pitch;
      L.words = L.k * ((L.k * L.pitch + 31) / 32);
    } else {
      L.pitch = L.store = 32 * L.cw_in;
      L.words = L.k * L.k * L.cw_in;
    }
    L.woff = net.tab_words;
    net.tab_words += L.words;
    L.ksteps = (L.words + 7) / 8;
    L.fstride = L.ksteps * 8 + 4;
    L.foff = foff;
    foff += L.cw_out * 32 * L.fstride;
    L.mtiles = (L.out_side * L.out_side + 15) / 16;
    L.toff = net.pos_words;
    net.pos_words += L.mtiles * 16;
    L.coff = net.hd_words;
    net.hd_words += L.cw_out * 32;
  }
  net.filt_words = foff;
  fill_tail(net.tail, n_layers, ws_v, cs_v, n_bits_v, n_out_v, kw_v, head,
            n_classes, kw_head, bias_cells);

  void (*fn)(const uint32_t*, const ConvNet, const uint32_t*, const float*,
             int32_t*, int, int);
  switch (mode) {
    case kThrInt: fn = fused_conv_kernel<kThrInt>; break;
    case kThrFloat: fn = fused_conv_kernel<kThrFloat>; break;
    case kThrSampled: fn = fused_conv_kernel<kThrSampled>; break;
    case kStage: fn = fused_conv_kernel<kStage>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  // + 1 word: a run's second load may read one word past the last map
  const size_t smem = (kMaxPasses + 2 * (size_t)net.tab_words + foff +
                       net.pos_words + net.hd_words +
                       (size_t)kQB * (buf0 + buf1) + 1) * sizeof(uint32_t);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (b + kQB - 1) / kQB;
  fn<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), net,
      static_cast<const uint32_t*>(thr), static_cast<const float*>(samples),
      static_cast<int32_t*>(out), b, p);
  return static_cast<int>(cudaGetLastError());
}
