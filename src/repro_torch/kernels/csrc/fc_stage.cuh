// The FC/head stage on the 1-bit tensor cores, shared by kernels 3 and 4
// (fused_mlp.cu, fused_conv.cu; kernel 3 reaches it through the block
// program of mlp_block.cuh).
//
// A block holds `mtiles` m16 tiles of queries' packed words in shared
// memory.  Per FC layer a warp item is one m16 tile by NT n8 tiles of
// neurons (`fc_tiles`): per 256-bit K step it loads its A fragments once
// and runs two `.and.popc` products a tile (bmma.cuh: HD = popc(x & ~w) +
// popc(~x & w)).  The epilogue compares each distance with its neuron's
// limit, y = n_bits - 2*hd + C >= 0  <=>  hd <= (n_bits + C) >> 1 (an
// arithmetic shift, so a negative n_bits + C sets no bit), moves the bits
// to their places in the output word with two quad shuffles (bit 31 read
// as uint32) and ORs them into the next operand's words, which were
// first filled with zeros and, after the last layer, the bias drive ones.
// The head is the same tile followed by the vote (`head_votes`).
//
// Rows come from global memory (ROWS_GLOBAL: kernel 4, whose shared
// memory holds its maps, and nets too wide for shared memory; words past
// kw and rows past n are masked) or from shared memory, staged once per
// block by mlp_block.cuh, zero-padded to whole n8 tiles and whole
// 8-word K steps, at a row stride of 4 mod 8 words so B-fragment loads
// (rows g, words t and t+4) hit 32 banks.  Activations sit at query
// strides of 4 mod 8 words; with rows in shared memory their words up to
// the next K step are zero too, so the K loop masks nothing.
#pragma once

#include "bmma.cuh"
#include "picbnn.cuh"

namespace picbnn {

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// The quad's bits of one tile row ORed into one word (lane bits are
// disjoint).
__device__ __forceinline__ uint32_t quad_or(uint32_t v) {
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// NT n8 tiles of distances for one m16 tile: rows mt*16 + g (+8) of `act`
// (query stride `lda`, `kw` words) against columns n0 + nt*8 + g of the
// rows `w` (row stride `ldw`, `n` rows).  Tiles wholly past n are skipped
// (their sums stay 0).  acc[nt] is the mma's D fragment: rows g and g + 8,
// columns 2t and 2t + 1 of tile nt.
template <int NT, bool ROWS_GLOBAL>
__device__ __forceinline__ void fc_tiles(int (&acc)[NT][4],
                                         const uint32_t* act, int lda, int mt,
                                         const uint32_t* w, int ldw, int n,
                                         int kw, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* rg = act + (mt * 16 + g) * lda;
  const uint32_t* rh = rg + 8 * lda;
  const int live = min(NT, (n - n0 + 7) >> 3);  // tiles holding a row < n
  const uint32_t* wr[NT];
  bool ok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + g;
    ok[nt] = col < n;
    wr[nt] = w + (size_t)(ok[nt] || !ROWS_GLOBAL ? col : 0) * ldw;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  }
#pragma unroll 4
  for (int k0 = 0; k0 < kw; k0 += 8) {  // warp-uniform: mma is collective
    const int k = k0 + t;
    const bool in0 = !ROWS_GLOBAL || k < kw, in4 = !ROWS_GLOBAL || k + 4 < kw;
    uint32_t a[4] = {in0 ? rg[k] : 0u, in0 ? rh[k] : 0u,
                     in4 ? rg[k + 4] : 0u, in4 ? rh[k + 4] : 0u};
    uint32_t na[4];
    complement(na, a);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (NT > 1 && nt >= live) continue;  // warp-uniform
      uint32_t b0, b1;
      if (ROWS_GLOBAL) {
        b0 = ok[nt] && in0 ? __ldg(wr[nt] + k) : 0u;
        b1 = ok[nt] && in4 ? __ldg(wr[nt] + k + 4) : 0u;
      } else {
        b0 = wr[nt][k];
        b1 = wr[nt][k + 4];
      }
      bmma_hd(acc[nt], a, na, b0, b1);
    }
  }
}

// One FC layer for the block's mtiles*16 queries, `cur` -> `nxt`: the
// next operand's words (with rows in shared memory, up to the next K
// step) are filled with zeros and the bias drive ones, then every warp
// item ORs its neurons' sign bits in.  Ends synchronised.
template <int NT, bool ROWS_GLOBAL>
__device__ __forceinline__ void fc_layer(const Layer& L, const uint32_t* w,
                                         int ldw, const uint32_t* cur,
                                         int ld_cur, uint32_t* nxt,
                                         int ld_nxt, int mtiles) {
  static_assert(NT == 1 || NT == 2 || NT == 4, "an item stays in one word");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, n_warps = blockDim.x >> 5;
  const int width = ROWS_GLOBAL ? L.kw_out : round8(L.kw_out);
  for (int e = tid; e < mtiles * 16 * width; e += blockDim.x) {
    // bits [n_out, n_out + tail_bias) of the row are the bias drive
    const int r = e / width, i = e % width;
    const int lo_b = max(L.n_out - 32 * i, 0);
    const int hi_b = min(L.n_out + L.tail_bias - 32 * i, 32);
    nxt[r * ld_nxt + i] = hi_b > lo_b ? low_bits(hi_b) & ~low_bits(lo_b) : 0u;
  }
  __syncthreads();
  const int groups = (L.n_out + 8 * NT - 1) / (8 * NT);
  for (int it = warp; it < mtiles * groups; it += n_warps) {
    const int mt = it % mtiles, n0 = (it / mtiles) * 8 * NT;
    int acc[NT][4];
    fc_tiles<NT, ROWS_GLOBAL>(acc, cur, ld_cur, mt, w, ldw, L.n_out, L.kw_in,
                              n0);
    // neuron n0 + nt*8 + 2t + e lands on bit nt*8 + e, then all on 2t
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n0 + nt * 8 + 2 * t + e;
        if (j < L.n_out) {
          const int hd_max = (L.n_bits + __ldg(L.c + j)) >> 1;
          lo |= (uint32_t)(acc[nt][e] <= hd_max) << (nt * 8 + e);
          hi |= (uint32_t)(acc[nt][2 + e] <= hd_max) << (nt * 8 + e);
        }
      }
    }
    lo = quad_or(lo << 2 * t) << (n0 & 31);
    hi = quad_or(hi << 2 * t) << (n0 & 31);
    uint32_t* o = nxt + (mt * 16 + g) * ld_nxt + (n0 >> 5);
    if (t == 0) atomicOr(o, lo);
    if (t == 1) atomicOr(o + 8 * ld_nxt, hi);
  }
  __syncthreads();
}

// The head's distances and votes for the block's queries (batch rows
// b0 + r, r < mtiles*16; rows >= b are not written).  A distance below
// `vtab_n` reads its vote from the block's table, any other runs
// `vote_count`.
template <int MODE, int NT, bool ROWS_GLOBAL>
__device__ __forceinline__ void head_votes(
    const MlpTail& T, const uint32_t* w, int ldw, const uint32_t* cur,
    int ld_cur, int mtiles, int b0, int b, const uint32_t* thr_s,
    const int* vtab, int vtab_n, const float* __restrict__ samples, int p,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, n_warps = blockDim.x >> 5;
  const int groups = (T.n_classes + 8 * NT - 1) / (8 * NT);
  for (int it = warp; it < mtiles * groups; it += n_warps) {
    const int mt = it % mtiles, n0 = (it / mtiles) * 8 * NT;
    int acc[NT][4];
    fc_tiles<NT, ROWS_GLOBAL>(acc, cur, ld_cur, mt, w, ldw, T.n_classes,
                              T.kw_head, n0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cls = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = b0 + mt * 16 + g + 8 * (e >> 1);
        if (cls < T.n_classes && row < b) {
          const int hd = acc[nt][e];
          const float* s =
              MODE == kThrSampled
                  ? samples + ((size_t)row * T.n_classes + cls) * p
                  : nullptr;
          out[(size_t)row * T.n_classes + cls] =
              hd < vtab_n ? vtab[hd] : vote_count<MODE>(hd, thr_s, s, p);
        }
      }
    }
  }
}

// The FC layers and the head vote.  The first layer reads `cur` and
// writes `nxt`; later layers alternate between `nxt` and `alt` (kernel 4
// passes its two map halves, so `alt` is `cur`).  With rows in shared
// memory, `rows_s` holds them at the offsets `fill_tail` chose.
template <int MODE, int NT, bool ROWS_GLOBAL>
__device__ __forceinline__ void fc_stage(
    const MlpTail& T, const uint32_t* rows_s, uint32_t* cur, int ld_cur,
    uint32_t* nxt, int ld_nxt, uint32_t* alt, int ld_alt, int mtiles, int b0,
    int b, const uint32_t* thr_s, const int* vtab, int vtab_n,
    const float* __restrict__ samples, int p, int32_t* __restrict__ out) {
  for (int l = 0; l < T.n_layers; ++l) {
    const Layer& L = T.layers[l];
    fc_layer<NT, ROWS_GLOBAL>(L, ROWS_GLOBAL ? L.w : rows_s + L.soff,
                              ROWS_GLOBAL ? L.kw_in : L.ldw, cur, ld_cur, nxt,
                              ld_nxt, mtiles);
    uint32_t* done = l == 0 ? alt : cur;
    const int ld_done = l == 0 ? ld_alt : ld_cur;
    cur = nxt;
    ld_cur = ld_nxt;
    nxt = done;
    ld_nxt = ld_done;
  }
  head_votes<MODE, NT, ROWS_GLOBAL>(
      T, ROWS_GLOBAL ? T.head : rows_s + T.head_soff,
      ROWS_GLOBAL ? T.kw_head : T.head_ldw, cur, ld_cur, mtiles, b0, b, thr_s,
      vtab, vtab_n, samples, p, out);
}

}  // namespace picbnn
