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
// What bounds it on an H100: bytes, then latency.  Every product runs on
// the 1-bit tensor cores (`mma.sync .b1 .and.popc`, two per 256-bit K step
// for a Hamming distance, bmma.cuh): the HG net (4096-128-20) is 2 x 5.2e5
// bit-MACs a query, 2 x 2.1e9 at B = 4096, about 1 us at 19,044 bit-MACs
// per clock per SM, against 0.6 us to read its 2 MB of packed input at
// 3.35 TB/s.  At that size what remains is latency: the launch (1.2 us),
// staging the schedule, the vote table and the first tile (about 2 us),
// the HG rows (about 2 us), and one tile's chain of K steps
// (scripts/torch_mlp_tiles.py cuts the kernel after each phase).
//
// Design: the block program of mlp_block.cuh on the FC/head stage of
// fc_stage.cuh, shared with kernel 4.  A block of 32
// warps stages the shared schedule, a table of the vote at every head
// distance (so a vote is one load, not P compares), and, where they take
// 32 KB or more and fit (the HG MLP's 67 KB), every layer's rows and the
// head rows (cp.async, zero-padded to whole n8 tiles and K steps, row
// stride 4 mod 8 words); smaller rows (the MNIST MLP's 19 KB) are read
// from global memory through L1.  It then walks its tiles of `bq` queries
// (bq / 16 m16 tiles), fetching the next tile's input words with cp.async
// while the current one runs.  A warp item is one m16 tile by one n8 tile
// of neurons: at bq = 32 and 128 neurons, one item a warp.  The sign is
// one compare against the neuron's limit (n_bits + C) >> 1; two quad
// shuffles assemble the bits, which are ORed into the output word.
// Hidden depth is bounded by kMaxLayers; the wrapper raises above it.
#include "mlp_block.cuh"

using namespace picbnn;

extern "C" int fused_mlp_votes_launch(
    const void* x, int b, int kw0, int n_layers, const void* ws_v,
    const void* cs_v, const void* n_bits_v, const void* n_out_v,
    const void* kw_v, const void* head, int n_classes, int kw_head,
    int bias_cells, const void* thr, int thr_mode, int p, const void* samples,
    void* out, int bq, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpNet net = {};
  fill_tail(net.tail, n_layers, ws_v, cs_v, n_bits_v, n_out_v, kw_v, head,
            n_classes, kw_head, bias_cells);
  return mlp_launch(net, x, b, kw0, bq, thr, thr_mode, p, samples, out,
                    stream);
}
