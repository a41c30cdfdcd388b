// Kernel 2: the fused multi-threshold CAM vote (Algorithm 1).
//
// Replaces the Pallas kernel `cam_vote` (`_cam_vote_kernel`) in
// src/repro/kernels/cam_search.py:
//     hd = popcount-XOR distance of every (query, class row) pair, once
//     votes[b, c] = #{t : hd <= T_t}
// with the three threshold forms of the reference: an int32 [P] schedule,
// a float32 [P] schedule (compared as float(hd) <= T), or a float32
// [B, C, P] block of sampled thresholds.
//
// What bounds it on an H100: at the paper's heads (q[4096, 6] against 10
// or 20 rows) the distances are 1-2 m16n8 tiles of one 256-bit K step a
// query tile and the bytes (the queries in, the [B, C] votes out, about
// 0.4 MB) take 0.1 us, so the launch and one block's chain of latencies
// (stage, table, one tile) set its time.  The sampled form reads its
// [B, C, P] float block, larger than both packed operands together.
//
// Design: kernel 3's block program (mlp_block.cuh) with no hidden layers:
// the class rows read from global memory through L1 (staged in shared
// memory from 32 KB on, where they fit), the query tiles fetched with
// cp.async, the distances on the 1-bit tensor cores (`mma.sync .b1
// .and.popc`), and for the shared schedules a per-block table of the vote
// at every distance, so a vote is one load.  Tiles hold kBq queries, 16
// where kBq of them do not fit.
#include "mlp_block.cuh"

using namespace picbnn;

constexpr int kBq = 32;  // queries a tile

extern "C" int cam_vote_launch(const void* q, const void* rows, const void* thr,
                               const void* samples, void* out, int b, int c,
                               int kw, int p, int thr_mode, void* stream) {
  MlpNet net = {};
  fill_tail(net.tail, 0, nullptr, nullptr, nullptr, nullptr, nullptr, rows, c,
            kw, 0);
  // the tiles alone (rows read from global) must fit at kBq, else at 16
  net.bq = kBq;
  net.ld_in = round8(kw) + 4;
  net.vtab_n = thr_mode == kThrSampled ? 0 : std::min(32 * kw + 1, kVoteTab);
  const int bq =
      mlp_base_words(net) * sizeof(uint32_t) <= kSmemLimit ? kBq : 16;
  return mlp_launch(net, q, b, kw, bq, thr, thr_mode, p, samples, out, stream);
}
