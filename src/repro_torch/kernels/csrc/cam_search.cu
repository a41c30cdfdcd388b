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
// What bounds it on an H100, by shape:
// - An LM head (B <= 32 queries against C = 2,048-128,256 rows of 48-64
//   words): bytes.  At C = 128,256 the rows are 32.8 MB and the votes
//   2 MB: 0.0104 ms at 3.35 TB/s, against about 2 us of 1-bit products
//   (two `.and.popc` a K step) and 1 us of vote compares.  The card only
//   reaches its memory rate with every SM streaming, many bytes in
//   flight each; cp.async rings of 16-byte copies stalled at about 1.5
//   TB/s (scripts/torch_kernel_plans.py).
// - The paper's heads (B = 4096 queries of 4-6 words against 10 or 20
//   rows): the launch and one block's chain of latencies (the schedule,
//   the vote table, one tile), the bytes being 0.4 MB.
// - The sampled form reads its [B, C, P] float block, larger than both
//   packed operands together.
//
// Design: the reference's grid, query tiles x row tiles.  A block holds
// bq queries (16 where B <= 16, so no m16 tile is all padding; else 32,
// an m16 tile wholly past B skipped) and a row tile of whole groups of 64
// rows, sized so the grid holds about four blocks an SM (501 blocks at
// C = 128,256; one row tile at C = 10 or 20).  Its queries are staged
// once in shared memory (cp.async).  Its rows, by `RowsMode`:
// - kRowsTma (Kw % 4 == 0, both bases on 16 bytes): a 4-stage ring, one
//   2-D TMA box of 64 rows x 32 words a stage on an mbarrier, 128-byte
//   swizzled so that fragment loads (rows g, words t and t + 4) hit
//   distinct banks; rows past C and words past Kw arrive as zero;
// - kRowsWords (other widths and views off 16 bytes): the same ring
//   filled by 4-byte cp.async, rows at a stride of 4 mod 8 words;
// - kRowsGlobal (every block's rows one stage: C <= 64, Kw <= 32, the
//   paper's heads): no ring; fragments read from global memory (L1).
// Eight warps each take 8 rows of a stage (an n8 tile) against every
// live m16 tile: HD = popc(q & ~r) + popc(~q & r) on `mma.sync .b1
// .and.popc` (bmma.cuh).  After a group's last K chunk each distance is
// voted: for the shared schedules from a per-block table of the vote at
// every distance where the block votes more pairs than the table has
// entries (`use_table`), else by counting its P compares directly
// (picbnn.cuh `vote_count`); the sampled form always counts.  Both ways
// were timed at every shape (scripts/torch_kernel_plans.py `table_always`,
// `count_always`): counting costs up to 0.015 ms more where the rule
// tabulates (C = 128,256 at B = 16-32, the paper's heads), tabulating up
// to 0.001 ms more where it counts (musicgen's head at B = 4), and at
// B = 1-4 of the vocabulary head the two tie.
// kernels/cam_search.py `cam_plan` is the host twin of the launch plan.
#include <algorithm>
#include <cstring>

#include "bmma.cuh"
#include "picbnn.cuh"
#include "tensor_map.cuh"

using namespace picbnn;

namespace {

constexpr int kThreads = 256;     // eight warps
constexpr int kGroupRows = 64;    // rows a stage: one n8 tile a warp
constexpr int kMaxKC = 32;        // words of K a stage, at most
constexpr int kStages = 4;
constexpr int kVoteTab = 2048;    // most entries of the vote table
constexpr int kBlocksPerSm = 4;   // blocks the grid aims for, an SM
constexpr int kBarWords = 2 * kStages;  // the ring's mbarriers
constexpr int kTmaKC = 32;  // words of K a TMA stage: one 128-byte row
// how a block reads its rows: through a ring of cp.async 4-byte words, of
// 2-D TMA boxes (128-byte swizzled, on mbarriers), or, where its rows are
// one stage, straight from global memory
enum RowsMode : int { kRowsWords = 0, kRowsTma = 1, kRowsGlobal = 2 };

struct CamPlan {
  int bq;         // queries a tile (16 or 32)
  int kc;         // words of K a stage (a multiple of 8, at most kMaxKC)
  int n_chunks;   // K chunks a row group
  int ldq;        // query stride in shared memory (n_chunks * kc + 4)
  int gpb;        // row groups a block
  int vtab_n;     // entries of the vote table (0: none)
  int mode;       // RowsMode
  size_t smem;    // bytes of shared memory a block
};

// Whether a block votes through the table: where it votes more pairs
// than the table has entries (building it costs P compares an entry,
// counting P compares a pair).
__device__ __forceinline__ bool use_table(int votes, int vtab_n) {
  return vtab_n > 0 && votes > vtab_n;
}

// Stage rows [row0, row0 + kGroupRows) x words [k0, k0 + kc) of src
// ([n, kw] words) into dst (row stride kc + 4) with 4-byte cp.async; rows
// past n and words past kw are zero.
__device__ __forceinline__ void load_group(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int n, int kw, int row0, int k0,
                                           int kc) {
  const int ld = kc + 4;
  for (int e = threadIdx.x; e < kGroupRows * kc; e += kThreads) {
    const int r = e / kc, k = e - r * kc;
    const bool ok = row0 + r < n && k0 + k < kw;
    cp_async4(dst + r * ld + k,
              ok ? src + (size_t)(row0 + r) * kw + k0 + k : src, ok ? 4 : 0);
  }
}

template <int MODE, int ROWS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
cam_vote_kernel(const uint32_t* __restrict__ q,
                const uint32_t* __restrict__ rows,
                const __grid_constant__ CUtensorMap rmap,
                const uint32_t* __restrict__ thr,
                const float* __restrict__ samples, int32_t* __restrict__ out,
                int b, int c, int kw, int p, const CamPlan plan) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a barrier a stage
  uint32_t* thr_s = smem + kBarWords;
  int* vtab = reinterpret_cast<int*>(thr_s + kMaxPasses);
  uint32_t* q_s = thr_s + kMaxPasses + ((plan.vtab_n + 3) & ~3);
  uint32_t* ring = q_s + plan.bq * plan.ldq;
  if (ROWS == kRowsTma)  // TMA boxes: 1 KB atoms of the 128-byte swizzle
    ring += ((1024 - (smem_addr(ring) & 1023)) & 1023) / 4;
  const int ld = ROWS == kRowsTma ? kTmaKC : plan.kc + 4;  // row stride
  const int ring_w = kGroupRows * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int q0 = blockIdx.x * plan.bq;
  const int row_base = blockIdx.y * plan.gpb * kGroupRows;
  const int live_q = min(plan.bq, b - q0);
  const int live_mt = (live_q + 15) >> 4;  // m16 tiles holding a query
  const int groups = min(plan.gpb, (c - row_base + kGroupRows - 1) /
                                       kGroupRows);
  const int items = groups * plan.n_chunks;  // (group, K chunk) stages

  // item `it`'s rows into its stage: one TMA box (thread 0; rows past c
  // and words past kw arrive as zero), or 4-byte cp.async by every thread
  auto issue = [&](int it) {
    const int row0 = row_base + (it / plan.n_chunks) * kGroupRows;
    const int k0 = (it % plan.n_chunks) * plan.kc;
    uint32_t* dst = ring + (it % kStages) * ring_w;
    if (ROWS == kRowsTma) {
      mbar_arrive_expect(full + it % kStages, kGroupRows * kTmaKC * 4);
      tensor_copy_2d(dst, &rmap, k0, row0, full + it % kStages);
    } else {
      load_group(dst, rows, c, kw, row0, k0, plan.kc);
    }
  };

  if (ROWS == kRowsTma && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
    for (int s = 0; s < kStages - 1 && s < items; ++s) issue(s);
  }
  // the queries (every word of every chunk, zero past kw)
  {
    const bool al = ROWS == kRowsTma;  // 16-byte granules
    const int words = plan.n_chunks * plan.kc;
    const int gw = al ? words >> 2 : words;
    for (int e = threadIdx.x; e < plan.bq * gw; e += kThreads) {
      const int r = e / gw, k = (al ? 4 : 1) * (e - r * gw);
      const bool ok = r < live_q && k < kw;
      const uint32_t* src = ok ? q + (size_t)(q0 + r) * kw + k : q;
      if (al) cp_async16(q_s + r * plan.ldq + k, src, ok ? 16 : 0);
      else cp_async4(q_s + r * plan.ldq + k, src, ok ? 4 : 0);
    }
  }
  if (ROWS == kRowsWords) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < items) issue(s);
      cp_async_commit();  // group 0 holds the queries too
    }
  } else {
    cp_async_commit();  // the queries
  }
  if (MODE != kThrSampled) load_thresholds(thr_s, thr, p);
  if (ROWS != kRowsWords) cp_async_wait<0>();
  __syncthreads();  // the schedule is in (and, but for kRowsWords, queries)
  const int rows_here = min(plan.gpb * kGroupRows, c - row_base);
  const bool table = use_table(live_q * rows_here, plan.vtab_n);
  if (table)
    for (int h = threadIdx.x; h < plan.vtab_n; h += kThreads)
      vtab[h] = vote_count<MODE>(h, thr_s, nullptr, p);

  int acc[2][4];
  for (int i = 0; i < items; ++i) {
    const int nx = i + kStages - 1;
    if (ROWS == kRowsTma) {
      __syncthreads();  // every warp is done with i - 1 (and the table)
      if (threadIdx.x == 0 && nx < items) issue(nx);
      mbar_wait(full + i % kStages, (i / kStages) & 1);
    } else if (ROWS == kRowsWords) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage i is in; every warp is done with i - 1
      if (nx < items) issue(nx);
      cp_async_commit();
    } else if (i == 0) {
      __syncthreads();  // the table is in
    }
    const int gp = i / plan.n_chunks, ch = i - gp * plan.n_chunks;
    const int r0 = row_base + gp * kGroupRows + warp * 8;  // warp's rows
    if (ch == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0;
    }
    if (r0 < c) {  // warp-uniform: the warp holds a row < c
      const int row = warp * 8 + g;  // in the stage
      const uint32_t* rw = ring + (i % kStages) * ring_w + row * ld;
      const uint32_t* rg_ = rows + (size_t)min(r0 + g, c - 1) * kw +
                            ch * plan.kc;
      const bool row_ok = r0 + g < c;
      const uint32_t* qa = q_s + g * plan.ldq + ch * plan.kc;
      const int left = kw - ch * plan.kc;  // words of the chunk inside kw
#pragma unroll 4
      for (int k = t; k < plan.kc; k += 8) {
        uint32_t a[2][4], na[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* rg = qa + mt * 16 * plan.ldq;
          const uint32_t* rh = rg + 8 * plan.ldq;
          const bool in = mt < live_mt;  // (block-uniform)
          a[mt][0] = in ? rg[k] : 0u;
          a[mt][1] = in ? rh[k] : 0u;
          a[mt][2] = in ? rg[k + 4] : 0u;
          a[mt][3] = in ? rh[k + 4] : 0u;
          complement(na[mt], a[mt]);
        }
        uint32_t b0, b1;
        if (ROWS == kRowsTma) {  // unit k/4 of the row at k/4 ^ (row % 8)
          b0 = rw[4 * ((k >> 2) ^ (row & 7)) + (k & 3)];
          b1 = rw[4 * (((k >> 2) + 1) ^ (row & 7)) + (k & 3)];
        } else if (ROWS == kRowsWords) {
          b0 = rw[k];
          b1 = rw[k + 4];
        } else {
          b0 = row_ok && k < left ? __ldg(rg_ + k) : 0u;
          b1 = row_ok && k + 4 < left ? __ldg(rg_ + k + 4) : 0u;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < live_mt) bmma_hd(acc[mt], a[mt], na[mt], b0, b1);
      }
    }
    if (ch == plan.n_chunks - 1 && r0 < c) {  // the group's votes
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= live_mt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cls = r0 + 2 * t + (e & 1);
          const int row = q0 + mt * 16 + g + 8 * (e >> 1);
          if (cls >= c || row >= b) continue;
          const int hd = acc[mt][e];
          const float* s =
              MODE == kThrSampled ? samples + ((size_t)row * c + cls) * p
                                  : nullptr;
          out[(size_t)row * c + cls] =
              table && hd < plan.vtab_n ? vtab[hd]
                                        : vote_count<MODE>(hd, thr_s, s, p);
        }
      }
    }
  }
  if (ROWS == kRowsWords) cp_async_wait<0>();
}

}  // namespace

// The launch plan (kernels/cam_search.py `cam_plan` is its host twin):
// {bq, kc, n_chunks, gpb, row tiles, vtab_n, smem bytes, rows mode}.
extern "C" int cam_vote_plan(int b, int c, int kw, int sampled, int aligned,
                             int sms, int* out8) {
  if (b <= 0 || c <= 0 || kw <= 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CamPlan pl = {};
  size_t ring = 0;  // bytes of the row ring
  if (c <= kGroupRows && kw <= kMaxKC) {  // every block's rows: one stage
    pl.mode = kRowsGlobal;
    pl.n_chunks = 1;
    pl.kc = round8(kw);
  } else if (aligned && kw % 4 == 0) {
    pl.mode = kRowsTma;
    pl.n_chunks = (kw + kTmaKC - 1) / kTmaKC;
    pl.kc = kTmaKC;
    ring = (size_t)kStages * kGroupRows * kTmaKC * 4 + 1024;  // + alignment
  } else {
    pl.mode = kRowsWords;
    pl.n_chunks = (kw + kMaxKC - 1) / kMaxKC;  // chunks of equal width
    pl.kc = round8((kw + pl.n_chunks - 1) / pl.n_chunks);
    ring = (size_t)kStages * kGroupRows * (pl.kc + 4) * 4;
  }
  pl.ldq = pl.n_chunks * pl.kc + 4;
  pl.vtab_n = sampled ? 0 : std::min(32 * kw + 1, kVoteTab);
  const size_t fixed =
      4 * ((size_t)kBarWords + kMaxPasses + ((pl.vtab_n + 3) & ~3)) + ring;
  pl.bq = b <= 16 || fixed + 4 * 32 * (size_t)pl.ldq > kSmemLimit ? 16 : 32;
  pl.smem = fixed + 4 * (size_t)pl.bq * pl.ldq;
  if (pl.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qt = (b + pl.bq - 1) / pl.bq;
  const long long groups = (c + kGroupRows - 1) / kGroupRows;
  const long long target = (long long)kBlocksPerSm * sms;
  pl.gpb = (int)std::max(1LL, (groups * n_qt + target - 1) / target);
  const int vals[8] = {pl.bq, pl.kc, pl.n_chunks, pl.gpb,
                       (int)((groups + pl.gpb - 1) / pl.gpb), pl.vtab_n,
                       (int)pl.smem, pl.mode};
  std::copy(vals, vals + 8, out8);
  return 0;
}

extern "C" int cam_vote_launch(const void* q, const void* rows, const void* thr,
                               const void* samples, void* out, int b, int c,
                               int kw, int p, int thr_mode, void* stream) {
  if (p < 0 || p > kMaxPasses || thr_mode < kThrInt || thr_mode > kThrSampled)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  int v[8];
  const int perr =
      cam_vote_plan(b, c, kw, thr_mode == kThrSampled, aligned, sms, v);
  if (perr) return perr;
  CamPlan pl = {};
  pl.bq = v[0];
  pl.kc = v[1];
  pl.n_chunks = v[2];
  pl.ldq = pl.n_chunks * pl.kc + 4;
  pl.gpb = v[3];
  pl.vtab_n = v[5];
  pl.smem = (size_t)v[6];
  pl.mode = v[7];
  const dim3 grid((b + pl.bq - 1) / pl.bq, v[4]);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap rmap;
  std::memset(&rmap, 0, sizeof(rmap));
  if (pl.mode == kRowsTma && !rows_map(&rmap, rows, c, kw, kTmaKC, kGroupRows))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const uint32_t*, const uint32_t*, const CUtensorMap,
                      const uint32_t*, const float*, int32_t*, int, int, int,
                      int, const CamPlan);
  const Fn fns[3][3] = {
      {cam_vote_kernel<kThrInt, kRowsWords>,
       cam_vote_kernel<kThrInt, kRowsTma>,
       cam_vote_kernel<kThrInt, kRowsGlobal>},
      {cam_vote_kernel<kThrFloat, kRowsWords>,
       cam_vote_kernel<kThrFloat, kRowsTma>,
       cam_vote_kernel<kThrFloat, kRowsGlobal>},
      {cam_vote_kernel<kThrSampled, kRowsWords>,
       cam_vote_kernel<kThrSampled, kRowsTma>,
       cam_vote_kernel<kThrSampled, kRowsGlobal>}};
  const Fn fn = fns[thr_mode][pl.mode];
  if (pl.smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(pl.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(rows), rmap,
      static_cast<const uint32_t*>(thr), static_cast<const float*>(samples),
      static_cast<int32_t*>(out), b, c, kw, p, pl);
  return static_cast<int>(cudaGetLastError());
}
