// Kernel 1: pairwise Hamming distances between packed rows.
//
// Replaces the Pallas kernel `binary_gemm_hd` (`_binary_gemm_kernel`) in
// src/repro/kernels/binary_gemm.py:
//     out[m, n] = sum_k popcount(x[m, k] ^ w[n, k])     x [M, Kw], w [N, Kw]
//
// What bounds it on an H100 is bytes or the 1-bit tensor cores, by
// shape, and the launch picks one of three plans from (M, N, Kw) and
// alignment (`gemm_plan`; kernels/binary_gemm.py `gemm_plan` is its host
// twin):
//
// - tile32x128, the paper's shapes (the main path's M = 4096, N = 128,
//   the CNN FC and heads, the examples, LM prefill at M = 64): 1-2 us of
//   products and 0.1-1.1 us of bytes, so the kernel sits near launch
//   latency.  A block of 8 warps owns a 32 x 128 output tile (128 blocks
//   cover M = 4096).  K is streamed in 16-word chunks through a 3-stage
//   ring of cp.async copies.  Every copy is an aligned 16-byte granule
//   whatever Kw is: where Kw % 4 != 0 (HG CNN FC rows are 225 words) a
//   row's chunk lands up to 3 words into its 20-word shared row, and
//   words past Kw are masked as they are read.  Where Kw % 4 == 0 and
//   both bases sit on 16 bytes, a second instantiation copies four
//   granules a row at offset 0, the ones past Kw zero: it is the faster
//   of the two at the main path's aligned shapes (scripts/
//   torch_gemm_paths.py times both).  Rows 20 words apart (4 mod 8) put
//   a warp's fragment loads on distinct banks.  Warp w computes the 32 x
//   16 sub-tile at columns 16w: each 256-bit K step two `mma.sync
//   .and.popc` products a tile (HD = popc(x & ~w) + popc(~x & w)).
// - large (N >= 256 where the 32 x 128 tile's grid would hold more than
//   two blocks an SM, `kSmallWaves`; Kw % 4 == 0, both bases on 16
//   bytes: the long-context prefill, x[32768, 64] w[8192, 64] and
//   x[32768, 256] w[2048, 256]): the [M, N] int32 output
//   bounds it (1.07 GB, 0.32 ms at 3.35 TB/s, for the first; 0.27 GB and
//   0.55e15 bit-MACs, 0.09 ms, for the second).  One persistent block an
//   SM, two warpgroups, walks 128 x 256 output tiles.  K streams in
//   32-word chunks of both tiles (48 KB) through a 4-stage ring of 2-D
//   TMA boxes (one thread issues, an mbarrier a stage, 128-byte swizzled,
//   zero outside the operands) that runs on across tiles, so the next
//   tile's words arrive during this tile's epilogue; a cp.async ring of
//   16-byte copies held the loads to about 1.3 TB/s.  Each warpgroup runs
//   `wgmma.m64n256k256 .and.popc` on its 64 rows (1.54x the rate of
//   `mma.sync`, bmma.cuh), one chunk's products left in flight while
//   the next chunk's issue behind them, and the block takes each tile
//   row's popcount from the words as they land (in registers, summed
//   once a tile), so a distance is one product: HD = popc(x) + popc(w)
//   - 2 popc(x & w), half the tensor work of two.  The epilogue stages
//   each warp's 16 x 32 slab through shared memory and writes it as
//   coalesced 16-byte streaming stores; the tensor cores idle meanwhile,
//   which is what the output-bound first shape pays
//   (scripts/torch_kernel_plans.py cuts the kernel after each phase).
// - split_k (M <= 16, Kw >= 64: the decode BitLinear, x[4, 256] w[2048,
//   256]): bytes of w, 2 MB (0.6 us), but a 32 x 128 tile leaves 16
//   blocks walking 16 K chunks each.  A block of 8 warps owns one n8
//   tile of columns and splits K among its warps (each a run of 256-bit
//   steps, operands read from global memory through L1), then adds the
//   eight partial int32 sums in shared memory, exactly: N / 8 blocks.
//
// Ragged M and N are zero-filled by the copies (zero words add nothing
// to a distance or a popcount) and masked on the store.
//
// grouped_bitlinear_kernel is the grouped entry (the dropless MoE's
// BitLinear experts): x holds E runs of rows, run e (rows offsets[e] ..
// offsets[e + 1]) against its own w[e] [N, Kw], in one launch.  Its
// blocks are the tile32x128 plan's, laid out over every run's tiles: a
// grid of N / 128 by (S / 32 + E), at least the sum of the runs' tile
// rows; block row y walks the device's offsets (E + 1 words, cached) to
// the run and tile row it owns, and blocks past the last tile exit.  A
// run's tile is the tile32x128 body on that run's rows, its rows past
// the run's end zero, so every expert's slots meet only its own rows.
// At the LM's cell (S = 16,384-32,768 slots of 32 experts, N 1,792 /
// 2,048, Kw 64 / 56) the [S, N] int32 output is its bound.
#include <algorithm>

#include "bmma.cuh"
#include "picbnn.cuh"
#include "tensor_map.cuh"

using namespace picbnn;

namespace {

constexpr int kBM = 32, kBN = 128, kKC = 16, kStages = 3;
constexpr int kLd = kKC + 4;  // smem row: 5 granules of 4 words (= 4 mod 8)
constexpr int kThreads = 256;

// Copy the 4-word granule that starts at word `ga` of a tensor of `total`
// words (which may reach past either end) into `dst`; words outside the
// tensor are zero.  `base` points at the tensor's word 0.
__device__ __forceinline__ void copy_granule(uint32_t* dst,
                                             const uint32_t* base,
                                             long long ga, long long total) {
  if (ga >= 0 && ga + 4 <= total) {
    cp_async16(dst, base + ga, 16);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = ga + i >= 0 && ga + i < total;
    cp_async4(dst + i, ok ? base + ga + i : base, ok ? 4 : 0);
  }
}

// Stage K chunk [k0, k0 + kKC) of the tile's x and w rows.  ALIGNED
// (Kw % 4 == 0, both bases on 16 bytes): four granules a row, the ones
// past Kw zero.  Otherwise rows are still copied as aligned 16-byte
// granules: the row's chunk starts `off` = (word address % 4) words into
// its smem row, a fifth granule covers its end, and the words past Kw
// (the next row's) are masked when read.  Rows past M or N are zero.
template <bool ALIGNED>
__device__ __forceinline__ void load_chunk(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ w, int m,
    int n, int kw, int m0, int n0, int k0, int mis_x, int mis_w,
    uint32_t (*xs)[kLd], uint32_t (*ws)[kLd]) {
  constexpr int kG = ALIGNED ? 4 : 5;  // granules a row
  for (int e = threadIdx.x; e < (kBM + kBN) * kG; e += kThreads) {
    int r = e / kG;
    const int q = e % kG;
    const bool is_x = r < kBM;
    if (!is_x) r -= kBM;
    const int row = (is_x ? m0 : n0) + r, rows = is_x ? m : n;
    const uint32_t* base = is_x ? x : w;
    uint32_t* dst = is_x ? &xs[r][4 * q] : &ws[r][4 * q];
    if (ALIGNED) {
      const int gk = k0 + 4 * q;
      const bool ok = row < rows && gk < kw;
      cp_async16(dst, ok ? base + (size_t)row * kw + gk : base, ok ? 16 : 0);
      continue;
    }
    const int mis = is_x ? mis_x : mis_w;
    const long long s = (long long)row * kw + k0 + mis;  // aligned coords
    if (row >= rows)
      cp_async16(dst, base, 0);
    else if (q < 4 || (s & 3))
      copy_granule(dst, base, (s & ~3LL) - mis + 4 * q, (long long)rows * kw);
  }
}

}  // namespace

// The 32 x 128 output tile at (m0, n0) of x [m, kw] against w [n, kw],
// staged through the block's ring xs / ws.
template <bool ALIGNED>
__device__ __forceinline__ void hd_tile(const uint32_t* __restrict__ x,
                                        const uint32_t* __restrict__ w,
                                        int32_t* __restrict__ out, int m, int n,
                                        int kw, int m0, int n0,
                                        uint32_t (*xs)[kBM][kLd],
                                        uint32_t (*ws)[kBN][kLd]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_chunks = (kw + kKC - 1) / kKC;
  // words by which each base sits past a 16-byte boundary
  const int mis_x = (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int mis_w = (int)((reinterpret_cast<uintptr_t>(w) >> 2) & 3);
  // where each of this lane's rows starts in its smem row (the same for
  // every chunk: chunks start at multiples of 16 words)
  int off_x[2][2], off_w[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      off_x[mt][h] = ALIGNED ? 0 :
          (int)(((long long)(m0 + mt * 16 + g + 8 * h) * kw + mis_x) & 3);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    off_w[nt] = ALIGNED ? 0 :
        (int)(((long long)(n0 + warp * 16 + nt * 8 + g) * kw + mis_w) & 3);

  int acc[2][2][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks)
      load_chunk<ALIGNED>(x, w, m, n, kw, m0, n0, s * kKC, mis_x, mis_w,
                          xs[s], ws[s]);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in, and every warp is done with c - 1
    const int nc = c + kStages - 1;
    if (nc < n_chunks)
      load_chunk<ALIGNED>(x, w, m, n, kw, m0, n0, nc * kKC, mis_x, mis_w,
                          xs[nc % kStages], ws[nc % kStages]);
    cp_async_commit();
    const int st = c % kStages;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const int k = ks * 8 + t;
      const int left = kw - c * kKC;  // words of this chunk inside the row
      const bool in0 = k < left, in4 = k + 4 < left;
      uint32_t a[2][4], na[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* rg = xs[st][mt * 16 + g] + off_x[mt][0];
        const uint32_t* rh = xs[st][mt * 16 + g + 8] + off_x[mt][1];
        a[mt][0] = in0 ? rg[k] : 0u;
        a[mt][1] = in0 ? rh[k] : 0u;
        a[mt][2] = in4 ? rg[k + 4] : 0u;
        a[mt][3] = in4 ? rh[k + 4] : 0u;
        complement(na[mt], a[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* rw = ws[st][warp * 16 + nt * 8 + g] + off_w[nt];
        const uint32_t b0 = in0 ? rw[k] : 0u, b1 = in4 ? rw[k + 4] : 0u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) bmma_hd(acc[mt][nt], a[mt], na[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + g + 8 * h;
        if (row >= m) continue;
        if (col < n) out[(size_t)row * n + col] = acc[mt][nt][2 * h];
        if (col + 1 < n) out[(size_t)row * n + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
binary_gemm_hd_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ w, int32_t* __restrict__ out,
                      int m, int n, int kw) {
  __shared__ __align__(16) uint32_t xs[kStages][kBM][kLd];
  __shared__ __align__(16) uint32_t ws[kStages][kBN][kLd];
  hd_tile<ALIGNED>(x, w, out, m, n, kw, blockIdx.y * kBM, blockIdx.x * kBN,
                   xs, ws);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
grouped_bitlinear_kernel(const uint32_t* __restrict__ x,
                         const int32_t* __restrict__ offsets,
                         const uint32_t* __restrict__ w,
                         int32_t* __restrict__ out, int experts, int n,
                         int kw) {
  __shared__ __align__(16) uint32_t xs[kStages][kBM][kLd];
  __shared__ __align__(16) uint32_t ws[kStages][kBN][kLd];
  int tile = blockIdx.y, e = 0, start = 0, rows = 0;
  for (; e < experts; ++e) {  // block-uniform: every thread finds the same
    start = __ldg(offsets + e);
    rows = __ldg(offsets + e + 1) - start;
    const int tiles = (rows + kBM - 1) / kBM;
    if (tile < tiles) break;
    tile -= tiles;
  }
  if (e == experts) return;  // past the last run's tiles
  hd_tile<ALIGNED>(x + (size_t)start * kw, w + (size_t)e * n * kw,
                   out + (size_t)start * n, rows, n, kw, tile * kBM,
                   blockIdx.x * kBN, xs, ws);
}

namespace {

// ------------------------------------------------------------- split_k
constexpr int kSplitWarps = 8;

// One n8 tile of columns for M <= 16 rows: warp w adds the distances of
// its run of 256-bit K steps, operands read from global memory (rows
// past M, columns past N and words past Kw read as zero), then the
// block sums the eight partials.
__global__ void __launch_bounds__(kSplitWarps * 32)
binary_gemm_hd_split_k(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ w,
                       int32_t* __restrict__ out, int m, int n, int kw) {
  __shared__ int part[kSplitWarps][16][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 8;
  const int steps = (kw + 7) >> 3;
  const int per = (steps + kSplitWarps - 1) / kSplitWarps;
  const int s0 = warp * per, s1 = min(steps, s0 + per);
  const bool rg_ok = g < m, rh_ok = g + 8 < m, col_ok = n0 + g < n;
  const uint32_t* xg = x + (size_t)(rg_ok ? g : 0) * kw;
  const uint32_t* xh = x + (size_t)(rh_ok ? g + 8 : 0) * kw;
  const uint32_t* wc = w + (size_t)(col_ok ? n0 + g : 0) * kw;
  int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {  // warp-uniform: mma is collective
    const int k = 8 * s + t;
    const bool in0 = k < kw, in4 = k + 4 < kw;
    uint32_t a[4] = {rg_ok && in0 ? __ldg(xg + k) : 0u,
                     rh_ok && in0 ? __ldg(xh + k) : 0u,
                     rg_ok && in4 ? __ldg(xg + k + 4) : 0u,
                     rh_ok && in4 ? __ldg(xh + k + 4) : 0u};
    const uint32_t b0 = col_ok && in0 ? __ldg(wc + k) : 0u;
    const uint32_t b1 = col_ok && in4 ? __ldg(wc + k + 4) : 0u;
    uint32_t na[4];
    complement(na, a);
    bmma_hd(acc, a, na, b0, b1);
  }
  part[warp][g][2 * t] = acc[0];
  part[warp][g][2 * t + 1] = acc[1];
  part[warp][g + 8][2 * t] = acc[2];
  part[warp][g + 8][2 * t + 1] = acc[3];
  __syncthreads();
  if (threadIdx.x < 128) {
    const int r = threadIdx.x >> 3, cc = threadIdx.x & 7;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kSplitWarps; ++i) sum += part[i][r][cc];
    if (r < m && n0 + cc < n) out[(size_t)r * n + n0 + cc] = sum;
  }
}

// --------------------------------------------------------------- large
constexpr int kLM = 128, kLN = 256;  // output tile
constexpr int kLKC = 32;             // words of K a stage: one 128-byte row
constexpr int kLStages = 4;
constexpr int kLThreads = 256;       // two warpgroups
constexpr int kLRows = kLM + kLN;    // tile rows a stage (x then w)
constexpr int kLStageBytes = kLRows * kLKC * 4;  // 48 KB
constexpr int kLUnits = kLStageBytes / 16 / kLThreads;  // popcount units
constexpr int kStgLd = 40;  // epilogue slab row stride (8 mod 32 words)
// the ring, epilogue slabs, popcounts, barriers, and 1 KB to align the
// ring to the 128-byte swizzle's 1 KB atoms
constexpr size_t kLSmem = (size_t)kLStages * kLStageBytes +
                          4 * (8 * 16 * kStgLd + 2 * kLRows) +
                          8 * kLStages + 1024;

// A K-major operand tile as the 128-byte-swizzled TMA box leaves it:
// 128 bytes (one K chunk) a row, 8-row atoms of 1 KB; K step s starts
// 32 s bytes into each row.  Leading byte offset unused (1), stride byte
// offset 1 KB (between 8-row atoms), layout 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__global__ void __launch_bounds__(kLThreads, 1)
binary_gemm_hd_large(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw,
                     int32_t* __restrict__ out, int m, int n, int kw) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* stg = reinterpret_cast<int*>(ring + kLStages * kLStageBytes);
  int* pop = stg + 8 * 16 * kStgLd;  // [2][kLRows]: x rows, then w rows
  uint64_t* full = reinterpret_cast<uint64_t*>(pop + 2 * kLRows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tiles_n = (n + kLN - 1) / kLN;
  const int tiles = ((m + kLM - 1) / kLM) * tiles_n;
  const int n_chunks = (kw + kLKC - 1) / kLKC;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int items = mine * n_chunks;  // (tile, K chunk) stages
  stg += warp * 16 * kStgLd;

  // item `it`: its tile's x and w boxes at its K chunk, one thread
  auto issue = [&](int it) {
    const int tile = blockIdx.x + (it / n_chunks) * gridDim.x;
    const int k0 = (it % n_chunks) * kLKC, st = it % kLStages;
    uint8_t* dst = ring + st * kLStageBytes;
    mbar_arrive_expect(full + st, kLStageBytes);
    tensor_copy_2d(dst, &mx, k0, (tile / tiles_n) * kLM, full + st);
    tensor_copy_2d(dst + kLM * kLKC * 4, &mw, k0, (tile % tiles_n) * kLN,
                   full + st);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLStages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
    for (int s = 0; s < kLStages - 1 && s < items; ++s) issue(s);
  }
  __syncthreads();  // the barriers are initialised

  int acc[128];
  int cnt[kLUnits];  // this thread's units' popcounts over the tile's chunks
  for (int i = 0; i < items; ++i) {
    const int lt = i / n_chunks, ch = i - lt * n_chunks, par = lt & 1;
    const bool last = ch == n_chunks - 1;
    const uint8_t* st = ring + (i % kLStages) * kLStageBytes;
    if (ch == 0) {  // (the previous tile's products are all done)
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0;
#pragma unroll
      for (int j = 0; j < kLUnits; ++j) cnt[j] = 0;
    }
    mbar_wait(full + i % kLStages, (i / kLStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kLKC / 8; ++s)
      wgmma_and_n256(acc, sw128_desc(st + wg * 64 * 128 + 32 * s),
                     sw128_desc(st + kLM * 128 + 32 * s));
    wgmma_commit();
    // each tile row's popcount while the products run: unit u of the
    // stage is 16 bytes of tile row u / 8 (the swizzle moves units within
    // their row), and this thread's units are the same every chunk
#pragma unroll
    for (int it = 0; it < kLUnits; ++it) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + 16 * (threadIdx.x + kLThreads * it));
      cnt[it] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    // the previous chunk's products are done (this one's may run on
    // into the next chunk, but for a tile's last), so its stage is free
    if (last) {
      wgmma_wait<0>();
      fence_regs(acc);  // the epilogue reads acc after the wait
#pragma unroll
      for (int it = 0; it < kLUnits; ++it) {
        int c = cnt[it];
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        // (tile lt - 1's epilogue may still read the other half)
        if ((lane & 7) == 0)
          pop[par * kLRows + ((threadIdx.x + kLThreads * it) >> 3)] = c;
      }
    } else {
      wgmma_wait<1>();  // (acc is not touched: it stays in flight)
    }
    __syncthreads();  // every warp is done with item i - 1 (and with a
                      // tile's last item, its popcounts are in)
    if (threadIdx.x == 0 && i + kLStages - 1 < items)
      issue(i + kLStages - 1);
    if (!last) continue;

    const int tile = blockIdx.x + lt * gridDim.x;
    const int m0 = (tile / tiles_n) * kLM, n0 = (tile % tiles_n) * kLN;
    const int rbase = 16 * warp;  // the warp's slab: tile rows rbase..+15
    const int* pa_s = pop + par * kLRows;
    const int* pb_s = pa_s + kLM;
    const bool vec = (n & 3) == 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // columns 32jj .. 32jj + 31
#pragma unroll
      for (int jm = 0; jm < 4; ++jm) {
        const int j = 4 * jj + jm;
        *reinterpret_cast<int2*>(stg + g * kStgLd + 8 * jm + 2 * t) =
            make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(stg + (g + 8) * kStgLd + 8 * jm + 2 * t) =
            make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = 4 * it + (lane >> 3), c4 = 4 * (lane & 7);
        const int row = m0 + rbase + r, col = n0 + 32 * jj + c4;
        const int4 v = *reinterpret_cast<const int4*>(stg + r * kStgLd + c4);
        const int4 pb = *reinterpret_cast<const int4*>(pb_s + 32 * jj + c4);
        const int pa = pa_s[rbase + r];
        const int4 hd = make_int4(pa + pb.x - 2 * v.x, pa + pb.y - 2 * v.y,
                                  pa + pb.z - 2 * v.z, pa + pb.w - 2 * v.w);
        if (row >= m) continue;
        int32_t* o = out + (size_t)row * n + col;
        if (vec && col + 3 < n) {
          __stcs(reinterpret_cast<int4*>(o), hd);
        } else {
          if (col < n) o[0] = hd.x;
          if (col + 1 < n) o[1] = hd.y;
          if (col + 2 < n) o[2] = hd.z;
          if (col + 3 < n) o[3] = hd.w;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

enum GemmPlan : int { kTile32x128 = 0, kLarge = 1, kSplitK = 2 };
// The large tile takes over where the 32 x 128 tile's grid would hold
// more than kSmallWaves blocks an SM: at up to two the 32 x 128 tile is
// as fast or faster, at three the large one wins by a quarter
// (scripts/torch_kernel_plans.py `GEMM_SWEEP`).
constexpr int kSmallWaves = 2;

// The launch plan from the shape and alignment: {plan, grid x, grid y,
// dynamic shared memory bytes}.  kernels/binary_gemm.py `gemm_plan` is
// its host twin.
extern "C" int binary_gemm_plan(int m, int n, int kw, int aligned, int sms,
                                int* out4) {
  if (m <= 0 || n <= 0 || kw < 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 16 && kw >= 64) {
    out4[0] = kSplitK;
    out4[1] = (n + 7) / 8;
    out4[2] = 1;
    out4[3] = 0;
    return 0;
  }
  const long long small_blocks =
      (long long)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (aligned && kw % 4 == 0 && n >= kLN &&
      small_blocks > (long long)kSmallWaves * sms) {
    const long long tiles =
        (long long)((m + kLM - 1) / kLM) * ((n + kLN - 1) / kLN);
    out4[0] = kLarge;
    out4[1] = (int)std::min<long long>(tiles, sms);
    out4[2] = 1;
    out4[3] = (int)kLSmem;
  } else {
    out4[0] = kTile32x128;
    out4[1] = (n + kBN - 1) / kBN;
    out4[2] = (m + kBM - 1) / kBM;
    out4[3] = 0;
  }
  return 0;
}

extern "C" int binary_gemm_hd_launch(const void* x, const void* w, void* out,
                                     int m, int n, int kw, void* stream) {
  const bool aligned = kw % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int dev = 0, sms = 0, plan[4];
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int perr = binary_gemm_plan(m, n, kw, aligned, sms, plan);
  if (perr) return perr;
  if (plan[2] > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(plan[1], plan[2]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  if (plan[0] == kSplitK) {
    binary_gemm_hd_split_k<<<grid, kSplitWarps * 32, 0, st>>>(xp, wp, op, m,
                                                              n, kw);
  } else if (plan[0] == kLarge) {
    CUtensorMap mx, mw;
    if (!rows_map(&mx, x, m, kw, kLKC, kLM) ||
        !rows_map(&mw, w, n, kw, kLKC, kLN))
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(binary_gemm_hd_large,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan[3]);
    if (err != cudaSuccess) return static_cast<int>(err);
    binary_gemm_hd_large<<<grid, kLThreads, plan[3], st>>>(mx, mw, op, m, n,
                                                           kw);
  } else {
    auto fn = aligned ? binary_gemm_hd_kernel<true>
                      : binary_gemm_hd_kernel<false>;
    fn<<<grid, kThreads, 0, st>>>(xp, wp, op, m, n, kw);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grouped_bitlinear_launch(const void* x, const void* offsets,
                                        const void* w, void* out, int s,
                                        int experts, int n, int kw,
                                        void* stream) {
  if (s <= 0 || n <= 0 || experts <= 0 || kw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // every run's rows start on 16 bytes where x's and w's bases do
  const bool aligned = kw % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long rows = (long long)(s + kBM - 1) / kBM + experts;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (unsigned)rows);
  auto fn = aligned ? grouped_bitlinear_kernel<true>
                    : grouped_bitlinear_kernel<false>;
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(offsets),
      static_cast<const uint32_t*>(w), static_cast<int32_t*>(out), experts, n,
      kw);
  return static_cast<int>(cudaGetLastError());
}
