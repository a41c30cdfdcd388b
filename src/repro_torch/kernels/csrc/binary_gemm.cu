// Kernel 1: pairwise Hamming distances between packed rows.
//
// Replaces the Pallas kernel `binary_gemm_hd` (`_binary_gemm_kernel`) in
// src/repro/kernels/binary_gemm.py:
//     out[m, n] = sum_k popcount(x[m, k] ^ w[n, k])     x [M, Kw], w [N, Kw]
//
// What bounds it on an H100: the 1-bit tensor cores or bytes, whichever
// is larger.  Each output takes 2*32*Kw bit-MACs on `mma.sync .b1
// .and.popc` (HD = popc(x & ~w) + popc(~x & w), bmma.cuh), issued at
// 19,044 bit-MACs per clock per SM (scripts/torch_mma_probe.py), 8x the
// bits of int8 `mma.sync`; the __popc pipe that bounded the earlier
// design does 16 words (512 bits) per clock per SM.  At the main path's
// shapes the products take 1-2 us and reading x takes 0.1-1.1 us, so the
// kernel sits near launch latency.
//
// Design: a block of 8 warps owns a 32 x 128 output tile (N = 128 is
// every FC width on the main path; 128 blocks cover M = 4096).  K is
// streamed in 16-word chunks through a 3-stage ring of cp.async copies,
// so loads overlap the products.  Every copy is an aligned 16-byte
// granule whatever Kw is: where Kw % 4 != 0 (HG CNN FC rows are 225
// words) a row's chunk lands up to 3 words into its 20-word shared row,
// and words past Kw are masked as they are read.  Where Kw % 4 == 0 and
// both bases sit on 16 bytes, a second instantiation copies four
// granules a row at offset 0, the ones past Kw zero: it is the faster
// of the two at the main path's aligned shapes (HG MLP, CNN FC Kw = 36;
// scripts/torch_gemm_paths.py times both).  Rows 20 words apart (4 mod
// 8) put a warp's fragment loads (rows g, words t / t+4) on distinct
// banks where the rows share an offset.  Warp w computes
// the 32 x 16 sub-tile at columns 16w: two m16 x two n8 tiles, each K
// step of 256 bits two `.and.popc` products.  Ragged M and N are
// zero-filled by the copies (zero words add nothing to a distance) and
// masked on the store.
#include "bmma.cuh"
#include "picbnn.cuh"

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

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
binary_gemm_hd_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ w, int32_t* __restrict__ out,
                      int m, int n, int kw) {
  __shared__ __align__(16) uint32_t xs[kStages][kBM][kLd];
  __shared__ __align__(16) uint32_t ws[kStages][kBN][kLd];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
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

extern "C" int binary_gemm_hd_launch(const void* x, const void* w, void* out,
                                     int m, int n, int kw, void* stream) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const bool aligned = kw % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto fn = aligned ? binary_gemm_hd_kernel<true> : binary_gemm_hd_kernel<false>;
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int32_t*>(out), m, n, kw);
  return static_cast<int>(cudaGetLastError());
}
