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
// What bounds it on an H100: for the shared schedules, integer issue —
// the popcount distance (16 __popc per clock per SM) plus P compares per
// output; for the sampled form, reading the [B, C, P] float block from
// device memory, which is larger than both packed operands together.
//
// Design: kernel 1's 32 x 32 distance tile (picbnn.cuh `tile_hd`), then
// each thread votes its four outputs with `vote_count`, the same device
// function as the head stage of fused_mlp.cu.  The shared schedule sits in
// shared memory; one template instance per threshold form.
#include "picbnn.cuh"

using namespace picbnn;

template <int MODE>
__global__ void __launch_bounds__(kTileThreads)
cam_vote_kernel(const uint32_t* __restrict__ q,
                const uint32_t* __restrict__ rows,
                const uint32_t* __restrict__ thr,
                const float* __restrict__ samples, int32_t* __restrict__ out,
                int b, int c, int kw, int p) {
  __shared__ uint32_t xs[kTile][kKt + 1];
  __shared__ uint32_t ws[kTile][kKt + 1];
  __shared__ uint32_t thr_s[kMaxPasses];
  if (MODE != kThrSampled) load_thresholds(thr_s, thr, p);
  __syncthreads();
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int acc[4];
  tile_hd(q, rows, b, c, kw, m0, n0, xs, ws, acc);
  const int col = n0 + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + threadIdx.y + 8 * i;
    if (row < b && col < c) {
      const float* s =
          MODE == kThrSampled ? samples + ((size_t)row * c + col) * p : nullptr;
      out[(size_t)row * c + col] = vote_count<MODE>(acc[i], thr_s, s, p);
    }
  }
}

extern "C" int cam_vote_launch(const void* q, const void* rows, const void* thr,
                               const void* samples, void* out, int b, int c,
                               int kw, int p, int thr_mode, void* stream) {
  dim3 grid((c + kTile - 1) / kTile, (b + kTile - 1) / kTile);
  dim3 block(kTile, kTileThreads / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint32_t* rr = static_cast<const uint32_t*>(rows);
  const uint32_t* tt = static_cast<const uint32_t*>(thr);
  const float* ss = static_cast<const float*>(samples);
  int32_t* oo = static_cast<int32_t*>(out);
  switch (thr_mode) {
    case kThrInt:
      cam_vote_kernel<kThrInt><<<grid, block, 0, st>>>(qq, rr, tt, ss, oo, b, c, kw, p);
      break;
    case kThrFloat:
      cam_vote_kernel<kThrFloat><<<grid, block, 0, st>>>(qq, rr, tt, ss, oo, b, c, kw, p);
      break;
    case kThrSampled:
      cam_vote_kernel<kThrSampled><<<grid, block, 0, st>>>(qq, rr, tt, ss, oo, b, c, kw, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
