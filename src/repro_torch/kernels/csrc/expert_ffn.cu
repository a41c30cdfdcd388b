// The elementwise steps around kernel 1's grouped entry in the dropless
// BitLinear MoE (models/binary_lm.py `grouped_bitlinear_ffn`), each one
// pass over the grouped entry's int32 distances in place of the dozen
// PyTorch passes and int64 packing temporaries they took:
//
// - expert_swiglu_signs_kernel: from the gate and up distances of the
//   sorted slots [S, 2F] (gate columns first), each slot's gate and up
//   values bf16((K - 2 HD) * alpha[expert] * beta[slot]), the SwiGLU
//   act = bf16(bf16(silu(gate)) * up), and from it the down projection's
//   operands: act's sign bits packed little-endian into [S, F/32] words
//   (act >= 0 -> 1, the padding bits 0) and beta = bf16(mean |act|).
// - expert_combine_kernel: from the down distances [S, D], each slot's
//   output bf16((F - 2 HD) * alpha[expert] * beta[slot]) and each token's
//   gate-weighted sum over its k slots, in float32 and in slot order,
//   rounded to bfloat16: the MoE's output [T, D] in token order.
//
// Exactness: kernels/expert_ffn.py keeps the plain PyTorch composition as
// the twin.  Every product and sum is written with __fmul_rn / __fadd_rn
// so that nvcc contracts nothing into an FMA, rounding as PyTorch's
// separate float32 kernels round; silu is x / (1 + expf(-x)), PyTorch's
// own float formula, and bfloat16 rounds to nearest even.  The sign bits
// and the combined output equal the twin's bit for bit; beta's float32
// sum runs in another order than PyTorch's reduction, so it may differ in
// its last bfloat16 bit.
//
// What bounds them on an H100: bytes.  At the LM cell (S = 16,384 slots,
// F = 1,792, D = 2,048) the first reads 235 MB of distances and writes
// 3.7 MB, the second reads 134 MB and writes 17 MB: 70 and 45 us at
// 3.35 TB/s.  One block of 256 threads a slot (a token): its warps walk
// 32-column words, so each word's signs are one __ballot_sync and every
// read is a coalesced 128-byte line.
#include <cuda_bf16.h>

#include "picbnn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16((k_in - 2 hd) * alpha * beta), as float
__device__ __forceinline__ float scaled(int k_in, int hd, __nv_bfloat16 alpha,
                                        float beta) {
  return bf16_round(__fmul_rn(
      __fmul_rn(static_cast<float>(k_in - 2 * hd), __bfloat162float(alpha)),
      beta));
}

__global__ void __launch_bounds__(kThreads)
expert_swiglu_signs_kernel(const int32_t* __restrict__ hd,
                           const __nv_bfloat16* __restrict__ alpha,
                           const __nv_bfloat16* __restrict__ beta,
                           const int32_t* __restrict__ expert, int f, int fw,
                           int k_in, uint32_t* __restrict__ bits,
                           __nv_bfloat16* __restrict__ beta_out) {
  __shared__ float part[kWarps];
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* h = hd + static_cast<size_t>(row) * 2 * f;
  const __nv_bfloat16* a = alpha + static_cast<size_t>(expert[row]) * 2 * f;
  const float b = __bfloat162float(beta[row]);
  float sum = 0.f;
  for (int w = warp; w < fw; w += kWarps) {  // warp-uniform: the ballot
    const int c = 32 * w + lane;
    bool positive = false;
    if (c < f) {
      const float g = scaled(k_in, h[c], a[c], b);
      const float u = scaled(k_in, h[f + c], a[f + c], b);
      const float act = bf16_round(__fmul_rn(bf16_round(g / (1.0f + expf(-g))),
                                             u));
      positive = act >= 0.f;
      sum = __fadd_rn(sum, fabsf(act));
    }
    const unsigned word = __ballot_sync(0xffffffffu, positive);
    if (lane == 0) bits[static_cast<size_t>(row) * fw + w] = word;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total = __fadd_rn(total, part[i]);
    beta_out[row] = __float2bfloat16_rn(__fmul_rn(total, 1.0f / f));
  }
}

__global__ void __launch_bounds__(kThreads)
expert_combine_kernel(const int32_t* __restrict__ hd,
                      const __nv_bfloat16* __restrict__ alpha,
                      const __nv_bfloat16* __restrict__ beta,
                      const int32_t* __restrict__ expert,
                      const int64_t* __restrict__ back,
                      const float* __restrict__ gate, int n, int k, int k_in,
                      __nv_bfloat16* __restrict__ y) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int64_t s = back[static_cast<size_t>(t) * k + j];
      const float v = scaled(k_in, hd[s * n + c],
                             alpha[static_cast<size_t>(expert[s]) * n + c],
                             __bfloat162float(beta[s]));
      const float p = __fmul_rn(v, gate[static_cast<size_t>(t) * k + j]);
      acc = j == 0 ? p : __fadd_rn(acc, p);
    }
    y[static_cast<size_t>(t) * n + c] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

// hd [s, 2f] int32, alpha [e, 2f] bf16, beta [s] bf16, expert [s] int32
// -> bits [s, fw] int32 words, beta_out [s] bf16; contiguous, on `stream`.
extern "C" int expert_swiglu_signs_launch(const void* hd, const void* alpha,
                                          const void* beta, const void* expert,
                                          int s, int f, int k_in, void* bits,
                                          void* beta_out, void* stream) {
  if (s < 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return 0;
  const int fw = (f + 31) / 32;
  expert_swiglu_signs_kernel<<<s, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hd),
      static_cast<const __nv_bfloat16*>(alpha),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const int32_t*>(expert), f, fw, k_in,
      static_cast<uint32_t*>(bits), static_cast<__nv_bfloat16*>(beta_out));
  return static_cast<int>(cudaGetLastError());
}

// hd [s, n] int32, alpha [e, n] bf16, beta [s] bf16, expert [s] int32,
// back [t * k] int64, gate [t, k] float32 -> y [t, n] bf16.
extern "C" int expert_combine_launch(const void* hd, const void* alpha,
                                     const void* beta, const void* expert,
                                     const void* back, const void* gate, int t,
                                     int n, int k, int k_in, void* y,
                                     void* stream) {
  if (t < 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return 0;
  expert_combine_kernel<<<t, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hd),
      static_cast<const __nv_bfloat16*>(alpha),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const int32_t*>(expert), static_cast<const int64_t*>(back),
      static_cast<const float*>(gate), n, k, k_in,
      static_cast<__nv_bfloat16*>(y));
  return static_cast<int>(cudaGetLastError());
}
