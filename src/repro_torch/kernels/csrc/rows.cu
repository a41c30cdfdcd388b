// Row-wise passes of the LM's bfloat16 activations, one launch each in
// place of PyTorch's chains of elementwise kernels (each a pass over the
// rows and a launch the host has to issue):
//
// - rms_norm_rows_kernel: y = bf16(x * rsqrt(mean(x^2) + eps) * scale),
//   the port's RMS norm (models/layers.py `apply_norm`, `_head_norm`) in
//   float32 on each row of x [R, D].
// - sign_rows_kernel: a BitLinear input's operands, the row's sign bits
//   packed little-endian into [R, D/32] words (x >= 0 -> 1, padding bits
//   0, as core/binarize.py `pack_bits` packs them) and beta = bf16(mean
//   |x|).
//
// Exactness: kernels/rows.py keeps the plain PyTorch compositions as the
// twins.  Products and sums are __fmul_rn / __fadd_rn (nothing contracted
// into an FMA), the mean a sum times 1/D as PyTorch's, rsqrt `rsqrtf` as
// PyTorch's float kernel; only the float32 sum runs in another order, so
// a norm's output or a beta may differ from the twin's in its last
// bfloat16 bit.  The sign bits are equal.
//
// One warp a row, eight rows a block: the warp reads its row in 32-element
// strides (coalesced), sums with shuffles, then writes.  Bound by bytes:
// at the LM cell a [4,096, 2,048] norm reads and writes 33.6 MB, 10 us at
// 3.35 TB/s.
#include <cuda_bf16.h>

#include "picbnn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
rms_norm_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ scale, long long rows,
                     int d, float eps, __nv_bfloat16* __restrict__ y) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const __nv_bfloat16* xr = x + row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = __bfloat162float(xr[c]);
    sum = __fadd_rn(sum, __fmul_rn(v, v));
  }
  const float r =
      rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sum), 1.0f / d), eps));
  __nv_bfloat16* yr = y + row * d;
  for (int c = lane; c < d; c += 32)
    yr[c] = __float2bfloat16_rn(__fmul_rn(
        __fmul_rn(__bfloat162float(xr[c]), r), __bfloat162float(scale[c])));
}

__global__ void __launch_bounds__(kThreads)
sign_rows_kernel(const __nv_bfloat16* __restrict__ x, long long rows, int d,
                 int dw, uint32_t* __restrict__ bits,
                 __nv_bfloat16* __restrict__ beta) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const __nv_bfloat16* xr = x + row * d;
  float sum = 0.f;
  for (int w = 0; w < dw; ++w) {
    const int c = 32 * w + lane;
    bool positive = false;
    if (c < d) {
      const float v = __bfloat162float(xr[c]);
      positive = v >= 0.f;
      sum = __fadd_rn(sum, fabsf(v));
    }
    const unsigned word = __ballot_sync(0xffffffffu, positive);
    if (lane == 0) bits[row * dw + w] = word;
  }
  sum = warp_sum(sum);
  if (lane == 0) beta[row] = __float2bfloat16_rn(__fmul_rn(sum, 1.0f / d));
}

unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// x [rows, d] bf16, scale [d] bf16 -> y [rows, d] bf16; contiguous.
extern "C" int rms_norm_rows_launch(const void* x, const void* scale,
                                    long long rows, int d, float eps, void* y,
                                    void* stream) {
  if (rows < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  rms_norm_rows_kernel<<<blocks_for(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(scale), rows, d, eps,
      static_cast<__nv_bfloat16*>(y));
  return static_cast<int>(cudaGetLastError());
}

// x [rows, d] bf16 -> bits [rows, ceil(d / 32)] int32 words, beta [rows]
// bf16; contiguous.
extern "C" int sign_rows_launch(const void* x, long long rows, int d,
                                void* bits, void* beta, void* stream) {
  if (rows < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  sign_rows_kernel<<<blocks_for(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), rows, d, (d + 31) / 32,
      static_cast<uint32_t*>(bits), static_cast<__nv_bfloat16*>(beta));
  return static_cast<int>(cudaGetLastError());
}
