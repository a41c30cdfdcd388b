// The keyed sampler: per-request effective thresholds [P, S, B, n_rows]
// float32 straight from each row's uint32 key words, in one launch.
//
// Replaces no Pallas kernel.  The reference draws its silicon noise with
// `jax.random` in XLA; the port's keyed stream is its own (core/keys.py):
// Threefry-2x32 with 20 rounds keyed by a row's two words at counter
//     (sample, pass << 22 | row << 2 | stream),
// stream 0 for V_ref, 1 for the strobe jitter, 2 for the per-row offset
// (the pass-global draws at row 0), one standard normal per evaluation by
// Box-Muller in float64, then the threshold arithmetic of
// core/physics.py `combine_deltas` on the base schedule.  In plain PyTorch
// that is about 500 int64 / float64 elementwise operations a call, each a
// pass over [P, S, B, rows] in device memory, and the host's launches; this
// kernel keeps every intermediate in registers and writes only the float32
// result.  kernels/keyed_sampler.py keeps the plain composition as its twin.
//
// Exactness: the result equals the plain PyTorch path on the card bit for
// bit.  Threefry runs in uint32 registers (the plain path's int64 values
// masked to 32 bits are the same words).  Box-Muller takes libdevice's
// float64 `log`, `cos` and `sqrt`, as PyTorch's own float64 kernels do,
// then rounds to float32 (`__double2float_rn`).  The combine is written
// with `__fmul_rn` / `__fadd_rn` / `__frcp_rn` so that nvcc contracts no
// product into an FMA: each step rounds as PyTorch's separate elementwise
// kernels do, with the sigmas rounded to float32 on the host as PyTorch
// rounds a Python scalar against a float32 tensor.
//
// What bounds it on an H100: operations.  A call draws P*S*B*(n_rows + 2)
// normals (23.8 M at the benchmark's 33 x 1 x 32,768 x 20).  Each is about
// 80 32-bit ALU operations (20 rounds of add, funnel-shift, xor, and the
// key injections) and about 80 float64 operations (one log, cos and sqrt);
// at 64 lanes a clock an SM for each on 132 SMs at 1.98 GHz, about 0.11 ms
// each, on separate pipes.  The [P, S, B, n_rows] float32 output (86.5 MB
// there) takes 0.026 ms at 3.35 TB/s.
//
// Design: one thread owns one (pass, sample, row of the batch).  It draws
// its two pass-global normals once and keeps them in registers, as the
// partial sum dm_dvref * dv + m_logical * (1 / tj - 1), for all its rows,
// then draws its n_rows row normals: n_rows + 2 evaluations a thread,
// nothing re-read.  A block of 128 threads covers 128 consecutive rows of
// one (pass, sample) slice; it stages up to 32 rows of each thread in
// shared memory (stride 33 words, so neither the staging nor the read-back
// conflicts more than 2-way) and stores them back in flat order, so each
// warp writes whole lines of the slice's contiguous [B, n_rows] block.  The
// grid is one-dimensional, (pass, sample) slices times row blocks: 8,448
// blocks at the benchmark's shape, 64 an SM.  P, S, B and n_rows are
// arguments; any B (a partial last block) and any n_rows (in chunks of 32).
#include "picbnn.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowChunk = 32;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kStreamVref = 0, kStreamTjitter = 1, kStreamRow = 2;

struct Sigmas {  // float32, as PyTorch rounds the Python scalars
  float vref, tjitter, hd, drift;
};

#define TF_ROUND(r)              \
  x0 += x1;                      \
  x1 = __funnelshift_l(x1, x1, r); \
  x1 ^= x0;

// Threefry-2x32-20 at counter (c0, c1) under key (k0, k1), k2 the
// schedule's parity word, then Box-Muller in float64 rounded to float32.
__device__ __forceinline__ float keyed_normal(uint32_t k0, uint32_t k1,
                                              uint32_t k2, uint32_t c0,
                                              uint32_t c1) {
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  const double u1 = __dmul_rn(__dadd_rn(static_cast<double>(x0), 1.0),
                              0x1p-32);
  const double u2 = __dmul_rn(static_cast<double>(x1), 0x1p-32);
  const double radius = sqrt(__dmul_rn(-2.0, log(u1)));
  const double angle = cos(__dmul_rn(6.283185307179586, u2));
  return __double2float_rn(__dmul_rn(radius, angle));
}

#undef TF_ROUND

__global__ void __launch_bounds__(kThreads) keyed_thresholds_kernel(
    const int64_t* __restrict__ keys, const float* __restrict__ thr,
    const float* __restrict__ m_logical, const float* __restrict__ dm_dvref,
    Sigmas sg, int n_samples, int b_total, int n_rows, int row_blocks,
    float* __restrict__ out) {
  __shared__ float stage[kThreads * (kRowChunk + 1)];
  const int slice = blockIdx.x / row_blocks;  // pass * S + sample
  const int b0 = (blockIdx.x - slice * row_blocks) * kThreads;
  const int pass = slice / n_samples;
  const int nb = min(kThreads, b_total - b0);
  const int t = threadIdx.x;
  const bool live = t < nb;

  uint32_t k0 = 0, k1 = 0;
  if (live) {
    k0 = static_cast<uint32_t>(keys[2 * static_cast<size_t>(b0 + t)]);
    k1 = static_cast<uint32_t>(keys[2 * static_cast<size_t>(b0 + t) + 1]);
  }
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  const uint32_t c0 = static_cast<uint32_t>(slice - pass * n_samples);
  const uint32_t pass_word = static_cast<uint32_t>(pass) << 22;
  const float base = thr[pass];
  // the pass-global part: dm_dvref * dv + m_logical * (1 / max(tj, .5) - 1)
  float global = 0.0f;
  if (live) {
    const float dv = __fmul_rn(sg.vref,
                               keyed_normal(k0, k1, k2, c0,
                                            pass_word | kStreamVref));
    float tj = __fadd_rn(__fmul_rn(sg.tjitter,
                                   keyed_normal(k0, k1, k2, c0,
                                                pass_word | kStreamTjitter)),
                         1.0f);
    tj = tj != tj ? tj : fmaxf(tj, 0.5f);  // clamp keeps a NaN
    global = __fadd_rn(__fmul_rn(dm_dvref[pass], dv),
                       __fmul_rn(m_logical[pass],
                                 __fsub_rn(__frcp_rn(tj), 1.0f)));
  }

  float* dst = out + (static_cast<size_t>(slice) * b_total + b0) * n_rows;
  for (int c = 0; c < n_rows; c += kRowChunk) {
    const int rc = min(kRowChunk, n_rows - c);
    if (live) {
      for (int j = 0; j < rc; ++j) {
        const uint32_t c1 = pass_word |
                            (static_cast<uint32_t>(c + j) << 2) | kStreamRow;
        const float row = __fmul_rn(sg.hd, keyed_normal(k0, k1, k2, c0, c1));
        stage[t * (rc + 1) + j] =
            __fadd_rn(base, __fadd_rn(__fadd_rn(global, row), sg.drift));
      }
    }
    __syncthreads();
    // flat element e of this chunk is thread q = e / rc's row e - q * rc,
    // staged at q * (rc + 1) + (e - q * rc) = e + q
    for (int e = t; e < nb * rc; e += kThreads) {
      const int q = e / rc;
      dst[static_cast<size_t>(q) * n_rows + c + (e - q * rc)] = stage[e + q];
    }
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream`: keys [B, 2] int64 (the low 32 bits of each are the
// word), thr / m_logical / dm_dvref [P] float32, out [P, S, B, n_rows]
// float32, all contiguous on the card.  Returns a cudaError_t.
extern "C" int keyed_thresholds_launch(
    const void* keys, const void* thr, const void* m_logical,
    const void* dm_dvref, float sigma_vref, float sigma_tjitter,
    float sigma_hd, float drift, int p, int s, int b, int n_rows, void* out,
    void* stream) {
  if (p < 0 || s < 0 || b < 0 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0 || s == 0 || b == 0 || n_rows == 0) return 0;
  const long long row_blocks = (b + kThreads - 1) / kThreads;
  const long long blocks = row_blocks * p * s;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const Sigmas sg = {sigma_vref, sigma_tjitter, sigma_hd, drift};
  keyed_thresholds_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const float*>(thr),
      static_cast<const float*>(m_logical),
      static_cast<const float*>(dm_dvref), sg, s, b, n_rows,
      static_cast<int>(row_blocks), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
