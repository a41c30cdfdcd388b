// Input packing: the float32 rows of `CompiledPipeline.run` to the packed
// int32 words its kernels read, in one pass over the rows.
//
// Replaces no Pallas kernel: the reference packs its inputs in XLA
// (repro/core/binarize.py `pack_pm1`, `InputEncoding.pack`).  The port's
// plain versions of the same functions are chains of PyTorch elementwise
// operations, each a pass over device memory: `pack_pm1` widens the bits
// to an int64 [B, n / 32, 32] tensor (1 GB at B = 32,768, n = 4,096)
// before it sums them; the thermometer code runs a compare, a cast, a
// shift and an OR over every pixel for each level, then a stack.  They
// stay the twins (kernels/pack_input.py) and the tests' oracle.
//
// Two entries, one rule: each output word is an OR of up to 32 float32
// comparisons of the input against a constant.
//
// - sign_pack: ±1 rows x [B, n] -> words [B, ceil(n / 32)].  Bit i of
//   word j is x[r, 32 j + i] > 0, so 0.0, -0.0 and NaN give 0 (as
//   binarize.to_bits); the padding bits of the tail word are 0.
// - threshold_pack: pixels x [B, P] -> words [B, P, Cw], Cw =
//   ceil(width / 32).  Bit t of pixel p's word w is
//   x[p] >= level(32 w + t) (NaN gives 0), compared as float32 just as
//   PyTorch compares them.  The levels are made here: 0.5 for the sign
//   encoding, else (t + 1) / (width + 1) divided in float32 and rounded
//   to nearest (__fdiv_rn), the IEEE division numpy makes in
//   binarize.thermometer_thresholds, so each level is the same float.
//
// Words leave as the bit pattern of little-endian uint32 words in int32
// tensors, bit 31 included.  nvcc's defaults keep denormals (no
// flush to zero), so a positive denormal is > 0 here as on the host.
//
// What bounds it on an H100: bytes.  At [32,768, 4,096] the float32 rows
// are 537 MB read; the sign words are 16.8 MB (0.165 ms at 3.35 TB/s),
// the thermometer-4 words 537 MB, one word a pixel (0.320 ms).  A float
// costs a few ALU operations, far below the card's rate.
//
// Design: loads streamed past L1 (`__ldcs`: each byte is read once), with
// several independent loads issued by each thread before any is used, so
// enough bytes are in flight to keep HBM busy.
//
// - sign_pack (any n, any alignment): the words are numbered flat, task
//   t = row * kw + j, so task t's word is out[t].  A warp a task, one
//   float a lane: a warp's load is 128 contiguous bytes, and
//   `__ballot_sync` forms the word.  Each warp takes kBallotUnroll
//   consecutive tasks, loads them all, then lane u stores task u's word,
//   so the stores are coalesced too.  (A 16-byte-load variant, a nibble a
//   lane and XOR shuffles, ran no faster at the cells' shape.)
// - threshold_pack: a thread owns groups of 4 consecutive pixels (one float4
//   load where x is 16-byte aligned), kThrUnroll groups in flight.  Each
//   level is made where it is compared, one division (the ALU has room: the
//   pass is bound by its bytes).  With one word a pixel (width <= 32) the 4
//   words go out as one 16-byte store; with more, a pixel's Cw words are
//   stored one by one.
//
// The sign entries index words in 32 bits: the launcher cuts the rows
// into launches of fewer than 2^31 words.  Element offsets are 64-bit.
#include "picbnn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBallotUnroll = 8;  // tasks a warp in the sign pack
constexpr int kThrUnroll = 2;     // 4-pixel groups a thread
constexpr unsigned kFull = 0xffffffffu;

// x as [rows, n] float, any n and alignment; tasks = rows * kw words.
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const float* __restrict__ x, unsigned tasks, int kw, int n,
                 uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned base =
      (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kBallotUnroll;
  float v[kBallotUnroll];
#pragma unroll
  for (int u = 0; u < kBallotUnroll; ++u) {
    const unsigned t = base + u;
    const unsigned row = t / kw;
    const int c = 32 * static_cast<int>(t - row * kw) + lane;
    v[u] = 0.f;
    if (t < tasks && c < n)
      v[u] = __ldcs(x + static_cast<long long>(row) * n + c);
  }
  uint32_t mine = 0;
#pragma unroll
  for (int u = 0; u < kBallotUnroll; ++u) {
    const uint32_t w = __ballot_sync(kFull, v[u] > 0.f);
    if (lane == u) mine = w;
  }
  if (lane < kBallotUnroll && base + lane < tasks) out[base + lane] = mine;
}

// Level t of a code of `width` levels (binarize.thermometer_thresholds,
// or 0.5 for the sign code).
__device__ __forceinline__ float level(int sign, int t, int width) {
  return sign ? 0.5f
              : __fdiv_rn(static_cast<float>(t + 1),
                          static_cast<float>(width + 1));
}

// The word w of one pixel: bits t of level(32 w + t), t < 32.
__device__ __forceinline__ uint32_t level_word(float v, int sign, int width,
                                              int w) {
  const int t0 = 32 * w, nt = min(32, width - t0);
  uint32_t word = 0;
  for (int t = 0; t < nt; ++t)
    word |= static_cast<uint32_t>(v >= level(sign, t0 + t, width)) << t;
  return word;
}

// x [pixels] float (flat), out [pixels, cw] words.  vec: x is 16-byte
// aligned (out always is: a fresh allocation).
__global__ void __launch_bounds__(kThreads)
threshold_pack_kernel(const float* __restrict__ x, long long pixels,
                      int sign, int width, int cw, int vec,
                      uint32_t* __restrict__ out) {
  const long long g0 =
      static_cast<long long>(blockIdx.x) * kThreads * kThrUnroll +
      threadIdx.x;
  float v[kThrUnroll][4];
#pragma unroll
  for (int u = 0; u < kThrUnroll; ++u) {
    const long long e = 4 * (g0 + static_cast<long long>(u) * kThreads);
    if (vec && e + 4 <= pixels) {
      const float4 f = __ldcs(reinterpret_cast<const float4*>(x + e));
      v[u][0] = f.x, v[u][1] = f.y, v[u][2] = f.z, v[u][3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[u][k] = e + k < pixels ? x[e + k] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kThrUnroll; ++u) {
    const long long e = 4 * (g0 + static_cast<long long>(u) * kThreads);
    if (e >= pixels) continue;
    if (cw == 1) {  // one word a pixel (width <= 32)
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int t = 0; t < width; ++t) {
        const float lt = level(sign, t, width);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] |= static_cast<uint32_t>(v[u][k] >= lt) << t;
      }
      if (e + 4 <= pixels) {
        *reinterpret_cast<uint4*>(out + e) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int k = 0; e + k < pixels; ++k) out[e + k] = w[k];
      }
    } else {
      for (int k = 0; k < 4 && e + k < pixels; ++k)
        for (int w = 0; w < cw; ++w)
          out[(e + k) * cw + w] = level_word(v[u][k], sign, width, w);
    }
  }
}

}  // namespace

// x [rows, n] float32 -> out [rows, ceil(n / 32)] int32 words; both
// contiguous on the card.  Returns a cudaError_t.
extern "C" int sign_pack_launch(const void* x, long long rows, int n,
                                void* out, void* stream) {
  if (rows < 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kw = (n + 31) / 32;
  const auto s = static_cast<cudaStream_t>(stream);
  // rows a launch: fewer than 2^31 words, so a word's index fits 32 bits
  const long long step = 0x7FFFFFFFLL / kw;
  for (long long r0 = 0; r0 < rows; r0 += step) {
    const long long r = rows - r0 < step ? rows - r0 : step;
    const unsigned tasks = static_cast<unsigned>(r * kw);
    const float* xr = static_cast<const float*>(x) + r0 * n;
    uint32_t* o = static_cast<uint32_t*>(out) + r0 * kw;
    const unsigned per_block = kWarps * kBallotUnroll;
    sign_pack_kernel<<<(tasks + per_block - 1) / per_block, kThreads, 0,
                       s>>>(xr, tasks, kw, n, o);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// x [pixels] float32 -> out [pixels, ceil(width / 32)] int32 words, both
// contiguous on the card; sign 1 for the sign code (width 1), 0 for a
// thermometer.  Returns a cudaError_t.
extern "C" int threshold_pack_launch(const void* x, long long pixels,
                                     int sign, int width, void* out,
                                     void* stream) {
  if (pixels < 0 || width <= 0 || width >= 1 << 24 || (sign && width != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return 0;
  const long long per_block = 4LL * kThreads * kThrUnroll;
  const long long blocks = (pixels + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(x) % sizeof(float4) == 0;
  threshold_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), pixels, sign, width, (width + 31) / 32,
      vec, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
