"""Tensor-core rates of `mma.sync` and `wgmma` on the card, for the binary
kernels.

    python3 scripts/torch_mma_probe.py

Times a loop of tensor-core products on every SM and prints each rate in
MACs per clock per SM (at nvidia-smi's max SM clock) beside the card's
name and power limit:
    int8   mma.sync m16n8k32.s32.s8.s8.s32             (4,096 MACs each)
    b1     mma.sync m16n8k256.s32.b1.b1.s32.and.popc   (32,768 bit-MACs)
    wgmma  m64n128k256.s32.b1.b1.and.popc and m64n256k256 (2,097,152 and
           4,194,304 bit-MACs an instruction, both operands in shared
           memory, a warpgroup of four warps issuing together)
`mma.sync` runs register-only loops, 4 independent accumulator chains a
warp; `wgmma` runs two warpgroups a block, eight products a commit group.
Then it checks the `wgmma .b1` operand layout that kernel 1's large tile
uses, the 128-byte swizzle of its TMA boxes (K-major rows of 128 bytes,
a row's 16-byte units permuted by the row's index mod 8, K steps 32
bytes apart, 8-row atoms of 1 KB), against the popcount of the AND on
the host.  The rate loops read a planar layout (no swizzle: two 16-byte
core matrices a row per K step), whose contents do not matter there.  It decides which tensor-core route kernels 1 and 4
take and how kernel 1's large tile lays out its operands.  Needs nvcc
and one card; builds into build/mma_probe/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

WGMMA_NS = (128, 256)


def wgmma_fn(n: int) -> str:
    """`wgmma_b1` on d[n / 2]: one `wgmma ... m64n{n}k256 .b1 .and.popc`
    from two shared-memory descriptors."""
    regs = n // 2
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(regs))
    lst = ", ".join(f"%{i}" for i in range(regs))
    return f"""
__device__ __forceinline__ void wgmma_b1(int (&d)[{regs}], uint64_t da,
                                         uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k256.s32.b1.b1.and.popc "
      "{{{lst}}}, %{regs}, %{regs + 1}, p;\\n}}\\n"
      : {outs}
      : "l"(da), "l"(db), "r"(1));
}}
"""


SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int B1>
__global__ void mma_loop(int* out, int iters) {
  uint32_t a0 = threadIdx.x * 2654435761u, a1 = a0 * 3u, a2 = a0 * 5u,
           a3 = a0 * 7u, b0 = a0 * 11u, b1 = a0 * 13u;
  int c[4][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (B1)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe_launch(int b1, void* out, int blocks, int threads,
                            int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b1) mma_loop<1><<<blocks, threads, 0, st>>>((int*)out, iters);
  else mma_loop<0><<<blocks, threads, 0, st>>>((int*)out, iters);
  return (int)cudaGetLastError();
}

// A shared-memory matrix descriptor, no swizzle: start address, the
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching the accumulators before the wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

WGMMA_FNS

// The rate: each warpgroup of the block issues 8 products a commit
// group, `iters` groups, on its own 64-row A and the block's shared B.
template <int N>
__global__ void __launch_bounds__(256) wgmma_loop(int* out, int iters) {
  __shared__ __align__(128) uint32_t a_s[2][64 * 8];
  __shared__ __align__(128) uint32_t b_s[N * 8];
  for (int i = threadIdx.x; i < 2 * 64 * 8; i += blockDim.x)
    (&a_s[0][0])[i] = i * 2654435761u;
  for (int i = threadIdx.x; i < N * 8; i += blockDim.x)
    b_s[i] = i * 40503u;
  fence_async_smem();
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da = smem_desc(a_s[wg], 64 * 16, 128);
  const uint64_t db = smem_desc(b_s, N * 16, 128);
  int d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    fence_regs(d);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wgmma_b1(d, da, db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(d);
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int wgmma_launch(int n, void* out, int blocks, int iters,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 128) wgmma_loop<128><<<blocks, 256, 0, st>>>((int*)out, iters);
  else wgmma_loop<256><<<blocks, 256, 0, st>>>((int*)out, iters);
  return (int)cudaGetLastError();
}

// The operand layout check: the 128-byte swizzle that kernel 1's large
// tile reads its TMA boxes in, a [64, 32] and b [N, 32] words (four K
// steps),
// row r at byte 128 r, its 16-byte unit u at unit u ^ (r % 8), K step s
// read from a descriptor starting 32 s bytes in (leading byte offset
// unused, stride byte offset 1 KB between 8-row atoms).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int N>
__global__ void __launch_bounds__(128) wgmma_check_sw128(const uint32_t* a,
                                                         const uint32_t* b,
                                                         int* out) {
  __shared__ __align__(1024) uint32_t a_s[64 * 32];
  __shared__ __align__(1024) uint32_t b_s[N * 32];
  for (int i = threadIdx.x; i < 64 * 32; i += 128) {
    const int r = i / 32, w = i % 32;
    a_s[r * 32 + ((w / 4) ^ (r % 8)) * 4 + w % 4] = a[i];
  }
  for (int i = threadIdx.x; i < N * 32; i += 128) {
    const int r = i / 32, w = i % 32;
    b_s[r * 32 + ((w / 4) ^ (r % 8)) * 4 + w % 4] = b[i];
  }
  fence_async_smem();
  __syncthreads();
  int d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  fence_regs(d);
  wg_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_b1(d, sw128_desc(reinterpret_cast<const char*>(a_s) + 32 * s),
             sw128_desc(reinterpret_cast<const char*>(b_s) + 32 * s));
  wg_commit();
  wg_wait0();
  fence_regs(d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      out[row * N + col] = d[4 * j + e];
    }
}

extern "C" int check_sw128_launch(int n, const void* a, const void* b,
                                  void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 128)
    wgmma_check_sw128<128><<<1, 128, 0, st>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int*)out);
  else
    wgmma_check_sw128<256><<<1, 128, 0, st>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int*)out);
  return (int)cudaGetLastError();
}

""".replace("WGMMA_FNS", "".join(wgmma_fn(n) for n in WGMMA_NS))


def timed(launch, reps: int = 2) -> float:
    """Milliseconds of one launch (CUDA events), after `reps` warm-ups."""
    for _ in range(reps):
        assert launch() == 0
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    assert launch() == 0
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build

    out_dir = Path(__file__).resolve().parents[1] / "build" / "mma_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "probe.cu").write_text(SRC)
    so = out_dir / "probe.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                            str(so), str(out_dir / "probe.cu")],
                           capture_output=True, text=True)
    print(built.stdout + built.stderr)
    built.check_returncode()
    sass = _build.sass(so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_launch.argtypes = [ci, vp, ci, ci, ci, vp]
    lib.wgmma_launch.argtypes = [ci, vp, ci, ci, vp]
    lib.check_sw128_launch.argtypes = [ci, vp, vp, vp, vp]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    clock = float(smi.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": smi, "sms": sms}

    def rate(name, ms, total):
        per_clk_sm = total / (ms * 1e-3) / clock / sms
        res[name] = dict(ms=ms, macs_per_clk_sm=per_clk_sm,
                         tops=total / (ms * 1e-3) / 1e12)
        print(f"{name}: {ms:.3f} ms, {per_clk_sm:.0f} MACs/clk/SM, "
              f"{total / (ms * 1e-3) / 1e12:.1f} T(bit-)MAC/s")

    threads, iters = 256, 4096
    blocks = sms * 4
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    for name, b1, macs in (("int8_m16n8k32", 0, 16 * 8 * 32),
                           ("b1_and_m16n8k256", 1, 16 * 8 * 256)):
        ms = timed(lambda: lib.probe_launch(b1, out.data_ptr(), blocks,
                                            threads, iters, stream))
        rate(name, ms, blocks * threads // 32 * iters * 4 * macs)
    w_iters, w_blocks = 1024, sms * 2
    for n in WGMMA_NS:
        ms = timed(lambda: lib.wgmma_launch(n, out.data_ptr(), w_blocks,
                                            w_iters, stream))
        rate(f"wgmma_b1_and_m64n{n}k256", ms,
             w_blocks * 2 * w_iters * 8 * 64 * n * 256)

    # the operand layout of kernel 1's large tile: 128-byte swizzled
    rng = np.random.default_rng(0)
    res["layout"] = {}
    for name, fn, kw in (("sw128", lib.check_sw128_launch, 32),):
        for n in WGMMA_NS:
            a = rng.integers(0, 2 ** 32, (64, kw),
                             dtype=np.uint64).astype(np.uint32)
            b = rng.integers(0, 2 ** 32, (n, kw),
                             dtype=np.uint64).astype(np.uint32)
            want = np.zeros((64, n), np.int64)
            for k in range(kw):
                v = a[:, None, k] & b[None, :, k]
                want += np.unpackbits(v.view(np.uint8).reshape(64, n, 4),
                                      axis=-1).sum(-1, dtype=np.int64)
            at = torch.from_numpy(a.view(np.int32)).cuda()
            bt = torch.from_numpy(b.view(np.int32)).cuda()
            got = torch.full((64, n), -1, dtype=torch.int32, device="cuda")
            assert fn(n, at.data_ptr(), bt.data_ptr(), got.data_ptr(),
                      stream) == 0
            torch.cuda.synchronize()
            g = got.cpu().numpy()
            ok = bool(np.array_equal(g, want))
            res["layout"][f"{name}_n{n}"] = dict(
                equal=ok, mismatches=int((g != want).sum()))
            print(f"layout {name} m64n{n}k256: equal {ok} "
                  f"({int((g != want).sum())} of {g.size} differ)")
    for op in ("IMMA", "BMMA", "POPC", "HGMMA", "IGMMA", "BGMMA"):
        print(f"SASS {op}: {sum(op in ln for ln in sass.splitlines())} lines")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
