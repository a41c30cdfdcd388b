"""Tensor-core rates of `mma.sync` on the card, for the binary kernels.

    python3 scripts/torch_mma_probe.py

Times a loop of register-only `mma.sync` products per warp, for
    int8  m16n8k32.s32.s8.s8.s32            (4,096 MACs per instruction)
    b1    m16n8k256.s32.b1.b1.s32.and.popc  (32,768 bit-MACs per instruction)
on every SM, with 4 independent accumulator chains per warp, and prints
each rate in MACs per clock per SM (at nvidia-smi's max SM clock) beside
the card's name and power limit, and whether the SASS holds IMMA/BMMA.
It decides which tensor-core route kernels 1 and 4 take.  Needs nvcc and
one card; builds into build/mma_probe/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

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
"""


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
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out_dir / "probe.cu")], check=True)
    sass = _build.sass(so)
    lib = ctypes.CDLL(str(so))
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    clock = float(smi.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4096
    blocks = sms * 4
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": smi, "sms": sms}
    for name, b1, macs in (("int8_m16n8k32", 0, 16 * 8 * 32),
                           ("b1_and_m16n8k256", 1, 16 * 8 * 256)):
        for _ in range(2):
            assert lib.probe_launch(b1, out.data_ptr(), blocks, threads,
                                    iters, stream) == 0
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        assert lib.probe_launch(b1, out.data_ptr(), blocks, threads, iters,
                                stream) == 0
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e)
        total = blocks * threads // 32 * iters * 4 * macs
        per_clk_sm = total / (ms * 1e-3) / clock / sms
        res[name] = dict(ms=ms, macs_per_clk_sm=per_clk_sm,
                         tops=total / (ms * 1e-3) / 1e12)
        print(f"{name}: {ms:.3f} ms, {per_clk_sm:.0f} MACs/clk/SM, "
              f"{total / (ms * 1e-3) / 1e12:.1f} T(bit-)MAC/s")
    for op in ("IMMA", "BMMA", "POPC"):
        print(f"SASS {op}: {sum(op in ln for ln in sass.splitlines())} lines")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
