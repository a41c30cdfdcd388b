"""Kernel 1's two copy paths, timed against each other on the card.

    python3 scripts/torch_gemm_paths.py

csrc/binary_gemm.cu has two instantiations: the general path (16-byte
granules at each row's offset, a fifth granule a row, words past Kw
masked) serves every Kw and pointer; the aligned path (four granules a
row at offset 0) serves Kw % 4 == 0 with 16-byte aligned bases.  This
script builds a copy of the source whose launcher always takes the
general path and times both libraries at the shapes `chip_smoke.py`
times kernel 1 (B = 4096), in the order built, forced, forced, built
(CUDA-graph replay), after checking each `torch.equal` to the plain
version.  Prints the card's name and power limit first and a JSON line
last.  Needs nvcc and one card; builds into build/gemm_paths/.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SELECT = "  const bool aligned = kw % 4 == 0 &&"
# (name, M, N, Kw) as chip_smoke.py times kernel 1
SHAPES = (("hg MLP", 4096, 128, 128), ("mnist MLP", 4096, 128, 25),
          ("hg CNN FC", 4096, 128, 225), ("mnist CNN FC", 4096, 128, 36))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemm_paths: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.kernels import _build, binary_gemm

    smi = nvidia_smi("name,power.limit")
    print(f"card: {smi}")
    src = (_build.CSRC / "binary_gemm.cu").read_text()
    if SELECT not in src:
        raise SystemExit("FAIL: the launcher's path selection moved")
    out = ROOT / "build" / "gemm_paths"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        if f.suffix == ".cuh":
            shutil.copy(f, out / f.name)
    cu = out / "general_only.cu"
    cu.write_text(src.replace(SELECT, "  const bool aligned = false &&"))
    so = out / "general_only.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.STDOUT)
    forced = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES["binary_gemm"].items():
        getattr(forced, fn).argtypes = argtypes
        getattr(forced, fn).restype = ctypes.c_int
    forced.picbnn_error_string.argtypes = [ctypes.c_int]
    forced.picbnn_error_string.restype = ctypes.c_char_p
    built = _build.library("binary_gemm")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"card": smi}
    for name, m, n, kw in SHAPES:
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, kw), dtype=torch.int32,
                          device=dev, generator=gen)
        w = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, kw), dtype=torch.int32,
                          device=dev, generator=gen)
        want = binary_gemm.binary_gemm_hd_plain(x, w)
        times = {"built": [], "general only": []}
        for key, lib in (("built", built), ("general only", forced),
                         ("general only", forced), ("built", built)):
            _build._libs["binary_gemm"] = lib
            if not torch.equal(binary_gemm.binary_gemm_hd(x, w), want):
                raise SystemExit(f"FAIL: {key} != plain at {name}")
            times[key].append(device_ms(
                lambda: binary_gemm.binary_gemm_hd(x, w), iters=100,
                replays=10))
        _build._libs["binary_gemm"] = built
        res[name] = dict(shape=f"x[{m},{kw}] w[{n},{kw}]", **times)
        print(f"  {name:12s} x[{m},{kw}] w[{n},{kw}]: built "
              + ", ".join(f"{t:.5f}" for t in times["built"])
              + " ms; general only "
              + ", ".join(f"{t:.5f}" for t in times["general only"]) + " ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
