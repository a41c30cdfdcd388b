"""Where kernel 4's time goes, phase by phase, on the card.

    python3 scripts/torch_conv_phases.py

Builds copies of csrc/fused_conv.cu whose conv loop stops after L layers
(L = 0: the input load and compaction alone; L = 1: plus conv 1; ...),
and times `conv_stage_packed` (CUDA-graph replay) with each at the
paper's CNNs, B = 4096, beside the full kernel and its votes entry.  The
cut copies compute wrong maps; only their times are read.  Differences
between consecutive rows are the phases' device times.  Prints the
card's name and power limit first and a JSON line last.  Needs nvcc and
one card; builds into build/conv_phases/.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ANCHOR = "  for (int l = 0; l < net.n_conv; ++l) {\n    const ConvLayer& L = net.conv[l];\n    const bool last"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_conv_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.configs.paper_cnn import HG_CNN, MNIST_CNN, build_cnn_pipeline
    from repro_torch.core import convnet
    from repro_torch.kernels import _build, fused_conv

    smi = nvidia_smi("name,power.limit")
    print(f"card: {smi}")
    src = (_build.CSRC / "fused_conv.cu").read_text()
    if ANCHOR not in src:
        raise SystemExit("FAIL: the conv loop of fused_conv.cu moved")
    out = ROOT / "build" / "conv_phases"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        if f.suffix == ".cuh":
            shutil.copy(f, out / f.name)
    libs, procs = {}, {}
    for cut in (0, 1):
        cu = out / f"cut{cut}.cu"
        cu.write_text(src.replace(ANCHOR, ANCHOR.replace(
            "l < net.n_conv", f"l < min(net.n_conv, {cut})")))
        procs[cut] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"cut{cut}.so"), str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    for cut, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"FAIL: nvcc of cut {cut}")
        lib = ctypes.CDLL(str(out / f"cut{cut}.so"))
        for fn, argtypes in _build._SIGNATURES["fused_conv"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.picbnn_error_string.argtypes = [ctypes.c_int]
        lib.picbnn_error_string.restype = ctypes.c_char_p
        libs[cut] = lib
    full = _build.library("fused_conv")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    res = {"card": smi}
    for mid, cfg in (("mnist_cnn", MNIST_CNN), ("hg_cnn", HG_CNN)):
        pipe = build_cnn_pipeline(cfg, convnet.random_folded_cnn(cfg, seed=3),
                                  device=dev)
        x = torch.from_numpy(rng.random((4096, cfg.n_in)).astype(
            np.float32)).to(dev)
        xp = pipe.conv.maps(pipe.conv.pack(x))
        conv, head = pipe.conv, pipe.head
        sargs = (xp, conv.ws, conv.cs, conv.metas)
        rows = {}
        for name, lib in (("input only", libs[0]), ("input + conv 1", libs[1]),
                          ("stage (all convs)", full)):
            _build._libs["fused_conv"] = lib
            rows[name] = device_ms(
                lambda: fused_conv.conv_stage_packed(*sargs), iters=20)
        _build._libs["fused_conv"] = full
        rows["votes (convs + FC + head)"] = device_ms(
            lambda: fused_conv.fused_conv_votes(
                *sargs, pipe.layer_ws, pipe.layer_cs, pipe.layer_n_bits,
                head.cam.rows_packed, head.thresholds,
                bias_cells=head.bias_cells), iters=20)
        res[mid] = rows
        for name, ms in rows.items():
            print(f"  {mid:9s} {name:26s} {ms:.4f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
