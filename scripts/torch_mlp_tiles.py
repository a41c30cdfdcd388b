"""Kernel 3 on the card: the block program's design choices, timed.

    python3 scripts/torch_mlp_tiles.py

Kernel 3 (`fused_mlp_votes`) runs the block program of
csrc/mlp_block.cuh.  This script builds copies of its library from the
sources in the checkout, each with one line replaced.  Six undo
a design choice and must still equal the plain version: `rows_global`
reads the rows from global memory wherever they are, `rows_smem` stages
them in shared memory wherever they fit (the shipped rule stages only
rows of 32 KB or more), `no_vote_table` counts every vote with P
compares instead of reading the per-block table, and `threads256_nt4`,
`threads512_nt2`, `threads1024_nt2` change the block's warps and the n8
tiles a warp item holds (shipped: 1024 threads, one tile).  Four cut the
block program short, to show where its time goes (their votes are wrong
and not checked): `no_row_copies` skips staging the rows, `launch_only`
returns at once, `staging_only` stops once the first tile's copies, the
schedule and the vote table are in, `no_head` (kernel 3)
stops before the head.  It times the shipped library and the copies
(CUDA-graph replay, int thresholds, B = 4096) at the paper's MNIST
784-128-10 and HG 4096-128-20 MLPs, in the order built, copies, copies
reversed, built; then kernel 3's shipped
library at bq in {16, 32, 64, 128}, in that order and back.  Prints the
card's name and power limit first and a JSON line last.  Needs nvcc and
one card; builds into build/mlp_tiles/.
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
ROWS_RULE = ("  const bool global = rows < kRowsSmemMin || base + rows > "
             "kSmemLimit;")
THREADS_NT = "constexpr int kMlpThreads = 1024;\nconstexpr int kMlpNT = 1;"
# (name, exact, the header, the line it replaces, the replacement)
VARIANTS = (
    ("rows_global", True, "mlp_block.cuh", ROWS_RULE,
     "  const bool global = true;"),
    ("rows_smem", True, "mlp_block.cuh", ROWS_RULE,
     "  const bool global = base + rows > kSmemLimit;"),
    ("no_vote_table", True, "mlp_block.cuh",
     "      thr_mode == kThrSampled ? 0 : std::min(32 * T.kw_head + 1, "
     "kVoteTab);",
     "      0;"),
    ("no_row_copies", False, "mlp_block.cuh",
     "  if (!ROWS_GLOBAL) {\n    for (int l = 0; l < T.n_layers; ++l) {\n"
     "      const Layer& L = T.layers[l];\n      copy_rows_async(",
     "  if (!ROWS_GLOBAL && b < 0) {\n"
     "    for (int l = 0; l < T.n_layers; ++l) {\n"
     "      const Layer& L = T.layers[l];\n      copy_rows_async("),
    ("threads256_nt4", True, "mlp_block.cuh", THREADS_NT,
     "constexpr int kMlpThreads = 256;\nconstexpr int kMlpNT = 4;"),
    ("threads512_nt2", True, "mlp_block.cuh", THREADS_NT,
     "constexpr int kMlpThreads = 512;\nconstexpr int kMlpNT = 2;"),
    ("threads1024_nt2", True, "mlp_block.cuh", THREADS_NT,
     "constexpr int kMlpThreads = 1024;\nconstexpr int kMlpNT = 2;"),
    ("launch_only", False, "mlp_block.cuh",
     "  const int mtiles = net.bq >> 4;",
     "  const int mtiles = net.bq >> 4;\n  if (b > 0) return;"),
    ("staging_only", False, "mlp_block.cuh",
     "    fc_stage<MODE, kMlpNT, ROWS_GLOBAL>(",
     "    if (b > 0) break;\n    fc_stage<MODE, kMlpNT, ROWS_GLOBAL>("),
    ("no_head", False, "fc_stage.cuh",
     "  head_votes<MODE, NT, ROWS_GLOBAL>(",
     "  if (b > 0) return;\n  head_votes<MODE, NT, ROWS_GLOBAL>("),
)
BQS = (16, 32, 64, 128)


def build_variants(libs) -> dict:
    """Every variant of every library, one `nvcc` each, all at once:
    {lib: {name: loaded library}}."""
    from repro_torch.kernels import _build

    procs = []
    for name, _, header, old, new in VARIANTS:
        out = ROOT / "build" / "mlp_tiles" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.iterdir():
            if f.suffix in (".cu", ".cuh"):
                shutil.copy(f, out / f.name)
        text = (out / header).read_text()
        if old not in text:
            raise SystemExit(f"FAIL: {name}: the replaced line moved")
        (out / header).write_text(text.replace(old, new))
        for lib in libs:
            so = out / f"{lib}.so"
            procs.append((lib, name, so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(out / f"{lib}.cu")], stdout=subprocess.DEVNULL,
                stderr=subprocess.STDOUT)))
    built = {lib: {} for lib in libs}
    for lib, name, so, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"FAIL: nvcc {name}/{lib}")
        built[lib][name] = load(so, lib)
    return built


def load(so: Path, lib: str) -> ctypes.CDLL:
    """Load a built copy of `lib` with the launchers' signatures."""
    from repro_torch.kernels import _build

    cdll = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES[lib].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    cdll.picbnn_error_string.argtypes = [ctypes.c_int]
    cdll.picbnn_error_string.restype = ctypes.c_char_p
    return cdll


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mlp_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SEED, device_ms, nvidia_smi, random_folded
    from repro_torch.configs.paper_mlp import HG_MLP, MNIST_MLP, PAPER_ENSEMBLE
    from repro_torch.core import binarize, bnn
    from repro_torch.kernels import _build, fused_mlp
    from repro_torch.pipeline import compile_pipeline

    smi = nvidia_smi("name,power.limit")
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    names = ("fused_mlp",)
    variants = build_variants(names)
    libs = {lib: {"built": _build.library(lib), **variants[lib]}
            for lib in names}
    exact = {v[0]: v[1] for v in VARIANTS}
    order = ["built", *[v[0] for v in VARIANTS],
             *[v[0] for v in reversed(VARIANTS)], "built"]
    res = {"card": smi}
    rng = np.random.default_rng(SEED + 7)
    for mid, cfg, seed in (("mnist", MNIST_MLP, SEED), ("hg", HG_MLP,
                                                        SEED + 1)):
        folded = random_folded(cfg.layer_sizes, seed, cfg.bias_cells, bnn)
        pipe = compile_pipeline(folded, PAPER_ENSEMBLE, device=dev)
        x = torch.from_numpy(rng.choice([-1.0, 1.0], (
            4096, cfg.layer_sizes[0])).astype(np.float32)).to(dev)
        xp = binarize.pack_pm1(x)
        head, thr = pipe.head.cam.rows_packed, pipe.head.thresholds
        bias = pipe.head.bias_cells
        args = (xp, pipe.layer_ws, pipe.layer_cs, pipe.layer_n_bits, head,
                thr)
        calls = {
            "fused_mlp": (
                lambda: fused_mlp.fused_mlp_votes(*args, bias_cells=bias),
                fused_mlp.fused_mlp_votes_plain(*args, bias_cells=bias)),
        }
        for lib, (fn, want) in calls.items():
            times = {k: [] for k in order}
            for key in order:
                _build._libs[lib] = libs[lib][key]
                got = fn()
                if exact.get(key, True) and not torch.equal(got, want):
                    raise SystemExit(f"FAIL: {mid} {lib} {key} != plain")
                times[key].append(device_ms(fn))
            _build._libs[lib] = libs[lib]["built"]
            res[f"{mid}/{lib}"] = times
            print(f"  {mid:5s} {lib:10s} " + ", ".join(
                f"{k} {v}" for k, v in times.items()))
        bq_times = {bq: [] for bq in BQS}
        for bq in (*BQS, *reversed(BQS)):
            fn = lambda: fused_mlp.fused_mlp_votes(*args, bias_cells=bias,
                                                   bq=bq)
            if not torch.equal(fn(), calls["fused_mlp"][1]):
                raise SystemExit(f"FAIL: {mid} bq={bq} != plain")
            bq_times[bq].append(device_ms(fn))
        res[f"{mid}/fused_mlp/bq"] = bq_times
        print(f"  {mid:5s} fused_mlp bq " + ", ".join(
            f"{k}: {v}" for k, v in bq_times.items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
