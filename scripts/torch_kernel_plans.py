"""Kernels 1 and 2 on the card: each launch plan at its shapes, timed.

    python3 scripts/torch_kernel_plans.py [--quick] [--parent DIR]

Exits 1 if any exact copy differed from the reference (each one is
reported and the timing goes on).

Builds copies of the kernel 1 and 2 libraries from the sources in the
checkout, each with one line replaced, and times them beside the shipped
ones (device ms, CUDA-graph replay; order shipped, copies, copies
reversed, shipped).  Exact copies must equal the plain version:
`table_always` (kernel 2 votes through its per-block table wherever
there is one), `count_always` (it counts every vote's P compares;
shipped: the table where a block votes more pairs than it has entries),
`stages6` and `stages8` (its ring of 6 or 8 stages, not 4), `blocks8`
(its grid aiming for 8 blocks an SM, not 4), `no_global_rows` (the
paper's heads through the ring too, not read from global memory),
`words_ring` (its ring filled by 4-byte cp.async, not TMA boxes), and
kernel 1's `stages3` (its large tile's ring of 3 stages, not 4) and
`large_any` (its large tile at any tile count, not only where the 32 x
128 tile's grid holds more than two blocks an SM).  The
others cut a kernel short, to show where its time goes (their results
are not checked): kernel 2 `launch_only`, `no_products`, `no_votes`;
kernel 1's large tile `loads_only` (the TMA ring alone), `no_epilogue`,
`no_wgmma`, `no_popcounts`, `no_stores`.  `--parent DIR` also builds
DIR's csrc/cam_search.cu and binary_gemm.cu (a checkout of the previous
version, unpacked with `git archive` into a directory .gitignore lists)
as the copy `parent`, exact.

Kernel 2 (`cam_vote`) runs at the LM heads (C = 128,256 rows of 64 words
at B in {1, 4, 16, 17, 32}; musicgen's C = 2,048 of 48 words at B = 4)
and the paper's heads (B = 4096 against 10 rows of 4 words and 20 rows of
6), int schedule P = 33.  Kernel 1 (`binary_gemm_hd`) runs each plan of
`gemm_plan` at the shapes it serves (tile32x128: the HG MLP's x[4096,
128] w[128, 128], the CNN FC x[4096, 225] w[128, 225], LM prefill
x[64, 64] w[8192, 64]; large: the long-context prefill x[32768, 64]
w[8192, 64] and x[32768, 256] w[2048, 256]; split_k: decode x[4, 256]
w[2048, 256], x[4, 64] w[8192, 64], x[1, 256]), each equal to the
float32 ±1 product (exact: K < 2^24), timed beside it; then, against
`large_any` alone, at 1-131 tiles of 128 x 256 (`GEMM_SWEEP`), across
the switch between the 32 x 128 tile and the large one.

Prints ptxas' registers and spills of both libraries, the card's name and
power limit first and a JSON line last.  `--quick` checks without
timing.  Needs nvcc and one card; builds into build/kernel_plans/.
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
# (library, name, exact, the line replaced, its replacement)
VARIANTS = (
    ("cam_search", "table_always", True,
     "  return vtab_n > 0 && votes > vtab_n;", "  return vtab_n > 0;"),
    ("cam_search", "count_always", True,
     "  return vtab_n > 0 && votes > vtab_n;", "  return false;"),
    ("cam_search", "stages6", True, "constexpr int kStages = 4;",
     "constexpr int kStages = 6;"),
    ("cam_search", "stages8", True, "constexpr int kStages = 4;",
     "constexpr int kStages = 8;"),
    ("cam_search", "blocks8", True, "constexpr int kBlocksPerSm = 4;",
     "constexpr int kBlocksPerSm = 8;"),
    ("cam_search", "launch_only", False,
     "  const int q0 = blockIdx.x * plan.bq;",
     "  if (b > 0) return;\n  const int q0 = blockIdx.x * plan.bq;"),
    ("cam_search", "no_products", False,
     "          if (mt < live_mt) bmma_hd(",
     "          if (mt < live_mt && b < 0) bmma_hd("),
    ("cam_search", "no_votes", False,
     "          if (cls >= c || row >= b) continue;",
     "          if (cls >= 0) continue;"),
    ("cam_search", "no_global_rows", True,
     "  if (c <= kGroupRows && kw <= kMaxKC) {  // every block's rows: one "
     "stage", "  if (false) {"),
    ("cam_search", "words_ring", True,
     "  } else if (aligned && kw % 4 == 0) {", "  } else if (false) {"),
    ("binary_gemm", "stages3", True, "constexpr int kLStages = 4;",
     "constexpr int kLStages = 3;"),
    ("binary_gemm", "large_any", True, "constexpr int kSmallWaves = 2;",
     "constexpr int kSmallWaves = 0;"),
    ("binary_gemm", "loads_only", False,
     "    mbar_wait(full + i % kLStages, (i / kLStages) & 1);\n",
     "    mbar_wait(full + i % kLStages, (i / kLStages) & 1);\n"
     "    __syncthreads();\n"
     "    if (threadIdx.x == 0 && i + kLStages - 1 < items)\n"
     "      issue(i + kLStages - 1);\n"
     "    if (m > 0) continue;\n"),
    ("binary_gemm", "no_epilogue", False,
     "    if (!last) continue;", "    if (!last || m > 0) continue;"),
    ("binary_gemm", "no_wgmma", False,
     "      wgmma_and_n256(acc,", "      if (m < 0) wgmma_and_n256(acc,"),
    ("binary_gemm", "no_popcounts", False,
     "      cnt[it] += __popc(v.x)", "      if (m < 0) cnt[it] += __popc(v.x)"),
    ("binary_gemm", "no_stores", False,
     "        if (row >= m) continue;", "        if (row >= 0) continue;"),
)
LIBS = ("cam_search", "binary_gemm")
FAILED: list = []  # exact copies that differed from the reference
CAM_SHAPES = ((1, 128256, 64), (4, 128256, 64), (16, 128256, 64),
              (17, 128256, 64), (32, 128256, 64), (4, 2048, 48),
              (4096, 10, 4), (4096, 20, 6))
GEMM_SHAPES = ((4096, 128, 128), (4096, 128, 225), (64, 8192, 64),
               (32768, 8192, 64), (32768, 2048, 256), (512, 256, 64),
               (4, 2048, 256), (4, 8192, 64), (1, 2048, 256))
# kernel 1 below one 128 x 256 tile an SM, across the switch between the
# 32 x 128 tile and the large one: (M, N, Kw) at 4-131 tiles for the
# LM's N and Kw (prefill of M tokens) and N = 256, timed against
# `large_any` (the large tile at every tile count)
GEMM_SWEEP = tuple((128 * t, 256, 64) for t in (4, 8, 16, 24, 33, 48, 66,
                                                99, 131)) + tuple(
    (128 * t, 2048, 256) for t in (1, 2, 3, 4, 6, 8, 12, 16)) + tuple(
    (m, 8192, 64) for m in (64, 256, 384, 512)) + tuple(
    (128 * t, 512, 128) for t in (2, 4, 8, 16, 33, 66))


def load(so: Path, lib: str) -> ctypes.CDLL:
    """Load a built copy of `lib` with the signatures of the functions it
    exports (a previous version may lack the plan functions)."""
    from repro_torch.kernels import _build

    cdll = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES[lib].items():
        if hasattr(cdll, fn):
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
    cdll.picbnn_error_string.argtypes = [ctypes.c_int]
    cdll.picbnn_error_string.restype = ctypes.c_char_p
    return cdll


def build_variants(parent) -> dict:
    """{lib: {name: (loaded library, exact)}}, one `nvcc` each, all at
    once."""
    from repro_torch.kernels import _build

    jobs = [(lib, name, exact, old, new)
            for lib, name, exact, old, new in VARIANTS]
    if parent is not None:
        jobs += [(lib, "parent", True, None, None) for lib in LIBS]
    procs = []
    for lib, name, exact, old, new in jobs:
        out = ROOT / "build" / "kernel_plans" / f"{lib}_{name}"
        out.mkdir(parents=True, exist_ok=True)
        src = (Path(parent) / "src/repro_torch/kernels/csrc" if old is None
               else _build.CSRC)
        for f in src.iterdir():
            if f.suffix in (".cu", ".cuh"):
                shutil.copy(f, out / f.name)
        if old is not None:
            text = (out / f"{lib}.cu").read_text()
            if old not in text:
                raise SystemExit(f"FAIL: {lib} {name}: the replaced line "
                                 "moved")
            (out / f"{lib}.cu").write_text(text.replace(old, new))
        so = out / f"{lib}.so"
        procs.append((lib, name, exact, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
             str(out / f"{lib}.cu")], stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)))
    built = {lib: {} for lib in LIBS}
    for lib, name, exact, so, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"FAIL: nvcc {lib} {name}")
        built[lib][name] = (load(so, lib), exact)
    return built


def words(gen, *shape):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)


def timed_variants(lib, libs, fn, want, quick, iters):
    """Each copy of `lib` run on `fn`, exact ones checked against `want`;
    device ms in the order shipped, copies, copies reversed, shipped."""
    from chip_smoke import device_ms
    from repro_torch.kernels import _build

    names = list(libs)
    order = (["shipped", *names, *reversed(names), "shipped"] if not quick
             else ["shipped", *names])
    times = {k: [] for k in ["shipped", *names]}
    shipped = _build.library(lib)
    for key in order:
        lib_obj, exact = (shipped, True) if key == "shipped" else libs[key]
        _build._libs[lib] = lib_obj
        got = fn()
        if exact and not torch.equal(got, want):
            FAILED.append(f"{lib} {key} {tuple(want.shape)}: "
                          f"{int((got != want).sum())} differ")
            print(f"FAIL: {FAILED[-1]}")
        if not quick:
            times[key].append(device_ms(fn, iters=iters))
    _build._libs.pop(lib)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_plans: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.core import binarize
    from repro_torch.kernels import _build, binary_gemm, cam_search

    args = sys.argv[1:]
    quick = "--quick" in args
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    smi = nvidia_smi("name,power.limit")
    print(f"card: {smi}")
    logs = _build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = build_variants(parent)
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"card": smi, "cam_vote": {}, "binary_gemm_hd": {}}
    for b, c, kw in CAM_SHAPES:
        q, rows = words(gen, b, kw), words(gen, c, kw)
        thr = torch.arange(16 * kw - 16, 16 * kw + 17, dtype=torch.int32,
                           device="cuda")
        plan = cam_search.cam_plan(b, c, kw, False, sms)
        want = cam_search.cam_vote_plain(q, rows, thr)
        times = timed_variants(
            "cam_search", variants["cam_search"],
            lambda: cam_search.cam_vote(q, rows, thr), want, quick, 20)
        label = f"q[{b},{kw}] rows[{c},{kw}] P=33"
        res["cam_vote"][label] = dict(plan=plan, ms=times)
        print(f"  cam_vote {label}: grid {plan['grid']} bq {plan['bq']} "
              f"gpb {plan['gpb']}; " + ", ".join(
                  f"{k} {[round(x, 5) for x in v]}"
                  for k, v in times.items()))
    sweep = {"large_any": variants["binary_gemm"]["large_any"]}
    for m, n, kw in GEMM_SHAPES + GEMM_SWEEP:
        x, w = words(gen, m, kw), words(gen, n, kw)
        plan = binary_gemm.gemm_plan(m, n, kw, binary_gemm.words_aligned(
            x, w), sms)
        k = 32 * kw
        xf = binarize.unpack_bits(x, k).float() * 2 - 1
        wf = (binarize.unpack_bits(w, k).float() * 2 - 1).t().contiguous()
        want = ((k - torch.matmul(xf, wf)) * 0.5).to(torch.int32)
        big = m * n > 10 ** 7
        times = timed_variants(
            "binary_gemm", (variants["binary_gemm"]
                            if (m, n, kw) in GEMM_SHAPES else sweep),
            lambda: binary_gemm.binary_gemm_hd(x, w), want, quick,
            5 if big else 20)
        row = dict(plan=plan, tiles=-(-m // 128) * -(-n // 256), ms=times)
        if not quick:
            row["library_ms"] = device_ms(
                lambda: ((k - torch.matmul(xf, wf)) * 0.5), iters=5)
        label = f"x[{m},{kw}] w[{n},{kw}]"
        res["binary_gemm_hd"][label] = row
        print(f"  binary_gemm_hd {label}: {plan['plan']} grid {plan['grid']}"
              f" ({row['tiles']} tiles); " + ", ".join(f"{k} {[round(v, 5) for v in t]}"
                               for k, t in times.items())
              + f"; library {row.get('library_ms')}")
        del x, w, xf, wf, want
        torch.cuda.empty_cache()
    res["failed"] = FAILED
    print(json.dumps(res))
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
