"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled on its own by `nvcc` for `sm_90a` into a
shared library with a plain C interface, loaded with ctypes.  The build
runs at first use, from the sources in the checkout, into
`build/repro_torch/<hash>/` at the repository root (listed in
`.gitignore`); the hash covers every source, header and compiler flag, so
an edited kernel is rebuilt and an unchanged one is reused.  All missing
libraries build at once, one `nvcc` process per source, in parallel.

A missing `nvcc` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch import obs

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("binary_gemm", "cam_search", "fused_mlp", "fused_conv",
           "keyed_sampler", "expert_ffn", "rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_LONG = ctypes.c_longlong
_FLOAT = ctypes.c_float
# C signatures of the launchers: every pointer and the stream as void*
_SIGNATURES = {
    "binary_gemm": {
        "binary_gemm_hd_launch": [_VOID_P] * 3 + [_INT] * 3 + [_VOID_P],
        "binary_gemm_plan": [_INT] * 5 + [_VOID_P],
        "grouped_bitlinear_launch": [_VOID_P] * 4 + [_INT] * 4 + [_VOID_P],
    },
    "cam_search": {
        "cam_vote_launch": [_VOID_P] * 5 + [_INT] * 5 + [_VOID_P],
        "cam_vote_plan": [_INT] * 6 + [_VOID_P],
    },
    "fused_mlp": {
        "fused_mlp_votes_launch": (
            [_VOID_P, _INT, _INT, _INT] + [_VOID_P] * 5
            + [_VOID_P, _INT, _INT, _INT, _VOID_P, _INT, _INT, _VOID_P,
               _VOID_P, _INT, _VOID_P]
        ),
    },
    "fused_conv": {
        "fused_conv_launch": (
            [_VOID_P, _INT, _INT] + [_VOID_P] * 3 + [_INT] + [_VOID_P] * 6
            + [_INT] * 7 + [_VOID_P, _INT, _INT] + [_VOID_P] * 3
        ),
    },
    "expert_ffn": {
        "expert_swiglu_signs_launch": [_VOID_P] * 4 + [_INT] * 3
        + [_VOID_P] * 3,
        "expert_combine_launch": [_VOID_P] * 6 + [_INT] * 4 + [_VOID_P] * 2,
    },
    "rows": {
        "rms_norm_rows_launch": [_VOID_P, _VOID_P, _LONG, _INT, _FLOAT]
        + [_VOID_P] * 2,
        "sign_rows_launch": [_VOID_P, _LONG, _INT] + [_VOID_P] * 3,
    },
    "keyed_sampler": {
        "keyed_thresholds_launch": (
            [_VOID_P] * 4 + [_FLOAT] * 4 + [_INT] * 4 + [_VOID_P] * 2
        ),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the repro_torch CUDA kernels "
        "are built from source at first use and need the CUDA toolkit"
    )


def sass(lib_path) -> str:
    """The SASS of a built library (`cuobjdump -sass`, beside nvcc)."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def source_hash() -> str:
    """Hash of every kernel source, header and nvcc flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where this source hash's libraries live (repo root `build/`)."""
    root = CSRC.parents[3]  # csrc -> kernels -> repro_torch -> src -> repo
    return root / "build" / "repro_torch" / source_hash()


def build_all() -> dict[str, str]:
    """Compile every library that is missing, one `nvcc` per source, all
    started together.  Returns {source: ptxas log} for the ones built."""
    out = build_dir()
    todo = [s for s in SOURCES if not (out / f"{s}.so").exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out / f"{name}.so")
        (out / f"{name}.log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with obs.span("kernels.load"):
                built = build_all()
                obs.count(built=len(built))
                lib = ctypes.CDLL(str(build_dir() / f"{name}.so"))
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                lib.picbnn_error_string.argtypes = [ctypes.c_int]
                lib.picbnn_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err:
        msg = lib.picbnn_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
