"""Kernel 1: bit-packed XNOR-popcount GEMM (pairwise Hamming distances).

    out[m, n] = sum_k popcount(x[m, k] XOR w[n, k])        (Hamming distance)
    dot_pm1   = n_bits - 2 * out                           (XNOR-popcount dot)

`binary_gemm_hd` launches the CUDA kernel of `csrc/binary_gemm.cu` for
tensors on the card and runs `binary_gemm_hd_plain`, the same arithmetic
in plain PyTorch, for tensors on the CPU.  It replaces the Pallas kernel
`repro/kernels/binary_gemm.py::binary_gemm_hd`; the source note in the
.cu file says what bounds it on the card and how it is tiled.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import popcount32
from repro_torch.kernels import _build


def binary_gemm_hd_plain(x_packed: torch.Tensor,
                         w_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one [M, N] XOR-popcount-add per word."""
    m, kw = x_packed.shape
    acc = torch.zeros((m, w_packed.shape[0]), dtype=torch.int32,
                      device=x_packed.device)
    for k in range(kw):
        acc += popcount32(x_packed[:, k, None] ^ w_packed[None, :, k])
    return acc


def _check_words(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.ndim != 2:
        raise TypeError(f"{name} must be 2-D int32 packed words, got "
                        f"{t.dtype} {tuple(t.shape)}")


def binary_gemm_hd(x_packed: torch.Tensor,
                   w_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between packed rows.

    x_packed: [M, Kw] int32;  w_packed: [N, Kw] int32  ->  [M, N] int32.
    CUDA tensors launch the kernel (counted in `binary_gemm_hd.launches`);
    CPU tensors take the plain version.
    """
    _check_words("x_packed", x_packed)
    _check_words("w_packed", w_packed)
    if x_packed.shape[1] != w_packed.shape[1]:
        raise ValueError(f"packed widths differ: {tuple(x_packed.shape)} vs "
                         f"{tuple(w_packed.shape)}")
    if x_packed.device != w_packed.device:
        raise ValueError("x_packed and w_packed are on different devices")
    if x_packed.device.type == "cpu":
        return binary_gemm_hd_plain(x_packed, w_packed)
    if x_packed.device.type != "cuda":
        raise ValueError(f"unsupported device {x_packed.device}")
    m, kw = x_packed.shape
    n = w_packed.shape[0]
    if -(-m // 32) > 65535:
        raise ValueError(f"M = {m} exceeds the kernel grid (2,097,120 rows)")
    out = torch.empty((m, n), dtype=torch.int32, device=x_packed.device)
    if m == 0 or n == 0:
        return out
    x, w = x_packed.contiguous(), w_packed.contiguous()
    lib = _build.library("binary_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.binary_gemm_hd_launch(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), m, n, kw, stream)
    _build.check(lib, err, "binary_gemm_hd")
    binary_gemm_hd.launches += 1
    return out


binary_gemm_hd.launches = 0
