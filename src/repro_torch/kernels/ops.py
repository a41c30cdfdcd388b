"""Public wrappers around the kernels (port of `repro/kernels/ops.py`).

Each kernel call launches the hand-written CUDA kernel for tensors on
the card and runs its plain PyTorch version for tensors on the CPU;
there is no interpret mode to resolve.  `binary_gemm_mxu` is an int8
matrix product in the reference (`dot_general`, not a Pallas kernel), so
its counterpart is the library's int8 tensor-core product on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import binary_gemm as _bg
from repro_torch.kernels import cam_search as _cs


def binary_gemm_hd(x_packed: torch.Tensor,
                   w_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between packed rows ([M,Kw],[N,Kw]->[M,N])."""
    return _bg.binary_gemm_hd(x_packed, w_packed)


def grouped_bitlinear_hd(x_packed: torch.Tensor, offsets: torch.Tensor,
                         w_packed: torch.Tensor) -> torch.Tensor:
    """Each run of rows against its own packed rows, one launch
    ([S,Kw],[E+1],[E,N,Kw] -> [S,N])."""
    return _bg.grouped_bitlinear_hd(x_packed, offsets, w_packed)


def binary_gemm_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
                    n_bits: int) -> torch.Tensor:
    """XNOR-popcount dot products in the ±1 domain: n_bits - 2*HD."""
    return n_bits - 2 * binary_gemm_hd(x_packed, w_packed)


def cam_vote(q_packed: torch.Tensor, rows_packed: torch.Tensor,
             thresholds: torch.Tensor, *,
             thr_samples: torch.Tensor | None = None) -> torch.Tensor:
    """Fused Algorithm-1 vote counts ([B,Kw],[C,Kw],[P] -> [B,C] int32)."""
    return _cs.cam_vote(q_packed, rows_packed, thresholds,
                        thr_samples=thr_samples)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def binary_gemm_mxu_plain(x_pm1: torch.Tensor,
                          w_pm1: torch.Tensor) -> torch.Tensor:
    """Plain version: the int32 matrix product ([..., K] x [K, N])."""
    return torch.matmul(x_pm1.to(torch.int32), w_pm1.to(torch.int32))


def binary_gemm_mxu(x_pm1: torch.Tensor, w_pm1: torch.Tensor) -> torch.Tensor:
    """±1 operands through the int8 tensor cores, int32 accumulation.

    x: [..., K], w: [K, N] in {-1,+1} -> [..., N] int32 (exact for
    K < 2^31).  CUDA tensors go to `torch._int_mm`, which takes 2-D
    operands with more than 16 rows and K, N multiples of 8: the operands
    are zero-padded to that and the result sliced back (a zero adds
    nothing to a ±1 dot).  CPU tensors take the plain version.
    """
    if x_pm1.shape[-1] != w_pm1.shape[0] or w_pm1.ndim != 2:
        raise ValueError(f"shapes {tuple(x_pm1.shape)} x {tuple(w_pm1.shape)}"
                         " do not chain as [..., K] x [K, N]")
    if x_pm1.device != w_pm1.device:
        raise ValueError("x_pm1 and w_pm1 are on different devices")
    if x_pm1.device.type == "cpu":
        return binary_gemm_mxu_plain(x_pm1, w_pm1)
    if x_pm1.device.type != "cuda":
        raise ValueError(f"unsupported device {x_pm1.device}")
    *lead, k = x_pm1.shape
    n = w_pm1.shape[1]
    x = x_pm1.reshape(-1, k)
    m = x.shape[0]
    kp = _round_up(max(k, 1), 8)
    xp = torch.zeros((_round_up(max(m, 17), 8), kp), dtype=torch.int8,
                     device=x.device)
    xp[:m, :k] = x
    # the second operand column-major, the layout the int8 GEMM takes
    wt = torch.zeros((_round_up(max(n, 1), 8), kp), dtype=torch.int8,
                     device=x.device)
    wt[:n, :k] = w_pm1.t()
    return torch._int_mm(xp, wt.t())[:m, :n].reshape(*lead, n)
