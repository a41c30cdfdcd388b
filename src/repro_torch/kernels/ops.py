"""Public wrappers around the kernels (port of `repro/kernels/ops.py`).

Each call launches the hand-written CUDA kernel for tensors on the card
and runs its plain PyTorch version for tensors on the CPU; there is no
interpret mode to resolve.  `binary_gemm_mxu` (an int8 matrix product in
the reference, not a Pallas kernel) waits for the cost-model slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import binary_gemm as _bg
from repro_torch.kernels import cam_search as _cs


def binary_gemm_hd(x_packed: torch.Tensor,
                   w_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between packed rows ([M,Kw],[N,Kw]->[M,N])."""
    return _bg.binary_gemm_hd(x_packed, w_packed)


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
