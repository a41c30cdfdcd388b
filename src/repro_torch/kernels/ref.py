"""Plain PyTorch oracles for the kernels (port of `repro/kernels/ref.py`).

These are written independently of the kernels' plain versions — a
broadcast XOR over all word pairs instead of a loop over words — so the
tests can hold both against them.  The convolution oracles wait for the
CNN slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import popcount32


def binary_gemm_hd_ref(x_packed: torch.Tensor,
                       w_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance: [M, Kw] x [N, Kw] -> [M, N] int32."""
    xor = x_packed[:, None, :] ^ w_packed[None, :, :]
    return popcount32(xor).sum(-1, dtype=torch.int32)


def cam_vote_ref(q_packed: torch.Tensor, rows_packed: torch.Tensor,
                 thresholds) -> torch.Tensor:
    """Fused multi-threshold vote: [B, C] int32 (integer thresholds)."""
    hd = binary_gemm_hd_ref(q_packed, rows_packed)
    thr = torch.as_tensor(thresholds, device=hd.device).to(torch.int32)
    return (hd[:, :, None] <= thr).sum(-1, dtype=torch.int32)


def bitlinear_ref(x, w, n_bits: int | None = None) -> torch.Tensor:
    """±1-domain binary matmul oracle: y = x @ w with x, w in {-1,+1}.

    x: [..., K] ±1;  w: [K, N] ±1.  Returns float32 [..., N].
    """
    return torch.as_tensor(x).to(torch.float32) @ torch.as_tensor(w).to(
        torch.float32)
