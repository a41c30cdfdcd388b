"""Plain PyTorch oracles for the kernels (port of `repro/kernels/ref.py`).

These are written independently of the kernels' plain versions — a
broadcast XOR over all word pairs instead of a loop over words, and the
CNN in the unpacked ±1 domain — so the tests can hold both against them.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.binarize import popcount32
from repro_torch.core.convnet import is_conv_layer
from repro_torch.core.ensemble import votes_fused


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


@contextlib.contextmanager
def _full_fp32():
    """float32 convolutions and matmuls in full float32, not TF32.

    cuDNN runs a float32 convolution in TF32 by default.  ±1 inputs and
    integer sums of a few hundred terms are exact in TF32 with float32
    accumulation, but the oracle does not lean on that: it turns TF32
    off for its own calls and restores the caller's settings.
    """
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def binary_conv2d_ref(x_pm1, w_pm1, stride: int = 1) -> torch.Tensor:
    """±1-domain VALID conv oracle: the unpacked ground truth.

    x_pm1: [B, H, W, C] ±1 activations;  w_pm1: [O, K, K, C] ±1 filters
    (`convnet.FoldedConvLayer.weights_pm1`).  Returns float32 [B, OH, OW,
    O] dot products (== n_bits - 2*HD in the packed domain).
    """
    x = torch.as_tensor(x_pm1).to(torch.float32)
    w = torch.as_tensor(w_pm1).to(x.device, torch.float32)
    with _full_fp32():
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                       w.permute(0, 3, 1, 2), stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_votes_ref(folded, head, x01, encoding, side: int) -> torch.Tensor:
    """Unpacked end-to-end-binary CNN oracle: raw pixels -> vote counts.

    Encodes [0,1] pixels [B, side*side] through the binary input layer,
    runs every conv layer as sign(conv + C) in ±1 floats, flattens NHWC,
    runs the folded FC hidden layers as sign(Wx + C), and votes the head
    with `ensemble.votes_fused`.
    """
    x01 = torch.as_tensor(x01)
    b = x01.shape[0]
    h = encoding.encode_pm1(x01.reshape(b, side, side))
    for layer in folded[:-1]:
        c = torch.as_tensor(layer.c).to(h.device, torch.float32)
        if is_conv_layer(layer):
            y = binary_conv2d_ref(h, layer.weights_pm1, layer.stride)
        else:
            w = torch.as_tensor(layer.weights_pm1).to(h.device,
                                                      torch.float32)
            with _full_fp32():
                y = h.reshape(b, -1) @ w.T
        h = torch.where(y + c >= 0, 1.0, -1.0)
    return votes_fused(head, h.reshape(b, -1))
