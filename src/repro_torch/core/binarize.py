"""Bit packing and Hamming-distance primitives (port of
`repro/core/binarize.py`, inference half).

Conventions (paper Sec. II-B):
  logical bit b in {0, 1}  <->  value v = 2b - 1 in {-1, +1}
  weight/activation "match" (XNOR == 1)  <->  product v_w * v_x = +1

Packed representation: bits are packed little-endian into 32-bit words
along the last axis.  The words are stored as `torch.int32` tensors that
hold the bit pattern of the reference's `uint32` words (PyTorch on the
CPU has no shifts or popcount for `torch.uint32`).  Every function here
keeps that view consistent: packing goes through int64 and wraps into
int32, and the popcount masks to the low 32 bits first, so bit 31 is an
ordinary bit.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 32

_TWO32 = 1 << 32
_SHIFTS = torch.arange(WORD, dtype=torch.int64)


def to_bits(values: torch.Tensor) -> torch.Tensor:
    """±1 values (any dtype) -> {0,1} uint8 bits."""
    return (values > 0).to(torch.uint8)


def from_bits(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """{0,1} bits -> ±1 values."""
    return (2 * bits.to(torch.int8) - 1).to(dtype)


def packed_width(n_bits: int) -> int:
    """32-bit words needed for n_bits packed bits (ceil division)."""
    return -(-n_bits // WORD)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0,1} bits along the last axis into int32 words (little-endian).

    Pads with 0 to a multiple of 32.  Padding bits are 0 on both operands
    of a Hamming distance, so XOR over padding contributes nothing.
    """
    *lead, k = bits.shape
    kw = packed_width(k)
    pad = kw * WORD - k
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(*lead, kw, WORD).to(torch.int64)
    words = (b << _SHIFTS.to(b.device)).sum(-1)  # < 2^32: exact in int64
    # wrap into int32 keeping the low 32 bits (bit 31 becomes the sign)
    return torch.where(words >= 1 << 31, words - _TWO32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32 words -> {0,1} uint8 bits, truncated to n_bits.

    `>>` on int32 is arithmetic, but `& 1` keeps only the shifted bit, so
    bit 31 reads back correctly.
    """
    *lead, kw = words.shape
    shifts = _SHIFTS.to(device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*lead, kw * WORD)[..., :n_bits].to(torch.uint8)


def pack_pm1(values: torch.Tensor) -> torch.Tensor:
    """±1 values -> packed int32 words."""
    return pack_bits(to_bits(values))


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR popcount in int64) -> int32."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed bit vectors (broadcasts leading dims)."""
    return popcount32(torch.bitwise_xor(a, b)).sum(-1, dtype=torch.int32)


def dot_from_hd(hd, n_bits):
    """XNOR-popcount 'dot product' from Hamming distance.

    matches - mismatches = (n - hd) - hd = n - 2*hd  ==  <v_a, v_b> in ±1.
    """
    return n_bits - 2 * hd


def hd_from_dot(dot, n_bits):
    """Inverse of `dot_from_hd`: Hamming distance from the ±1 dot."""
    return (n_bits - dot) // 2


def binary_matvec_packed(w_packed: torch.Tensor, x_packed: torch.Tensor,
                         n_bits: int) -> torch.Tensor:
    """y_j = sum_i XNOR(+/-)(W_ji, x_i) over packed rows.

    w_packed: [N, Kw] int32;  x_packed: [..., Kw] int32.
    Returns [..., N] int32 dot products in the ±1 domain.  Routed through
    `kernels.ops.binary_gemm_hd`: the CUDA kernel for tensors on the card,
    its plain PyTorch version for tensors on the CPU.
    """
    from repro_torch.kernels import ops  # deferred: core stays import-light

    *lead, kw = x_packed.shape
    hd = ops.binary_gemm_hd(x_packed.reshape(-1, kw).contiguous(), w_packed)
    return dot_from_hd(hd, n_bits).reshape(*lead, w_packed.shape[0])


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    """NumPy twin of pack_bits (host-side CAM construction).

    Returns uint32 words, exactly as the reference does; `words_to_torch`
    gives the int32 view the rest of the port stores.
    """
    *lead, k = bits.shape
    kw = packed_width(k)
    pad = kw * WORD - k
    if pad:
        bits = np.pad(bits, [(0, 0)] * len(lead) + [(0, pad)])
    bits = bits.reshape(*lead, kw, WORD).astype(np.uint64)
    return (bits << np.arange(WORD, dtype=np.uint64)).sum(-1).astype(np.uint32)


def words_to_torch(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 (or int32) numpy words -> the port's int32 tensor view."""
    a = np.ascontiguousarray(words)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"packed words must be uint32/int32, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)
