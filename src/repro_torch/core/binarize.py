"""Sign with the straight-through estimator, bit packing,
Hamming-distance primitives and the binary input layer (port of
`repro/core/binarize.py`).

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

import dataclasses

import numpy as np
import torch

WORD = 32

_TWO32 = 1 << 32


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} with the clipped straight-through estimator.

    Forward: sign(x) (0 maps to +1, matching the paper's logic-'1' coding).
    Backward: dL/dx = dL/dy * 1[|x| <= 1]  (Hinton STE / BinaryConnect).
    """
    return _SignSTE.apply(x)


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
    # the shifts made on b's device each call (a module-level tensor would
    # meet the fake tensors of a dry-run as a real one)
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)
    words = (b << shifts).sum(-1)  # < 2^32: exact in int64
    # wrap into int32 keeping the low 32 bits (bit 31 becomes the sign)
    return torch.where(words >= 1 << 31, words - _TWO32, words).to(torch.int32)


def pack_bits_reference(bits: torch.Tensor) -> torch.Tensor:
    """The reference's shift-broadcast-sum pack, kept there as the oracle
    and baseline of its dot-product fast path.  The port's `pack_bits` is
    that same algorithm, so this is `pack_bits` under the reference's
    name."""
    return pack_bits(bits)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32 words -> {0,1} uint8 bits, truncated to n_bits.

    `>>` on int32 is arithmetic, but `& 1` keeps only the shifted bit, so
    bit 31 reads back correctly.
    """
    *lead, kw = words.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
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


def hamming_pm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between ±1 vectors: #positions where they differ."""
    return (a * b < 0).sum(-1, dtype=torch.int32)


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


# ---------------------------------------------------------------------------
# Binary input layer: [0, 1] intensity -> multi-bit binary codes
# ---------------------------------------------------------------------------
# The end-to-end claim binarizes the INPUT layer too: each [0, 1] intensity
# expands into `width` binary channels, so the first (binary) conv layer
# sees a graded input while the whole network computes only on bits.


def thermometer_thresholds(width: int) -> np.ndarray:
    """The thermometer levels (t+1)/(width+1), t < width, in float32.

    Computed with numpy's IEEE float32 division, exactly as the reference
    computes them, so that a pixel on a level boundary encodes the same
    way in both packages (a division by a scalar on the card may take a
    reciprocal and round differently).
    """
    if width < 1:
        raise ValueError(f"thermometer width must be >= 1, got {width}")
    return (np.arange(width, dtype=np.float32) + np.float32(1.0)) \
        / np.float32(width + 1.0)


def thermometer_bits(x01, width: int) -> torch.Tensor:
    """[0,1] intensities -> thermometer code, [..., width] {0,1} uint8.

    Bit t fires iff x >= (t+1)/(width+1): the code is monotone, so the
    Hamming distance between two codes is the quantized intensity gap.
    width=1 is the plain x >= 0.5 binarization.
    """
    x = torch.as_tensor(x01).to(torch.float32)
    thr = torch.from_numpy(thermometer_thresholds(width)).to(x.device)
    return (x[..., None] >= thr).to(torch.uint8)


def thermometer_decode(bits) -> torch.Tensor:
    """Thermometer code -> intensity estimate in [0,1] (level midpoint)."""
    bits = torch.as_tensor(bits)
    width = bits.shape[-1]
    k = bits.to(torch.int32).sum(-1).to(torch.float32)
    return (k + 0.5) / (width + 1.0)


def _bitplane_levels(x01, width: int) -> torch.Tensor:
    """round(x * (2^width - 1)) as int64 (round half to even, as jnp.round)."""
    if width < 1:
        raise ValueError(f"bit-plane width must be >= 1, got {width}")
    x = torch.as_tensor(x01).to(torch.float32)
    return torch.round(x * ((1 << width) - 1)).to(torch.int64)


def bitplane_bits(x01, width: int) -> torch.Tensor:
    """[0,1] intensities -> binary expansion, [..., width] {0,1} uint8.

    Quantizes to round(x * (2^width - 1)) and emits the bit planes
    LSB-first.  Denser than thermometer but not Hamming-faithful.
    """
    q = _bitplane_levels(x01, width)
    shifts = torch.arange(width, dtype=torch.int64, device=q.device)
    return ((q[..., None] >> shifts) & 1).to(torch.uint8)


def bitplane_decode(bits) -> torch.Tensor:
    """Bit planes (LSB-first) -> intensity in [0,1]; exact on the grid."""
    bits = torch.as_tensor(bits)
    width = bits.shape[-1]
    weights = (1 << torch.arange(width, dtype=torch.int64,
                                 device=bits.device)).to(torch.float32)
    return (bits.to(torch.float32) * weights).sum(-1) / float((1 << width) - 1)


@dataclasses.dataclass(frozen=True)
class InputEncoding:
    """How raw [0,1] pixels become the binary input channels of a CNN.

    kind  : "thermometer" (Hamming-faithful, width+1 levels — the
            default), "bitplane" (2^width levels, not Hamming-faithful),
            or "sign" (width must be 1; plain x >= 0.5).
    width : binary channels emitted per pixel (= C_in of the first conv
            layer).
    """

    kind: str = "thermometer"
    width: int = 8

    def __post_init__(self):
        if self.kind not in ("thermometer", "bitplane", "sign"):
            raise ValueError(f"unknown input encoding kind {self.kind!r}")
        if self.kind == "sign" and self.width != 1:
            raise ValueError("sign encoding is width-1 by definition")
        if self.width < 1:
            raise ValueError(f"encoding width must be >= 1: {self.width}")

    def encode_bits(self, x01) -> torch.Tensor:
        """[0,1] intensities [...] -> {0,1} uint8 bits [..., width]."""
        if self.kind == "bitplane":
            return bitplane_bits(x01, self.width)
        if self.kind == "sign":
            x = torch.as_tensor(x01).to(torch.float32)
            return (x[..., None] >= 0.5).to(torch.uint8)
        return thermometer_bits(x01, self.width)

    def encode_pm1(self, x01, dtype=torch.float32) -> torch.Tensor:
        """[0,1] intensities [...] -> ±1 values [..., width]."""
        return from_bits(self.encode_bits(x01), dtype)

    def pack(self, x01) -> torch.Tensor:
        """[0,1] intensities [...] -> packed int32 words [..., Cw].

        The same words as `pack_bits(encode_bits(x01))`, bit 31 included,
        built as OR_t (bit_t << t) straight in int32: no [..., width] bit
        tensor, no padding to 32 bits and no int64.  That route pads every
        pixel to 32 bits and widens them to int64: 4096 x 64 x 64 x 32 x 8
        bytes = 4.3 GB per temporary for a batch of 4096 Hand-Gesture
        images; this one holds one int32 word per pixel at a time.
        """
        x = torch.as_tensor(x01).to(torch.float32)
        if self.kind == "bitplane":
            q = _bitplane_levels(x, self.width)
            q = q & ((1 << self.width) - 1)
            words = [(q >> (WORD * w)) & 0xFFFFFFFF
                     for w in range(packed_width(self.width))]
            words = [torch.where(v >= 1 << 31, v - _TWO32, v).to(torch.int32)
                     for v in words]
            return torch.stack(words, dim=-1)
        # Python floats holding the float32 levels: compared exactly, and
        # with no host-to-device copy (which would synchronise the stream)
        thr = ([0.5] if self.kind == "sign"
               else thermometer_thresholds(self.width).tolist())
        words = []
        for w in range(packed_width(self.width)):
            word = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
            for t in range(WORD * w, min(self.width, WORD * (w + 1))):
                word |= (x >= thr[t]).to(torch.int32) << (t - WORD * w)
            words.append(word)
        return torch.stack(words, dim=-1)


def random_pm1(generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Uniform random ±1 tensor (fair coin per element) from `generator`,
    on the generator's device.  Matches the reference in distribution
    only: a torch generator does not reproduce `jax.random` streams."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.uint8)
    return from_bits(bits, dtype)
