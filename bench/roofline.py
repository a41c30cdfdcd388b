"""The table of peaks and the work of each kernel and of a whole step,
counted from shapes alone (never from the program's objects).

A bound is the least time the card could take for a piece of work: the
largest of its bytes over the card's memory bandwidth, its bit
operations over the 1-bit tensor-core rate and its floating-point
operations over the dense bfloat16 tensor-core rate.  Each input byte
counts once as read and each output byte once as written, whatever a
kernel reads again; a packed operand counts at its bits (a thermometer-4
pixel is 4 bits, whatever word the program keeps it in); a binary layer
costs one XNOR-popcount MAC per weight bit per row, and the CAM head's
distance counts once, not once per pass.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet: memory bandwidth.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9  # the card's maximum SM clock (nvidia-smi clocks.max.sm)
# MEASURED, not published: the repository's probe of `wgmma .b1
# .and.popc` m64n256k256 read 29,768 bit-MACs a clock an SM on this card
# (NVIDIA H100 80GB HBM3, 700 W); NVIDIA publishes no 1-bit rate for it.
B1_MACS_PER_CLK_SM = 29768
B1_MACS_PER_S = B1_MACS_PER_CLK_SM * SMS * SM_CLOCK_HZ
# NVIDIA H100 SXM data sheet: 1,979 TFLOP/s of bfloat16 with sparsity,
# so 989.5 dense.  A multiply-add counts as two operations.
BF16_FLOPS_PER_S = 989.5e12

WORD_BYTES = 4  # an int32 constant, distance or vote


def packed(rows: int, bits: int) -> float:
    """Bytes of `rows` packed binary rows of `bits` bits each."""
    return rows * bits / 8


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved, bit-MACs and floating-point operations done by one
    piece of work."""

    nbytes: float
    bitops: float
    flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.nbytes + other.nbytes, self.bitops + other.bitops,
                    self.flops + other.flops)

    def _terms(self) -> dict:
        return {"bytes": self.nbytes / HBM_BYTES_PER_S,
                "operations": self.bitops / B1_MACS_PER_S,
                "flops": self.flops / BF16_FLOPS_PER_S}

    def bound_s(self) -> float:
        """Least seconds on the card: the largest of the three terms."""
        return max(self._terms().values())

    def bound_by(self) -> str:
        """Which term sets the bound: "bytes", "operations" (bit-MACs) or
        "flops"; on a tie, the first of these."""
        terms = self._terms()
        return max(terms, key=terms.get)


def gemm_hd(m: int, n: int, n_bits: int) -> Work:
    """Kernel 1 (`binary_gemm_hd`): distances [m, n] int32 of m packed
    queries against n packed rows of `n_bits` bits."""
    return Work(packed(m + n, n_bits) + WORD_BYTES * m * n, m * n * n_bits)


def fc_tail(b: int, hidden: list, head_bits: int, n_classes: int,
            n_passes: int) -> Work:
    """The FC layers and the head's vote on b packed queries, the queries'
    own bytes left out: rows and C's read, [b, classes] votes written.
    `hidden` is [(n_out, n_bits)] per FC layer."""
    nbytes = bitops = 0
    for n_out, n_bits in hidden:
        nbytes += packed(n_out, n_bits) + WORD_BYTES * n_out
        bitops += b * n_out * n_bits
    nbytes += packed(n_classes, head_bits) + WORD_BYTES * (
        n_passes + b * n_classes)
    bitops += b * n_classes * head_bits
    return Work(nbytes, bitops)


def conv_stack(b: int, side: int, convs: list) -> Work:
    """The conv layers on b images of `side` x `side` pixels: `convs` is
    [(k, stride, c_in, c_out)]; the filter rows and C's are read.  Neither
    the input nor the output is counted: the caller adds what enters and
    leaves the kernel."""
    nbytes = bitops = 0
    s = side
    for k, stride, c_in, c_out in convs:
        out = (s - k) // stride + 1
        nbytes += packed(c_out, k * k * c_in) + WORD_BYTES * c_out
        bitops += b * out * out * c_out * k * k * c_in
        s = out
    return Work(nbytes, bitops)


def model_shapes(cfg: dict) -> dict:
    """The shapes a configuration file states, in one form: the input
    width, the conv stack, the FC layers as (n_out, n_bits), the head's
    row bits and the classes."""
    bias = cfg["bias_cells"]
    if cfg["model"] == "mlp":
        sizes = cfg["layer_sizes"]
        return dict(n_in=sizes[0], side=None, convs=[],
                    hidden=list(zip(sizes[1:-1], sizes[:-2])),
                    head_bits=sizes[-2] + bias, n_classes=sizes[-1],
                    n_passes=len(cfg["thresholds"]))
    side, c_in, convs = cfg["side"], cfg["encoding"]["width"], []
    for layer in cfg["conv"]:
        convs.append((layer["k"], layer["stride"], c_in, layer["c_out"]))
        side = (side - layer["k"]) // layer["stride"] + 1
        c_in = layer["c_out"]
    sizes = [side * side * c_in, *cfg["hidden"], cfg["n_classes"]]
    return dict(n_in=cfg["side"] ** 2, side=cfg["side"], convs=convs,
                hidden=list(zip(sizes[1:-1], sizes[:-2])),
                head_bits=sizes[-2] + bias, n_classes=sizes[-1],
                n_passes=len(cfg["thresholds"]))


def fused_mlp(cfg: dict, b: int) -> Work:
    """Kernel 3 (`fused_mlp_votes`) on b packed ±1 rows."""
    s = model_shapes(cfg)
    first_bits = s["hidden"][0][1] if s["hidden"] else s["head_bits"]
    return Work(packed(b, first_bits), 0) + fc_tail(
        b, s["hidden"], s["head_bits"], s["n_classes"], s["n_passes"])


def fused_conv(cfg: dict, b: int) -> Work:
    """Kernel 4 (`fused_conv_votes`, the votes entry) on b images, each
    pixel entering as its encoding's bits."""
    s = model_shapes(cfg)
    pixels = Work(packed(b, s["side"] ** 2 * s["convs"][0][2]), 0)
    return pixels + conv_stack(b, s["side"], s["convs"]) + fc_tail(
        b, s["hidden"], s["head_bits"], s["n_classes"], s["n_passes"])


def hd_once_gemms(cfg: dict, b: int) -> Work:
    """Kernel 1's launches of one call on the HD-once route: one per FC
    layer and one for the head, each at its own shapes."""
    s = model_shapes(cfg)
    total = Work(0, 0)
    for n_out, n_bits in s["hidden"]:
        total = total + gemm_hd(b, n_out, n_bits)
    return total + gemm_hd(b, s["n_classes"], s["head_bits"])


def step(cfg: dict, b: int, key_bytes_per_row: int = 0) -> Work:
    """The model's work for one batch, whatever implements it: the user's
    float32 rows as handed in (and their key words), the packed weights
    and C's of every layer, the head's rows and thresholds, the votes
    written, and every layer's bit-MACs."""
    s = model_shapes(cfg)
    w = Work(4 * b * s["n_in"] + key_bytes_per_row * b, 0)
    if s["convs"]:
        w = w + conv_stack(b, s["side"], s["convs"])
    return w + fc_tail(b, s["hidden"], s["head_bits"], s["n_classes"],
                       s["n_passes"])
