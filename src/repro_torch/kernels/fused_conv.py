"""Kernel 4: the entire deployed binary CNN in one fused packed-domain pass.

    per conv layer:  for every output position, XNOR-popcount of the k*k
                     taps of the channel-packed feature map against the
                     tap-major filter rows -> + C_o -> sign (0 -> +1)
                     -> repack into little-endian channel words
    flatten:         NHWC word concatenation (each position's channel words
                     padded to the word boundary) + the bias drive words
                     when the head is direct
    FC + head:       kernel 3's hidden-layer step and 33-threshold vote

Only the channel-packed input [B, S, S, Cw0] enters and only the [B, C]
int32 votes leave device memory.

Layout conventions (as the reference's `kernels/fused_conv.py`):
  * feature maps are channel-packed NHWC int32 words, channel bits
    little-endian within each pixel's words, zero-padded per pixel;
  * filter rows are tap-major: [c_out, k*k*Cw], word (dy*k + dx)*Cw + w
    holding tap (dy, dx)'s channel word w (`pack_conv_rows`);
  * the flatten keeps the per-position word padding, so the first FC
    layer's rows are packed with `pack_fc_rows_positionwise`.
  Pad bits are zero on both operands, so they never add to a distance.

`fused_conv_votes` launches the CUDA kernel of `csrc/fused_conv.cu` for
tensors on the card and runs `fused_conv_votes_plain` for tensors on the
CPU; `conv_stage_packed` is the same device code stopped after the
flatten (the query the noiseless cumulative staircase needs), beside
`conv_stage_packed_plain`.  They replace the Pallas kernel
`repro/kernels/fused_conv.py::fused_conv_votes` and its XLA twin
`conv_stage_packed`, and keep the reference's shape guards.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.binarize import (WORD, np_pack_bits, pack_bits,
                                       packed_width, popcount32,
                                       words_to_torch)
from repro_torch.kernels import _build
from repro_torch.kernels.binary_gemm import _check_words
from repro_torch.kernels.cam_search import (
    MAX_PASSES,
    THR_FLOAT,
    THR_INT,
    THR_SAMPLED,
    check_samples,
    normalize_thresholds,
)
from repro_torch.kernels.fused_mlp import (
    MAX_LAYERS,
    QUERIES_PER_WARP,
    SMEM_LIMIT,
    check_tail,
    fused_mlp_votes_plain,
    tail_arrays,
)

MAX_CONV = 8  # csrc/fused_conv.cu kMaxConv
STAGE = 3  # csrc/fused_conv.cu kStage: write the flattened query
QUERIES_PER_BLOCK = QUERIES_PER_WARP  # csrc/fused_conv.cu: a block holds kQ


@dataclasses.dataclass(frozen=True)
class ConvMeta:
    """Static shape info for one fused conv layer (square feature maps)."""

    side: int  # input feature-map side
    cw_in: int  # packed channel words per input pixel
    k: int  # kernel side
    stride: int
    out_side: int  # VALID output side
    c_out: int  # output channels = bits produced per position
    cw_out: int  # packed channel words per output pixel
    n_bits: int  # logical dot width: k * k * c_in


def conv_metas_for(conv_layers: Sequence, side: int) -> tuple[ConvMeta, ...]:
    """Static ConvMeta chain for a conv stack on `side` x `side` input."""
    metas = []
    s = side
    for layer in conv_layers:
        if s < layer.k:
            raise ValueError(
                f"feature side {s} < kernel {layer.k} (layer {len(metas)})"
            )
        out = (s - layer.k) // layer.stride + 1
        metas.append(ConvMeta(
            side=s,
            cw_in=packed_width(layer.c_in),
            k=layer.k,
            stride=layer.stride,
            out_side=out,
            c_out=layer.c_out,
            cw_out=packed_width(layer.c_out),
            n_bits=layer.n_bits,
        ))
        s = out
    return tuple(metas)


def pack_conv_rows(layer, device=None) -> torch.Tensor:
    """Folded conv filters -> tap-major packed rows [c_out, k*k*Cw] (int32).

    Each filter's bits are packed per tap along the channel axis (the
    feature map's per-pixel word padding), then taps concatenate in
    (dy, dx) scan order.
    """
    bits = (np.asarray(layer.weights_pm1) > 0).astype(np.uint8)
    c_out, k = layer.c_out, layer.k
    words = np_pack_bits(bits.reshape(c_out * k * k, layer.c_in))
    return words_to_torch(words.reshape(c_out, k * k * words.shape[-1]),
                          device)


def pack_fc_rows_positionwise(w_bits: np.ndarray, n_pos: int, c: int,
                              device=None) -> torch.Tensor:
    """FC rows [n_out, n_pos*c] {0,1} -> packed words matching the flatten.

    Bit (p, j) lands in word p*Cw + j//32: each position's channels are
    padded to the word boundary, as the conv flatten leaves them.  A plain
    `pack_bits` when c % 32 == 0.
    """
    n_out = w_bits.shape[0]
    if w_bits.shape[1] != n_pos * c:
        raise ValueError(
            f"rows have {w_bits.shape[1]} bits, expected {n_pos}*{c}"
        )
    words = np_pack_bits(
        np.asarray(w_bits, np.uint8).reshape(n_out * n_pos, c)
    )
    return words_to_torch(words.reshape(n_out, n_pos * words.shape[-1]),
                          device)


def bias_drive_words(bias_cells: int) -> np.ndarray:
    """Packed all-ones bias searchline words (uint32, logic '1' bits)."""
    return np_pack_bits(np.ones((1, bias_cells), np.uint8))[0]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU route; held against the kernel on the card)
# ---------------------------------------------------------------------------


def conv_hd_packed_plain(x: torch.Tensor, w: torch.Tensor,
                         m: ConvMeta) -> torch.Tensor:
    """Per-position Hamming distances of one packed conv layer.

    x: [B, S, S, Cw] int32; w: [c_out, k*k*Cw] tap-major rows.  Returns
    [B, O, O, c_out] int32.  Tap (dy, dx) is a strided slice of the map,
    XOR-popcounted word by word against the filters' tap words.
    """
    b = x.shape[0]
    hd = torch.zeros((b, m.out_side, m.out_side, m.c_out), dtype=torch.int32,
                     device=x.device)
    span = (m.out_side - 1) * m.stride + 1
    for dy in range(m.k):
        for dx in range(m.k):
            xs = x[:, dy:dy + span:m.stride, dx:dx + span:m.stride, :]
            t0 = (dy * m.k + dx) * m.cw_in
            for j in range(m.cw_in):
                hd += popcount32(xs[..., j, None] ^ w[:, t0 + j])
    return hd


def conv_layer_packed_plain(x: torch.Tensor, w: torch.Tensor,
                            c: torch.Tensor, m: ConvMeta) -> torch.Tensor:
    """One packed conv layer: [B, S, S, Cw] -> [B, O, O, Cw_out] int32."""
    y = (m.n_bits - 2 * conv_hd_packed_plain(x, w, m)) \
        + c.to(torch.int32)  # Eq. (3) pre-sign
    return pack_bits((y >= 0).to(torch.uint8))  # sign, 0 -> +1


def _query_width(metas, bias_cells: int, kw_q) -> int:
    """Words per flattened query: the flatten plus its bias words, or
    `kw_q` (the first FC/head operand's width, zero words after them)."""
    mf = metas[-1]
    flat_w = mf.out_side ** 2 * mf.cw_out + packed_width(bias_cells)
    if kw_q is None:
        return flat_w
    if flat_w > kw_q:
        raise ValueError(f"the flattened query has {flat_w} words, more "
                         f"than the first operand's {kw_q}")
    return kw_q


def conv_stage_packed_plain(x: torch.Tensor, conv_ws, conv_cs, metas,
                            bias_words=None, kw_q=None) -> torch.Tensor:
    """Conv stack + flatten: [B, S, S, Cw0] -> [B, n_pos*Cw_f (+ bias
    words)] int32, the flattened packed query the FC stage reads; with
    `kw_q`, zero words up to that width."""
    for w, c, m in zip(conv_ws, conv_cs, metas):
        x = conv_layer_packed_plain(x, w, c, m)
    q = x.reshape(x.shape[0], -1)
    if bias_words is not None:
        bw = words_to_torch(np.asarray(bias_words, np.uint32), q.device)
        q = torch.cat([q, bw.expand(q.shape[0], -1)], dim=-1)
    if kw_q is not None and kw_q > q.shape[1]:
        q = torch.nn.functional.pad(q, (0, kw_q - q.shape[1]))
    return q


def fused_conv_votes_plain(x_packed, conv_ws, conv_cs, conv_metas, layer_ws,
                           layer_cs, layer_n_bits, head_rows, thresholds, *,
                           bias_cells: int, head_direct: bool = False,
                           thr_samples=None) -> torch.Tensor:
    """Plain PyTorch version of `fused_conv_votes` (same arguments)."""
    bias_words = bias_drive_words(bias_cells) if head_direct else None
    kw_q = (layer_ws[0] if layer_ws else head_rows).shape[1]
    q = conv_stage_packed_plain(x_packed, conv_ws, conv_cs, conv_metas,
                                bias_words, kw_q)
    return fused_mlp_votes_plain(q, layer_ws, layer_cs, layer_n_bits,
                                 head_rows, thresholds, bias_cells=bias_cells,
                                 thr_samples=thr_samples)


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------


def _check_conv(x_packed, conv_ws, conv_cs, conv_metas) -> list:
    """The reference's conv guards, as ValueErrors; returns int32 C's."""
    if len(conv_ws) != len(conv_cs) or len(conv_ws) != len(conv_metas):
        raise ValueError("conv operand/meta length mismatch")
    if not conv_metas:
        raise ValueError("no conv layers — use fused_mlp.fused_mlp_votes")
    m0 = conv_metas[0]
    if x_packed.dtype != torch.int32 or tuple(x_packed.shape[1:]) != (
            m0.side, m0.side, m0.cw_in):
        raise ValueError(
            f"x_packed {x_packed.dtype} {tuple(x_packed.shape)} does not "
            f"match the first conv layer's int32 [B, {m0.side}, {m0.side}, "
            f"{m0.cw_in}]"
        )
    cs = []
    for i, (w, c, m) in enumerate(zip(conv_ws, conv_cs, conv_metas)):
        _check_words("conv rows", w)
        if tuple(w.shape) != (m.c_out, m.k * m.k * m.cw_in):
            raise ValueError(f"conv layer {i}: rows {tuple(w.shape)} != "
                             f"[{m.c_out}, {m.k * m.k * m.cw_in}]")
        c = torch.as_tensor(c, device=w.device).to(torch.int32)
        if tuple(c.shape) != (m.c_out,):
            raise ValueError(f"conv layer {i}: C shape {tuple(c.shape)}")
        if i and (m.side, m.cw_in) != (conv_metas[i - 1].out_side,
                                      conv_metas[i - 1].cw_out):
            raise ValueError(f"conv layer {i} does not chain to layer {i - 1}")
        cs.append(c.contiguous())
    return cs


def _flat_bias(conv_metas, layer_ws, bias_cells: int,
               head_direct: bool) -> int:
    """Bias drive bits after the flatten: bias_cells when the head reads
    the flatten directly, else 0 (the reference's head-direct guards)."""
    if not head_direct:
        if not layer_ws:
            raise ValueError("no FC layers and head_direct=False")
        return 0
    if layer_ws:
        raise ValueError("head_direct=True with FC hidden layers")
    if conv_metas[-1].c_out % WORD:
        raise ValueError(
            "conv -> head-direct needs a word-aligned flatten: last "
            f"conv c_out {conv_metas[-1].c_out} % 32 != 0"
        )
    return bias_cells


def _layout(conv_metas, kw_q: int, tail_kws: Sequence[int]):
    """Shared-memory layout of csrc/fused_conv.cu: (words per query of the
    two halves of the ping-pong pair, words of staged filter rows, bytes
    per block).  Map i (input 0, conv outputs, then each FC output) sits
    in half i % 2."""
    stages = ([conv_metas[0].side ** 2 * conv_metas[0].cw_in]
              + [m.out_side ** 2 * m.cw_out for m in conv_metas[:-1]]
              + [kw_q, *tail_kws])
    buf0, buf1 = max(stages[0::2]), max(stages[1::2])
    filt = sum(m.cw_out * WORD * ((m.k * m.k * m.cw_in) | 1)
               for m in conv_metas)
    nbytes = 4 * (MAX_PASSES + filt + QUERIES_PER_BLOCK * (buf0 + buf1))
    return buf0, buf1, nbytes


def _launch(x_packed, conv_ws, conv_cs, conv_metas, layer_ws, layer_cs,
            layer_n_bits, head_rows, thr, mode, thr_samples, bias_cells,
            flat_bias, kw_q, out, counted):
    """Launch csrc/fused_conv.cu on `out`'s device (guards already run);
    a launch adds one to `counted.launches`."""
    dev = x_packed.device
    if len(conv_metas) > MAX_CONV:
        raise ValueError(f"{len(conv_metas)} conv layers > the kernel's "
                         f"{MAX_CONV}")
    if len(layer_ws) > MAX_LAYERS:
        raise ValueError(f"{len(layer_ws)} FC layers > the kernel's "
                         f"{MAX_LAYERS}")
    tail_kws = [w.shape[1] for w in layer_ws[1:]] + (
        [head_rows.shape[1]] if layer_ws else [])
    buf0, buf1, nbytes = _layout(conv_metas, kw_q, tail_kws)
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"{QUERIES_PER_BLOCK} queries of this net need {nbytes} bytes "
            f"of shared memory, more than a block's {SMEM_LIMIT}"
        )
    tensors = [("head_rows", head_rows), ("thresholds", thr),
               ("thr_samples", thr_samples),
               *[("conv rows", w) for w in conv_ws],
               *[("conv C", c) for c in conv_cs],
               *[("layer weights", w) for w in layer_ws],
               *[("layer C", c) for c in layer_cs]]
    for name, t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, input on {dev}")
    b = x_packed.shape[0]
    if b == 0:
        return out
    x, head = x_packed.contiguous(), head_rows.contiguous()
    conv_ws = [w.contiguous() for w in conv_ws]
    layer_ws = [w.contiguous() for w in layer_ws]
    n_conv = len(conv_metas)
    cw_ptrs = (ctypes.c_void_p * n_conv)(*[w.data_ptr() for w in conv_ws])
    cc_ptrs = (ctypes.c_void_p * n_conv)(*[c.data_ptr() for c in conv_cs])
    meta = (ctypes.c_int * (8 * n_conv))(*[
        v for m in conv_metas for v in (m.side, m.cw_in, m.k, m.stride,
                                        m.out_side, m.c_out, m.cw_out,
                                        m.n_bits)])
    tail = tail_arrays(layer_ws, layer_cs, layer_n_bits)
    addr = ctypes.addressof
    lib = _build.library("fused_conv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_conv_launch(
            x.data_ptr(), b, n_conv, addr(cw_ptrs), addr(cc_ptrs),
            addr(meta), len(layer_ws), *map(addr, tail), head.data_ptr(),
            head.shape[0], head.shape[1], bias_cells, flat_bias, kw_q, buf0,
            buf1, thr.data_ptr(), mode, thr.shape[0],
            None if thr_samples is None else thr_samples.data_ptr(),
            out.data_ptr(), stream,
        )
    _build.check(lib, err, "fused_conv")
    counted.launches += 1
    return out


def fused_conv_votes(x_packed: torch.Tensor,
                     conv_ws: Sequence[torch.Tensor],
                     conv_cs: Sequence[torch.Tensor],
                     conv_metas: Sequence[ConvMeta],
                     layer_ws: Sequence[torch.Tensor],
                     layer_cs: Sequence[torch.Tensor],
                     layer_n_bits: Sequence[int],
                     head_rows: torch.Tensor,
                     thresholds: torch.Tensor, *,
                     bias_cells: int,
                     head_direct: bool = False,
                     thr_samples: torch.Tensor | None = None) -> torch.Tensor:
    """Fused end-to-end binary-CNN vote counts (one launch per batch).

    x_packed    : [B, S, S, Cw0] int32 — channel-packed encoded input
                  (`InputEncoding.pack`)
    conv_ws     : per conv layer [c_out, k*k*Cw] tap-major packed rows
                  (`pack_conv_rows`)
    conv_cs     : per conv layer [c_out] int32 folded BN constants
    conv_metas  : the `conv_metas_for` chain (shapes/strides)
    layer_ws    : FC-stage packed rows; the first must be
                  `pack_fc_rows_positionwise` (flatten alignment)
    layer_cs / layer_n_bits / head_rows / thresholds / bias_cells /
    thr_samples : exactly as in `fused_mlp.fused_mlp_votes`
    head_direct : True when there are no FC hidden layers — the flatten
                  (word-aligned: last conv c_out % 32 == 0) feeds the
                  head, with the bias drive words appended
    returns     : [B, C] int32 vote counts (== ref.conv_votes_ref)

    CUDA tensors launch the kernel (counted in `fused_conv_votes.launches`);
    CPU tensors take the plain version.
    """
    layer_n_bits = tuple(int(n) for n in layer_n_bits)
    conv_cs = _check_conv(x_packed, conv_ws, conv_cs, conv_metas)
    layer_cs = check_tail(layer_ws, layer_cs, layer_n_bits, head_rows,
                          bias_cells)
    flat_bias = _flat_bias(conv_metas, layer_ws, bias_cells, head_direct)
    kw_q = _query_width(conv_metas, flat_bias,
                        (layer_ws[0] if layer_ws else head_rows).shape[1])
    thr = normalize_thresholds(thresholds).to(x_packed.device)
    n_classes = head_rows.shape[0]
    if thr_samples is not None:
        if tuple(thr_samples.shape[1:]) != (n_classes, thr.shape[0]):
            raise ValueError(
                f"thr_samples shape {tuple(thr_samples.shape)} != "
                f"[B, {n_classes}, {thr.shape[0]}]"
            )
        thr_samples = check_samples(thr_samples, x_packed.shape[0],
                                    n_classes, thr.shape[0])
    dev = x_packed.device
    if dev.type == "cpu":
        return fused_conv_votes_plain(
            x_packed, conv_ws, conv_cs, conv_metas, layer_ws, layer_cs,
            layer_n_bits, head_rows, thr, bias_cells=bias_cells,
            head_direct=head_direct, thr_samples=thr_samples)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if thr_samples is not None:
        mode = THR_SAMPLED
    else:
        mode = THR_FLOAT if thr.is_floating_point() else THR_INT
    out = torch.empty((x_packed.shape[0], n_classes), dtype=torch.int32,
                      device=dev)
    _launch(x_packed, conv_ws, conv_cs, conv_metas, layer_ws, layer_cs,
            layer_n_bits, head_rows, thr.contiguous(), mode, thr_samples,
            bias_cells, flat_bias, kw_q, out, fused_conv_votes)
    return out


fused_conv_votes.launches = 0


def conv_stage_packed(x_packed: torch.Tensor,
                      conv_ws: Sequence[torch.Tensor],
                      conv_cs: Sequence[torch.Tensor],
                      conv_metas: Sequence[ConvMeta], *,
                      bias_cells: int = 0,
                      kw_q: int | None = None) -> torch.Tensor:
    """Conv stack + flatten: [B, S, S, Cw0] -> [B, n_pos*Cw_f (+ bias
    words)] int32, the packed query of the FC stage (or, with
    `bias_cells` > 0, of a head read directly; word-aligned flatten
    required).  With `kw_q` (the first FC/head operand's width) the rows
    are zero-filled up to it.

    CUDA tensors launch kernel 4 in its stage mode (counted in
    `conv_stage_packed.launches`); CPU tensors take
    `conv_stage_packed_plain`.
    """
    conv_cs = _check_conv(x_packed, conv_ws, conv_cs, conv_metas)
    mf = conv_metas[-1]
    if bias_cells and mf.c_out % WORD:
        raise ValueError(
            "bias words after the flatten need a word-aligned flatten: "
            f"last conv c_out {mf.c_out} % 32 != 0"
        )
    bias_words = bias_drive_words(bias_cells) if bias_cells else None
    kw_q = _query_width(conv_metas, bias_cells, kw_q)
    dev = x_packed.device
    if dev.type == "cpu":
        return conv_stage_packed_plain(x_packed, conv_ws, conv_cs,
                                       conv_metas, bias_words, kw_q)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((x_packed.shape[0], kw_q), dtype=torch.int32,
                      device=dev)
    no_head = torch.empty((0, 1), dtype=torch.int32, device=dev)
    no_thr = torch.empty((0,), dtype=torch.int32, device=dev)
    _launch(x_packed, conv_ws, conv_cs, conv_metas, [], [], (), no_head,
            no_thr, STAGE, None, 0, bias_cells, kw_q, out, conv_stage_packed)
    return out


conv_stage_packed.launches = 0
