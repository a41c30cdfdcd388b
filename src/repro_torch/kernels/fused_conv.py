"""Kernel 4: the entire deployed binary CNN in one fused packed-domain pass.

    per conv layer:  for every output position, XNOR-popcount of the k*k
                     taps of the channel-packed feature map against the
                     tap-major filter rows -> + C_o -> sign (0 -> +1)
                     -> repack into little-endian channel words
    flatten:         NHWC word concatenation (each position's channel words
                     padded to the word boundary) + the bias drive words
                     when the head is direct
    FC + head:       kernel 3's hidden-layer step and 33-threshold vote
                     (the same function, on the tensor cores)

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
import functools
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
    SMEM_LIMIT,
    check_tail,
    fused_mlp_votes_plain,
    tail_arrays,
)

MAX_CONV = 8  # csrc/fused_conv.cu kMaxConv
STAGE = 3  # csrc/fused_conv.cu kStage: write the flattened query
QUERIES_PER_BLOCK = 16  # csrc/fused_conv.cu kQB: one m16 tile of queries


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
# the kernel's dense tap layout (csrc/fused_conv.cu), built on the host
# ---------------------------------------------------------------------------


def dense_pitch(c_in: int) -> int:
    """Bits a tap takes in a dense K vector: c_in rounded up to a power of
    two up to 16, so that taps never straddle a word; whole channel words
    above 16."""
    if c_in <= 16:
        return 1 << (c_in - 1).bit_length()
    return WORD * -(-c_in // WORD)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """How the kernel builds one conv layer's dense K vectors.

    On the compacted input (`store` == `pitch` < 32 bits a pixel) a
    position's K vector holds its k*k taps at `pitch` bits each (zero
    above c_in); each kernel row dy starts a new word and fills
    ceil(k*pitch/32) words, 32/pitch taps a word.  Other layers take
    whole channel words (pitch = store = 32*Cw): word d is channel word
    d % Cw of tap d // Cw.  Either way dense word d is one run of the
    map: `runs[d]` = (src, n), the n bits at bit base + src (base = the
    position's first pixel times `store`).  The kernel tabulates the same
    runs per block (csrc/fused_conv.cu `dense_word`).
    """

    pitch: int
    store: int
    words: int
    runs: tuple  # per dense word, (src, n)

    @property
    def ksteps(self) -> int:
        """256-bit tensor-core K steps."""
        return -(-self.words // 8)


def conv_c_in(m: ConvMeta) -> int:
    """Logical input channels of a conv layer."""
    return m.n_bits // (m.k * m.k)


@functools.lru_cache(maxsize=None)
def dense_plan(m: ConvMeta, compact: bool) -> DensePlan:
    """The dense plan of layer `m`; `compact`: its input map holds
    `dense_pitch(c_in)` < 32 bits a pixel (the kernel's first layer when
    c_in <= 16), else whole channel words."""
    if not compact:
        pitch = WORD * m.cw_in
        runs = tuple(
            ((((tap // m.k) * m.side + tap % m.k) * m.cw_in + j) * WORD,
             WORD)
            for tap in range(m.k * m.k) for j in range(m.cw_in))
        return DensePlan(pitch, pitch, len(runs), runs)
    pitch = dense_pitch(conv_c_in(m))
    if pitch >= WORD:
        raise ValueError(f"{conv_c_in(m)} channels cannot be compacted")
    per = WORD // pitch  # taps a word
    runs = tuple(((dy * m.side + dx0) * pitch, min(per, m.k - dx0) * pitch)
                 for dy in range(m.k) for dx0 in range(0, m.k, per))
    return DensePlan(pitch, pitch, len(runs), runs)


def dense_plans(metas) -> tuple[DensePlan, ...]:
    """The kernel's plans for a conv stack (the input map compacted
    where c_in <= 16)."""
    return tuple(dense_plan(m, i == 0 and dense_pitch(conv_c_in(m)) < WORD)
                 for i, m in enumerate(metas))


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 words as their uint32 values, in int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 words of their bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def compact_map_plain(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """[B, S, S, 1] int32 maps -> [B, ceil(S*S*pitch/32)] int32 words,
    `pitch` bits a pixel (the kernel's compacted input map)."""
    b = x.shape[0]
    bits = _u32(x.reshape(b, -1)) & ((1 << pitch) - 1)
    per = WORD // pitch
    bits = torch.nn.functional.pad(bits, (0, -bits.shape[1] % per))
    shifts = torch.arange(per, device=x.device) * pitch
    return _i32((bits.reshape(b, -1, per) << shifts).sum(-1))


def dense_rows_plain(maps: torch.Tensor, m: ConvMeta,
                     plan: DensePlan) -> torch.Tensor:
    """The dense K vectors the kernel builds: [B, words] int32 maps (as
    the plan's `store` lays them out) -> [B, out_side**2, plan.words]."""
    b, dev = maps.shape[0], maps.device
    mp = torch.nn.functional.pad(_u32(maps), (0, 1))  # the +1 word read
    o = torch.arange(m.out_side, device=dev) * m.stride
    base = ((o[:, None] * m.side + o[None, :]) * plan.store).reshape(-1)
    out = torch.zeros((b, base.shape[0], plan.words), dtype=torch.int64,
                      device=dev)
    for d, (src, n) in enumerate(plan.runs):
        a = base + src
        lo, hi = mp[:, a >> 5], mp[:, (a >> 5) + 1]
        out[..., d] = ((hi << 32 | lo) >> (a & 31)) & ((1 << n) - 1)
    return _i32(out)


def dense_filter_rows_plain(w: torch.Tensor, m: ConvMeta,
                            plan: DensePlan) -> torch.Tensor:
    """Tap-major rows [c_out, k*k*Cw] -> the dense rows [c_out, words]
    the kernel stages in shared memory."""
    if plan.pitch >= WORD:
        return w.clone()
    per = WORD // plan.pitch
    wr = plan.words // m.k  # words a kernel row
    taps = _u32(w).reshape(w.shape[0], m.k, m.k) & ((1 << plan.pitch) - 1)
    taps = torch.nn.functional.pad(taps, (0, wr * per - m.k))
    shifts = torch.arange(per, device=w.device) * plan.pitch
    return _i32((taps.reshape(w.shape[0], plan.words, per) << shifts).sum(-1))


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


def _round_ld(words: int) -> int:
    """A query stride of 4 mod 8 words: the FC stages' fragment loads
    (rows g, words t / t+4) then hit 32 banks."""
    return words + (4 - words) % 8


@functools.lru_cache(maxsize=64)
def _layout(conv_metas: tuple, kw_q: int, tail_kws: tuple):
    """Shared-memory layout of csrc/fused_conv.cu: (words per query of the
    two halves of the ping-pong pair, bytes per block, the conv layers'
    meta ints as the launcher takes them).  Map i (the compacted input 0,
    conv outputs, then each FC output) sits in half i % 2; before the
    maps, the word table (a run's first bit and mask per dense word), the
    dense filter rows at a stride of ksteps*8 + 4 words, and each layer's
    position and channel tables.  Cached: it depends on the shapes only."""
    plans = dense_plans(conv_metas)
    m0, p0 = conv_metas[0], plans[0]
    stages = ([-(-m0.side ** 2 * p0.store // WORD)]
              + [m.out_side ** 2 * m.cw_out for m in conv_metas[:-1]]
              + [kw_q, *tail_kws])
    buf0 = _round_ld(max(stages[0::2]))
    buf1 = _round_ld(max(stages[1::2]))
    table = 2 * sum(p.words for p in plans)
    filt = sum(m.cw_out * WORD * (p.ksteps * 8 + 4)
               for m, p in zip(conv_metas, plans))
    # per layer: each position's first pixel (m16 tiles), and each
    # channel's largest distance that sets its bit
    tables = sum(16 * -(-m.out_side ** 2 // 16) + WORD * m.cw_out
                 for m in conv_metas)
    nbytes = 4 * (MAX_PASSES + table + filt + tables
                  + QUERIES_PER_BLOCK * (buf0 + buf1) + 1)
    meta = tuple(v for m in conv_metas
                 for v in (m.side, m.cw_in, m.k, m.stride, m.out_side,
                           m.c_out, m.cw_out, m.n_bits))
    return buf0, buf1, nbytes, meta


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
    tail_kws = tuple(w.shape[1] for w in layer_ws[1:]) + (
        (head_rows.shape[1],) if layer_ws else ())
    buf0, buf1, nbytes, meta_ints = _layout(tuple(conv_metas), kw_q,
                                            tail_kws)
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
    meta = (ctypes.c_int * len(meta_ints))(*meta_ints)
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
