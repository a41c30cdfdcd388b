"""Kernel 3: the entire deployed binary MLP in one fused packed-domain pass.

    per hidden layer:  XNOR-popcount matvec over packed rows -> + C_j
                       -> sign (0 -> +1) -> repack into little-endian words
                       (the last hidden layer appends the bias drive ones)
    head:              Hamming distance to the class rows, P-threshold vote

Only the packed input enters and only the [B, C] int32 votes leave device
memory.  `fused_mlp_votes` launches the CUDA kernel of
`csrc/fused_mlp.cu` (the block program of `csrc/mlp_block.cuh` on the
FC/head stage of `csrc/fc_stage.cuh`, on the 1-bit tensor cores) for tensors on the card
and runs `fused_mlp_votes_plain`, the same arithmetic in plain PyTorch,
for tensors on the CPU.  `sign_limit` is the host twin of the kernel's
sign epilogue.  It replaces the Pallas kernel
`repro/kernels/fused_mlp.py::fused_mlp_votes` and keeps its shape guards.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core.binarize import WORD, pack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.binary_gemm import _check_words, binary_gemm_hd_plain
from repro_torch.kernels.cam_search import (
    MAX_PASSES,
    SMEM_LIMIT,
    THR_FLOAT,
    THR_INT,
    THR_SAMPLED,
    check_samples,
    normalize_thresholds,
    vote_from_hd,
    vote_table_len,
)

MAX_LAYERS = 8  # csrc/picbnn.cuh kMaxLayers
QUERY_TILE = 16  # csrc/mlp_block.cuh: a tile holds whole m16 tiles
ROWS_SMEM_MIN = 32 * 1024  # csrc/mlp_block.cuh kRowsSmemMin


def _validate(x_packed, layer_ws, layer_cs, layer_n_bits, head_rows,
              bias_cells: int):
    """The reference's shape guards, as ValueErrors; returns int32 C's."""
    _check_words("x_packed", x_packed)
    cs = check_tail(layer_ws, layer_cs, layer_n_bits, head_rows, bias_cells)
    # the input must line up with its first operand: a head-only query
    # packed WITHOUT the bias drive bits would otherwise truncate the
    # distance loop and return wrong votes
    first_kw = (layer_ws[0] if layer_ws else head_rows).shape[1]
    if x_packed.shape[1] != first_kw:
        raise ValueError(
            f"x_packed width {x_packed.shape[1]} does not match the first "
            f"operand's packed width {first_kw}; for a head-only net the "
            "query must include the bias drive bits (cam.query_with_bias)"
        )
    return cs


def check_tail(layer_ws, layer_cs, layer_n_bits, head_rows,
               bias_cells: int) -> list:
    """Shape guards of the FC layers and head (shared with kernel 4);
    returns the C's as contiguous int32 tensors on their rows' devices."""
    if len(layer_ws) != len(layer_cs) or len(layer_ws) != len(layer_n_bits):
        raise ValueError("layer_ws / layer_cs / layer_n_bits length mismatch")
    _check_words("head_rows", head_rows)
    for w in layer_ws:
        _check_words("layer weight rows", w)
    cs = []
    for i, (w, c, n_bits) in enumerate(zip(layer_ws, layer_cs, layer_n_bits)):
        c = torch.as_tensor(c, device=w.device).to(torch.int32)
        if tuple(c.shape) != (w.shape[0],):
            raise ValueError(f"layer {i}: C shape {tuple(c.shape)} != "
                             f"[{w.shape[0]}]")
        if not 0 < n_bits <= w.shape[1] * WORD:
            raise ValueError(f"layer {i}: n_bits {n_bits} does not fit "
                             f"{w.shape[1]} words")
        # each repack target must hold the produced bits
        if i + 1 < len(layer_ws):
            room, need = layer_ws[i + 1].shape[1] * WORD, w.shape[0]
        else:
            room, need = head_rows.shape[1] * WORD, w.shape[0] + bias_cells
        if need > room:
            raise ValueError(f"layer {i}: {need} output bits do not fit the "
                             f"next operand's {room}")
        cs.append(c.contiguous())
    if not layer_ws and bias_cells > head_rows.shape[1] * WORD:
        raise ValueError("bias_cells exceed the head row width")
    return cs


def tail_arrays(ws, cs, layer_n_bits) -> tuple:
    """The FC layers as the launchers read them (picbnn.cuh `fill_tail`):
    C arrays of row pointers, C pointers, n_bits, n_out and words per row.
    The caller keeps the tuple alive across the launch."""
    k = max(len(ws), 1)
    return ((ctypes.c_void_p * k)(*[w.data_ptr() for w in ws]),
            (ctypes.c_void_p * k)(*[c.data_ptr() for c in cs]),
            (ctypes.c_int * k)(*layer_n_bits),
            (ctypes.c_int * k)(*[w.shape[0] for w in ws]),
            (ctypes.c_int * k)(*[w.shape[1] for w in ws]))


def sign_limit(n_bits: int, c) -> torch.Tensor:
    """Host twin of the FC stage's sign epilogue (csrc/fc_stage.cuh
    `fc_layer`): the largest distance whose bit is set, (n_bits + C) >> 1
    as int32.  The shift is arithmetic, so a negative n_bits + C gives a
    negative limit and sets no bit; `hd <= sign_limit(n_bits, C)` is the
    reference's `n_bits - 2*hd + C >= 0` for every integer hd."""
    return (n_bits + torch.as_tensor(c).to(torch.int32)) >> 1


def block_smem_bytes(kw0: int, later_kws, bq: int, vtab_n: int,
                     row_shapes) -> tuple:
    """Shared memory of kernel 3's block program
    (csrc/mlp_block.cuh `mlp_base_words`, picbnn.cuh `fill_tail`):
    (bytes besides the rows, bytes of the rows).  Besides the rows: the
    [P] schedule, the vote table, two input tiles of bq queries at a
    stride of round8(kw0) + 4 words, and two activation buffers at the
    widest later operand's.  The rows: each [n, kw] block padded to round8(n) rows at
    round8(kw) + 4 words."""
    def r8(n):
        return -(-n // 8) * 8

    ld_act = max([r8(kw) + 4 for kw in later_kws], default=0)
    base = (MAX_PASSES + -(-vtab_n // 4) * 4
            + 2 * bq * (r8(kw0) + 4 + ld_act))
    rows = sum(r8(n) * (r8(kw) + 4) for n, kw in row_shapes)
    return 4 * base, 4 * rows


def rows_in_smem(base: int, rows: int) -> bool:
    """Whether the block program stages its rows in shared memory (else
    the stage reads them from global memory): rows of ROWS_SMEM_MIN bytes
    or more that fit beside the rest (`block_smem_bytes`)."""
    return ROWS_SMEM_MIN <= rows and base + rows <= SMEM_LIMIT


def mlp_smem_bytes(kw0: int, layer_ws, head_rows, bq: int,
                   sampled: bool) -> tuple:
    """Kernel 3's shared memory per block (csrc/mlp_block.cuh
    `mlp_launch`): (bytes besides the rows, bytes of every layer's rows
    and the head's).  `rows_in_smem` says where the rows go."""
    later = [w.shape[1] for w in layer_ws[1:]] + (
        [head_rows.shape[1]] if layer_ws else [])
    return block_smem_bytes(
        kw0, later, bq, vote_table_len(head_rows.shape[1], sampled),
        [tuple(w.shape) for w in (*layer_ws, head_rows)])


def fused_mlp_votes_plain(x_packed, layer_ws, layer_cs, layer_n_bits,
                          head_rows, thresholds, *, bias_cells: int,
                          thr_samples=None):
    """Plain PyTorch version of `fused_mlp_votes` (same arguments)."""
    q = x_packed
    n = len(layer_ws)
    for i, (w, c, n_bits) in enumerate(zip(layer_ws, layer_cs, layer_n_bits)):
        hd = binary_gemm_hd_plain(q, w)
        y = (n_bits - 2 * hd) + c.to(torch.int32)[None, :]  # Eq. (3)
        bits = (y >= 0).to(torch.uint8)  # sign, 0 -> +1
        if i + 1 < n:
            tail_kw, tail_bias = layer_ws[i + 1].shape[1], 0
        else:
            tail_kw, tail_bias = head_rows.shape[1], bias_cells
        b = bits.shape[0]
        parts = [bits]
        if tail_bias:  # bias searchlines always driven to logic '1'
            parts.append(torch.ones((b, tail_bias), dtype=torch.uint8,
                                    device=bits.device))
        pad = tail_kw * WORD - w.shape[0] - tail_bias
        if pad:
            parts.append(torch.zeros((b, pad), dtype=torch.uint8,
                                     device=bits.device))
        q = pack_bits(torch.cat(parts, dim=-1))
    thr = normalize_thresholds(thresholds).to(q.device)
    if thr_samples is not None:
        thr_samples = check_samples(thr_samples, q.shape[0],
                                    head_rows.shape[0], thr.shape[0])
    return vote_from_hd(binary_gemm_hd_plain(q, head_rows), thr, thr_samples)


def fused_mlp_votes(x_packed: torch.Tensor,
                    layer_ws: Sequence[torch.Tensor],
                    layer_cs: Sequence[torch.Tensor],
                    layer_n_bits: Sequence[int],
                    head_rows: torch.Tensor,
                    thresholds: torch.Tensor, *,
                    bias_cells: int, bq: int = 32,
                    thr_samples: torch.Tensor | None = None) -> torch.Tensor:
    """Fused end-to-end deployed-BNN vote counts.

    x_packed    : [B, Kw0] int32 — packed ±1 input activations
    layer_ws    : per hidden layer [N_l, Kw_l] int32 packed weight rows
    layer_cs    : per hidden layer [N_l] int32 folded BN constants
    layer_n_bits: per hidden layer logical input bit count
    head_rows   : [C, Kw_h] int32 packed class rows (bias cells included)
    thresholds  : [P] HD tolerances (int32, or float32 compared as float)
    bias_cells  : bias searchlines appended to the head query
    bq          : queries a block holds at once on the card (a tile of
                  bq / 16 m16 tiles; a multiple of 16); blocks walk the
                  batch's tiles
    thr_samples : optional [B, C, P] float32 sampled thresholds
    returns     : [B, C] int32 vote counts

    With no hidden layers `x_packed` must already be the head query
    (`cam.query_with_bias`).  CUDA tensors launch the kernel (counted in
    `fused_mlp_votes.launches`); CPU tensors take the plain version.
    """
    layer_n_bits = tuple(int(n) for n in layer_n_bits)
    cs = _validate(x_packed, layer_ws, layer_cs, layer_n_bits, head_rows,
                   bias_cells)
    dev = x_packed.device
    if dev.type == "cpu":
        return fused_mlp_votes_plain(x_packed, layer_ws, cs, layer_n_bits,
                                     head_rows, thresholds,
                                     bias_cells=bias_cells,
                                     thr_samples=thr_samples)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_layers = len(layer_ws)
    if n_layers > MAX_LAYERS:
        raise ValueError(f"{n_layers} hidden layers > the kernel's "
                         f"{MAX_LAYERS}")
    if bq <= 0 or bq % QUERY_TILE:
        raise ValueError(f"bq must be a positive multiple of "
                         f"{QUERY_TILE}, got {bq}")
    b, kw0 = x_packed.shape
    n_classes, kw_head = head_rows.shape
    kws = [w.shape[1] for w in layer_ws]
    max_kw = max([kw0, kw_head, *kws])
    base, _ = mlp_smem_bytes(kw0, layer_ws, head_rows, bq,
                             thr_samples is not None)
    if base > SMEM_LIMIT:  # even with the rows read from global memory
        raise ValueError(f"bq {bq} x {max_kw} words overflows shared memory")
    thr = normalize_thresholds(thresholds).to(dev).contiguous()
    p = thr.shape[0]
    if thr_samples is not None:
        thr_samples = check_samples(thr_samples, b, n_classes, p)
        mode, samples_ptr = THR_SAMPLED, thr_samples.data_ptr()
    else:
        mode = THR_FLOAT if thr.is_floating_point() else THR_INT
        samples_ptr = None
    ws = [w.contiguous() for w in layer_ws]
    for name, t in [("head_rows", head_rows), ("thr_samples", thr_samples),
                    *[("layer weights", w) for w in ws],
                    *[("layer C", c) for c in cs]]:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, input on {dev}")
    out = torch.empty((b, n_classes), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    x, head = x_packed.contiguous(), head_rows.contiguous()
    tail = tail_arrays(ws, cs, layer_n_bits)
    lib = _build.library("fused_mlp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_mlp_votes_launch(
            x.data_ptr(), b, kw0, n_layers, *map(ctypes.addressof, tail),
            head.data_ptr(), n_classes, kw_head, bias_cells, thr.data_ptr(),
            mode, p, samples_ptr, out.data_ptr(), bq, stream,
        )
    _build.check(lib, err, "fused_mlp_votes")
    fused_mlp_votes.launches += 1
    return out


fused_mlp_votes.launches = 0
