"""Kernel 3: the entire deployed binary MLP in one fused packed-domain pass.

    per hidden layer:  XNOR-popcount matvec over packed rows -> + C_j
                       -> sign (0 -> +1) -> repack into little-endian words
                       (the last hidden layer appends the bias drive ones)
    head:              Hamming distance to the class rows, P-threshold vote

Only the packed input enters and only the [B, C] int32 votes leave device
memory.  `fused_mlp_votes` launches the CUDA kernel of
`csrc/fused_mlp.cu` for tensors on the card and runs
`fused_mlp_votes_plain`, the same arithmetic in plain PyTorch, for
tensors on the CPU.  It replaces the Pallas kernel
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
    THR_FLOAT,
    THR_INT,
    THR_SAMPLED,
    check_samples,
    normalize_thresholds,
    vote_from_hd,
)

MAX_LAYERS = 8  # csrc/fused_mlp.cu kMaxLayers
QUERIES_PER_WARP = 8  # csrc/fused_mlp.cu kQ: bq must be a multiple
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


def _validate(x_packed, layer_ws, layer_cs, layer_n_bits, head_rows,
              bias_cells: int):
    """The reference's shape guards, as ValueErrors; returns int32 C's."""
    if len(layer_ws) != len(layer_cs) or len(layer_ws) != len(layer_n_bits):
        raise ValueError("layer_ws / layer_cs / layer_n_bits length mismatch")
    _check_words("x_packed", x_packed)
    _check_words("head_rows", head_rows)
    for w in layer_ws:
        _check_words("layer weight rows", w)
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
    bq          : queries per thread block on the card (multiple of 8)
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
    if bq <= 0 or bq % QUERIES_PER_WARP:
        raise ValueError(f"bq must be a positive multiple of "
                         f"{QUERIES_PER_WARP}, got {bq}")
    b, kw0 = x_packed.shape
    n_classes, kw_head = head_rows.shape
    kws = [w.shape[1] for w in layer_ws]
    max_kw = max([kw0, kw_head, *kws])
    if 4 * (256 + 2 * bq * max_kw) > SMEM_LIMIT:
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
    k = max(n_layers, 1)
    w_ptrs = (ctypes.c_void_p * k)(*[w.data_ptr() for w in ws])
    c_ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cs])
    n_bits = (ctypes.c_int * k)(*layer_n_bits)
    n_out = (ctypes.c_int * k)(*[w.shape[0] for w in ws])
    kw = (ctypes.c_int * k)(*kws)
    addr = ctypes.addressof
    lib = _build.library("fused_mlp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_mlp_votes_launch(
            x.data_ptr(), b, kw0, n_layers, addr(w_ptrs), addr(c_ptrs),
            addr(n_bits), addr(n_out), addr(kw), head.data_ptr(), n_classes,
            kw_head, bias_cells, thr.data_ptr(), mode, p, samples_ptr,
            out.data_ptr(), bq, stream,
        )
    _build.check(lib, err, "fused_mlp_votes")
    fused_mlp_votes.launches += 1
    return out


fused_mlp_votes.launches = 0
