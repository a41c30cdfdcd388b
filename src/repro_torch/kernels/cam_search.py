"""Kernel 2: the fused multi-threshold CAM vote (Algorithm 1, fused).

    votes[b, c] = #{ t : HD(q_b, row_c) <= T_t }

The Hamming distance of every (query, class row) pair is computed once
and compared against all P thresholds in registers.  Threshold forms, as
in the reference: an int32 [P] schedule (integer compare), a float32 [P]
schedule (compared as float32(HD) <= T), or a float32 [B, C, P] block of
sampled thresholds (`thr_samples`; the sampler itself comes with the
noise slice).

`cam_vote` launches the CUDA kernel of `csrc/cam_search.cu` for tensors
on the card and runs `cam_vote_plain` for tensors on the CPU.  It
replaces the Pallas kernel `repro/kernels/cam_search.py::cam_vote`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.binary_gemm import _check_words, binary_gemm_hd_plain

THR_INT, THR_FLOAT, THR_SAMPLED = 0, 1, 2
MAX_PASSES = 256  # csrc/picbnn.cuh kMaxPasses


def normalize_thresholds(thresholds: torch.Tensor) -> torch.Tensor:
    """A [P] schedule as the kernels read it: float32 if floating, else
    int32 — never one coerced into the other."""
    t = torch.as_tensor(thresholds)
    if t.ndim != 1:
        raise ValueError(f"thresholds must be [P], got {tuple(t.shape)}")
    if t.shape[0] > MAX_PASSES:
        raise ValueError(f"{t.shape[0]} thresholds > {MAX_PASSES} supported")
    return t.to(torch.float32 if t.is_floating_point() else torch.int32)


def check_samples(thr_samples: torch.Tensor, b: int, c: int,
                  p: int) -> torch.Tensor:
    """Validate a [B, C, P] sampled-threshold block; float32, contiguous."""
    if tuple(thr_samples.shape) != (b, c, p):
        raise ValueError(
            f"thr_samples shape {tuple(thr_samples.shape)} != [{b}, {c}, {p}]"
        )
    return thr_samples.to(torch.float32).contiguous()


def vote_from_hd(hd: torch.Tensor, thresholds: torch.Tensor,
                 thr_samples: torch.Tensor | None = None) -> torch.Tensor:
    """Plain vote of [B, C] distances: the compare of every threshold form."""
    if thr_samples is not None:
        return (hd.to(torch.float32)[:, :, None] <= thr_samples).sum(
            -1, dtype=torch.int32)
    if thresholds.is_floating_point():
        hd = hd.to(torch.float32)
    return (hd[:, :, None] <= thresholds).sum(-1, dtype=torch.int32)


def cam_vote_plain(q_packed, rows_packed, thresholds, thr_samples=None):
    """Plain PyTorch version of `cam_vote` (same arguments)."""
    thr = normalize_thresholds(thresholds).to(q_packed.device)
    if thr_samples is not None:
        thr_samples = check_samples(thr_samples, q_packed.shape[0],
                                    rows_packed.shape[0], thr.shape[0])
    return vote_from_hd(binary_gemm_hd_plain(q_packed, rows_packed), thr,
                        thr_samples)


def cam_vote(q_packed: torch.Tensor, rows_packed: torch.Tensor,
             thresholds: torch.Tensor, *,
             thr_samples: torch.Tensor | None = None) -> torch.Tensor:
    """Fused Algorithm-1 vote counts.

    q_packed    : [B, Kw] int32 packed queries (bias searchlines included)
    rows_packed : [C, Kw] int32 packed class rows (bias cells included)
    thresholds  : [P] HD tolerances (int, or float compared as float32)
    thr_samples : optional [B, C, P] float32 sampled thresholds; replaces
                  `thresholds` in the compare (P still comes from it)
    returns     : [B, C] int32 votes

    CUDA tensors launch the kernel (counted in `cam_vote.launches`); CPU
    tensors take the plain version.
    """
    _check_words("q_packed", q_packed)
    _check_words("rows_packed", rows_packed)
    if q_packed.shape[1] != rows_packed.shape[1]:
        raise ValueError(f"packed widths differ: {tuple(q_packed.shape)} vs "
                         f"{tuple(rows_packed.shape)}")
    dev = q_packed.device
    if dev.type == "cpu":
        return cam_vote_plain(q_packed, rows_packed, thresholds, thr_samples)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, kw = q_packed.shape
    c = rows_packed.shape[0]
    thr = normalize_thresholds(thresholds).to(dev).contiguous()
    p = thr.shape[0]
    if thr_samples is not None:
        thr_samples = check_samples(thr_samples, b, c, p)
        mode, samples_ptr = THR_SAMPLED, thr_samples.data_ptr()
    else:
        mode = THR_FLOAT if thr.is_floating_point() else THR_INT
        samples_ptr = None
    for name, t in (("rows_packed", rows_packed), ("thresholds", thr),
                    ("thr_samples", thr_samples)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
    if -(-b // 32) > 65535:
        raise ValueError(f"B = {b} exceeds the kernel grid")
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b == 0 or c == 0:
        return out
    q, rows = q_packed.contiguous(), rows_packed.contiguous()
    lib = _build.library("cam_search")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cam_vote_launch(q.data_ptr(), rows.data_ptr(),
                                  thr.data_ptr(), samples_ptr, out.data_ptr(),
                                  b, c, kw, p, mode, stream)
    _build.check(lib, err, "cam_vote")
    cam_vote.launches += 1
    return out


cam_vote.launches = 0
