"""Kernel 2: the fused multi-threshold CAM vote (Algorithm 1, fused).

    votes[b, c] = #{ t : HD(q_b, row_c) <= T_t }

The Hamming distance of every (query, class row) pair is computed once
and compared against all P thresholds in registers.  Threshold forms, as
in the reference: an int32 [P] schedule (integer compare), a float32 [P]
schedule (compared as float32(HD) <= T), or a float32 [B, C, P] block of
sampled thresholds (`thr_samples`, drawn by
`core.physics.SearchPhysics.sample`).

`cam_vote` is the PyTorch custom op `repro_torch::cam_vote`: its CUDA
kernel launches `csrc/cam_search.cu` for tensors on the card, its CPU
kernel runs `cam_vote_plain`, and its fake form gives the [B, C] int32
result's shape (so it traces under `FakeTensorMode`, on the meta device
and on DTensor local shards).  It replaces the Pallas kernel
`repro/kernels/cam_search.py::cam_vote`.  The
kernel is the block program of kernels 2 and 3 (`csrc/mlp_block.cuh`)
with no hidden layers: distances on the 1-bit tensor cores, and for the
shared schedules a per-block table of the vote at every distance, whose
host twin is `vote_table`.  `block_smem_bytes` is the host twin of the
block program's shared-memory layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.binarize import WORD
from repro_torch.kernels import _build
from repro_torch.kernels.binary_gemm import _check_words, binary_gemm_hd_plain

THR_INT, THR_FLOAT, THR_SAMPLED = 0, 1, 2
MAX_PASSES = 256  # csrc/picbnn.cuh kMaxPasses
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
QUERY_TILE = 16  # csrc/mlp_block.cuh: a tile holds whole m16 tiles
VOTE_TABLE_MAX = 2048  # csrc/mlp_block.cuh kVoteTab
CAM_BQ = 32  # csrc/cam_search.cu kBq: queries a tile, else QUERY_TILE
ROWS_SMEM_MIN = 32 * 1024  # csrc/mlp_block.cuh kRowsSmemMin


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


def vote_table_len(kw_head: int, sampled: bool) -> int:
    """Entries of the block's vote table (csrc/mlp_block.cuh `mlp_launch`):
    every distance of a kw_head-word head, at most VOTE_TABLE_MAX; none
    for sampled thresholds, which differ per (query, row)."""
    return 0 if sampled else min(WORD * kw_head + 1, VOTE_TABLE_MAX)


def vote_table(thresholds: torch.Tensor, n: int) -> torch.Tensor:
    """Host twin of the block's vote table: entry h is the vote of
    distance h, for h < n, with the compare of `vote_from_hd` (integer
    for an int32 schedule, float32(h) <= T for a float one).  A kernel
    reads a distance h < n from the table and counts any other."""
    thr = normalize_thresholds(thresholds)
    hd = torch.arange(n, dtype=torch.int32, device=thr.device)[None, :]
    return vote_from_hd(hd, thr)[0]


def block_smem_bytes(kw0: int, later_kws, bq: int, vtab_n: int,
                     row_shapes) -> tuple:
    """Shared memory of the block program of kernels 2 and 3
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
    b, c = q_packed.shape[0], rows_packed.shape[0]
    thr = normalize_thresholds(thresholds).to(dev).contiguous()
    if thr_samples is not None:
        thr_samples = check_samples(thr_samples, b, c, thr.shape[0])
    for name, t in (("rows_packed", rows_packed), ("thr_samples", thr_samples)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
    return _op(q_packed, rows_packed, thr, thr_samples)


cam_vote.launches = 0


@torch.library.custom_op("repro_torch::cam_vote", mutates_args=())
def _op(q_packed: torch.Tensor, rows_packed: torch.Tensor,
        thresholds: torch.Tensor,
        thr_samples: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError(f"unsupported device {q_packed.device}")


@_op.register_fake
def _(q_packed, rows_packed, thresholds, thr_samples):
    return q_packed.new_empty((q_packed.shape[0], rows_packed.shape[0]),
                              dtype=torch.int32)


_op.register_kernel("cpu")(cam_vote_plain)


@_op.register_kernel("cuda")
def launch(q_packed: torch.Tensor, rows_packed: torch.Tensor,
           thresholds: torch.Tensor,
           thr_samples: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's launch on the card (the op's CUDA kernel; operands
    checked by `cam_vote`, thresholds normalised)."""
    dev = q_packed.device
    b, kw = q_packed.shape
    c = rows_packed.shape[0]
    thr = thresholds
    p = thr.shape[0]
    if thr_samples is not None:
        mode, samples_ptr = THR_SAMPLED, thr_samples.data_ptr()
    else:
        mode = THR_FLOAT if thr.is_floating_point() else THR_INT
        samples_ptr = None
    vtab_n = vote_table_len(kw, thr_samples is not None)
    if block_smem_bytes(kw, [], QUERY_TILE, vtab_n, [])[0] > SMEM_LIMIT:
        raise ValueError(f"Kw = {kw} words: a tile of {QUERY_TILE} queries "
                         "overflows shared memory")
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
