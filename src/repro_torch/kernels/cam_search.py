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
`repro/kernels/cam_search.py::cam_vote`, and grids as it does, over
query tiles and row tiles.  At an LM head (B <= 32 against up to 128,256
rows) the rows' bytes bound it: the grid gives every SM about four
blocks, each streaming its rows through a ring of 2-D TMA boxes (4-byte
cp.async copies for other widths); at the paper's heads (B = 4096
against 10 or 20 rows) one row tile serves each query tile, its rows
read from global memory, and the launch's latency bounds it.  Distances
run on the 1-bit tensor cores; a block votes through a table of the vote
at every distance (host twin `vote_table`) where it votes more pairs
than the table has entries, else it counts the P compares.  `cam_plan`
is the host twin of the launch plan, `uses_table` of the vote's rule.

`vote_table_len` is the table's length in kernels 2 and 3.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.binarize import WORD
from repro_torch.kernels import _build
from repro_torch.kernels.binary_gemm import (_check_words,
                                             binary_gemm_hd_plain,
                                             words_aligned)

THR_INT, THR_FLOAT, THR_SAMPLED = 0, 1, 2
MAX_PASSES = 256  # csrc/picbnn.cuh kMaxPasses
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
VOTE_TABLE_MAX = 2048  # csrc/mlp_block.cuh and cam_search.cu kVoteTab
# csrc/cam_search.cu: rows a stage (eight warps x one n8 tile), most
# words of K a stage, ring stages, and the blocks an SM the grid aims for
CAM_GROUP_ROWS, CAM_MAX_KC, CAM_STAGES, CAM_BLOCKS_PER_SM = 64, 32, 4, 4
CAM_BARRIER_WORDS = 2 * CAM_STAGES  # an mbarrier a stage
CAM_TMA_KC = 32  # words of K a TMA stage (one 128-byte swizzled row)
# how a block reads its rows (csrc/cam_search.cu RowsMode): a ring of
# 4-byte cp.async words, a ring of TMA boxes, or straight from global
ROWS_WORDS, ROWS_TMA, ROWS_GLOBAL = "words", "tma", "global"
SMS = 132  # streaming multiprocessors of an H100 SXM


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
    """Entries of a block's vote table (csrc/mlp_block.cuh `mlp_launch`,
    csrc/cam_search.cu `cam_vote_plan`):
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


def cam_plan(b: int, c: int, kw: int, sampled: bool, aligned: bool = True,
             sms: int = SMS) -> dict:
    """Host twin of csrc/cam_search.cu `cam_vote_plan`.

    How a block reads its rows (`mode`): where every block's rows are one
    stage (c <= CAM_GROUP_ROWS, kw <= CAM_MAX_KC: the paper's heads)
    straight from global memory; else through a ring of CAM_STAGES
    stages of CAM_GROUP_ROWS rows, filled by TMA boxes of CAM_TMA_KC
    words (128-byte swizzled; `aligned`: both operands' first words on 16
    bytes, and Kw % 4 == 0) or by 4-byte cp.async words (kc + 4 words a
    row).  bq queries a tile (16 where b <= 16, so no m16 tile is all
    padding, else 32 where it fits), K in n_chunks chunks of kc words,
    gpb row groups a block so that the grid (query tiles x row tiles)
    holds about CAM_BLOCKS_PER_SM blocks an SM, the vote table's entries
    (none for sampled thresholds) and the block's shared memory: the
    ring's barriers, the schedule, the table, the query tile at a stride
    of n_chunks * kc + 4 words and the ring (with 1 KB to align TMA
    boxes).  Raises where a tile of 16 queries overflows SMEM_LIMIT."""
    if min(b, c, kw, sms) <= 0:
        raise ValueError(f"no plan for b={b} c={c} kw={kw} sms={sms}")
    if c <= CAM_GROUP_ROWS and kw <= CAM_MAX_KC:
        mode, n_chunks, kc, ring = ROWS_GLOBAL, 1, -(-kw // 8) * 8, 0
    elif aligned and kw % 4 == 0:
        mode, n_chunks, kc = ROWS_TMA, -(-kw // CAM_TMA_KC), CAM_TMA_KC
        ring = 4 * CAM_STAGES * CAM_GROUP_ROWS * CAM_TMA_KC + 1024
    else:
        n_chunks = -(-kw // CAM_MAX_KC)
        mode, kc = ROWS_WORDS, -(-(-(-kw // n_chunks)) // 8) * 8
        ring = 4 * CAM_STAGES * CAM_GROUP_ROWS * (kc + 4)
    ldq = n_chunks * kc + 4
    vtab_n = vote_table_len(kw, sampled)
    fixed = 4 * (CAM_BARRIER_WORDS + MAX_PASSES + -(-vtab_n // 4) * 4) + ring
    bq = 16 if b <= 16 or fixed + 4 * 32 * ldq > SMEM_LIMIT else 32
    smem = fixed + 4 * bq * ldq
    if smem > SMEM_LIMIT:
        raise ValueError(f"Kw = {kw} words: a tile of 16 queries "
                         "overflows shared memory")
    n_qt, groups = -(-b // bq), -(-c // CAM_GROUP_ROWS)
    target = CAM_BLOCKS_PER_SM * sms
    gpb = max(1, -(-(groups * n_qt) // target))
    return dict(bq=bq, kc=kc, n_chunks=n_chunks, gpb=gpb,
                grid=(n_qt, -(-groups // gpb)), vtab_n=vtab_n, smem=smem,
                mode=mode)


def uses_table(votes: int, vtab_n: int) -> bool:
    """Whether a block of kernel 2 votes through its table (csrc/
    cam_search.cu `use_table`): where it votes more (query, row) pairs
    than the table has entries."""
    return vtab_n > 0 and votes > vtab_n


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
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b == 0 or c == 0:
        return out
    q, rows = q_packed.contiguous(), rows_packed.contiguous()
    # raises where a tile of 16 queries overflows shared memory
    cam_plan(b, c, kw, thr_samples is not None, words_aligned(q, rows))
    lib = _build.library("cam_search")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cam_vote_launch(q.data_ptr(), rows.data_ptr(),
                                  thr.data_ptr(), samples_ptr, out.data_ptr(),
                                  b, c, kw, p, mode, stream)
    _build.check(lib, err, "cam_vote")
    cam_vote.launches += 1
    return out
