"""Kernel 1: bit-packed XNOR-popcount GEMM (pairwise Hamming distances).

    out[m, n] = sum_k popcount(x[m, k] XOR w[n, k])        (Hamming distance)
    dot_pm1   = n_bits - 2 * out                           (XNOR-popcount dot)

`binary_gemm_hd` is the PyTorch custom op `repro_torch::binary_gemm_hd`:
its CUDA kernel launches `csrc/binary_gemm.cu` for tensors on the card,
its CPU kernel runs `binary_gemm_hd_plain`, the same arithmetic in plain
PyTorch, and its fake form gives the [M, N] int32 result's shape, so the
op traces under `FakeTensorMode`, on the meta device and on DTensor
local shards (`launch/dryrun.py`).  It replaces the Pallas kernel
`repro/kernels/binary_gemm.py::binary_gemm_hd`.

The launch picks one of three plans by shape (`gemm_plan`, the host twin
of the launcher's choice; the .cu file's note says what bounds each):
`tile32x128` for the paper's shapes (32 x 128 output tiles, K streamed
through a cp.async ring, two `mma.sync .and.popc` products a distance),
`large` for N >= 256 where the 32 x 128 tile's grid would hold more
than two blocks an SM (it wins from three: `scripts/torch_kernel_plans.py`
times both across the switch), on 16-byte-aligned rows (a persistent
block an SM walking 128 x 256 tiles,
fed by TMA boxes, on `wgmma .and.popc`, one product a distance beside
the rows' popcounts, the output the bound: the long-context prefill),
and `split_k` for M <= 16 and Kw >= 64 (one n8 tile of columns a block,
K split among its eight warps and summed exactly in int32: the decode
BitLinear).

`grouped_bitlinear_hd` is the grouped entry, the custom op
`repro_torch::grouped_bitlinear_hd`: x [S, Kw] holds runs of rows, run e
(rows offsets[e] .. offsets[e + 1]) against its own rows w[e] [N, Kw],
all E runs in one launch of `grouped_bitlinear_kernel` (the dropless
MoE's experts, each run the slots routed to one expert).  Each block
takes one 32 x 128 tile of one run, found from the device's offsets, so
the host never reads the runs' lengths.  Its CPU kernel is
`grouped_bitlinear_hd_plain`, `binary_gemm_hd_plain` a run.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import popcount32
from repro_torch.kernels import _build


def binary_gemm_hd_plain(x_packed: torch.Tensor,
                         w_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one [M, N] XOR-popcount-add per word."""
    m, kw = x_packed.shape
    acc = torch.zeros((m, w_packed.shape[0]), dtype=torch.int32,
                      device=x_packed.device)
    for k in range(kw):
        acc += popcount32(x_packed[:, k, None] ^ w_packed[None, :, k])
    return acc


TILE32X128, LARGE, SPLIT_K = "tile32x128", "large", "split_k"
SMS = 132  # streaming multiprocessors of an H100 SXM
# csrc/binary_gemm.cu kSmallWaves: the large tile takes over where the
# 32 x 128 tile's grid would hold more blocks an SM
SMALL_WAVES = 2
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
# csrc/binary_gemm.cu: the large tile's ring (4 stages of 128 + 256 rows
# by 32 words), epilogue slabs (8 warps x 16 x 40 words), popcounts, the
# stages' mbarriers and 1 KB to align the ring
LARGE_SMEM = 4 * 4 * 384 * 32 + 4 * (8 * 16 * 40 + 2 * 384) + 8 * 4 + 1024


def gemm_plan(m: int, n: int, kw: int, aligned: bool = True,
              sms: int = SMS) -> dict:
    """Host twin of csrc/binary_gemm.cu `binary_gemm_plan`: the plan the
    launch takes for x [m, kw] against w [n, kw], with its grid and
    dynamic shared memory.  `aligned`: both operands' first words on 16
    bytes (the large tile also needs Kw % 4 == 0: it copies whole 16-byte
    granules).  split_k where m <= 16 and kw >= 64; large where aligned,
    n >= 256 and the 32 x 128 tile's grid would hold more than
    SMALL_WAVES blocks an SM (one persistent block an SM, at most one a
    128 x 256 tile, walks the tiles); else the 32 x 128 tile."""
    if min(m, n, sms) <= 0 or kw < 0:
        raise ValueError(f"no plan for m={m} n={n} kw={kw} sms={sms}")
    if m <= 16 and kw >= 64:
        return dict(plan=SPLIT_K, tile=(16, 8), grid=(-(-n // 8), 1),
                    threads=256, smem=0)
    small_blocks = -(-m // 32) * -(-n // 128)
    if aligned and kw % 4 == 0 and n >= 256 and small_blocks > \
            SMALL_WAVES * sms:
        tiles = -(-m // 128) * -(-n // 256)
        return dict(plan=LARGE, tile=(128, 256), grid=(min(tiles, sms), 1),
                    threads=256, smem=LARGE_SMEM)
    return dict(plan=TILE32X128, tile=(32, 128),
                grid=(-(-n // 128), -(-m // 32)), threads=256, smem=0)


def words_aligned(*ts: torch.Tensor) -> bool:
    """Whether packed operands take the kernels' 16-byte copies: Kw % 4
    == 0 and every first word on 16 bytes."""
    return all(t.shape[1] % 4 == 0 and t.data_ptr() % 16 == 0 for t in ts)


def _check_words(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.ndim != 2:
        raise TypeError(f"{name} must be 2-D int32 packed words, got "
                        f"{t.dtype} {tuple(t.shape)}")


def binary_gemm_hd(x_packed: torch.Tensor,
                   w_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances between packed rows.

    x_packed: [M, Kw] int32;  w_packed: [N, Kw] int32  ->  [M, N] int32.
    CUDA tensors launch the kernel (counted in `binary_gemm_hd.launches`);
    CPU tensors take the plain version.
    """
    _check_words("x_packed", x_packed)
    _check_words("w_packed", w_packed)
    if x_packed.shape[1] != w_packed.shape[1]:
        raise ValueError(f"packed widths differ: {tuple(x_packed.shape)} vs "
                         f"{tuple(w_packed.shape)}")
    if x_packed.device != w_packed.device:
        raise ValueError("x_packed and w_packed are on different devices")
    return _op(x_packed, w_packed)


binary_gemm_hd.launches = 0


@torch.library.custom_op("repro_torch::binary_gemm_hd", mutates_args=())
def _op(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    raise ValueError(f"unsupported device {x_packed.device}")


@_op.register_fake
def _(x_packed, w_packed):
    return x_packed.new_empty((x_packed.shape[0], w_packed.shape[0]),
                              dtype=torch.int32)


_op.register_kernel("cpu")(binary_gemm_hd_plain)


@_op.register_kernel("cuda")
def launch(x_packed: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on the card (the op's CUDA kernel; checked
    operands)."""
    m, kw = x_packed.shape
    n = w_packed.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=x_packed.device)
    if m == 0 or n == 0:
        return out
    x, w = x_packed.contiguous(), w_packed.contiguous()
    if gemm_plan(m, n, kw, words_aligned(x, w))["grid"][1] > 65535:
        raise ValueError(f"M = {m} exceeds the 32 x 128 tile's grid "
                         "(2,097,120 rows)")
    lib = _build.library("binary_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.binary_gemm_hd_launch(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), m, n, kw, stream)
    _build.check(lib, err, "binary_gemm_hd")
    binary_gemm_hd.launches += 1
    return out


def grouped_bitlinear_hd_plain(x_packed: torch.Tensor, offsets: torch.Tensor,
                               w_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `binary_gemm_hd_plain` of each run."""
    out = torch.zeros((x_packed.shape[0], w_packed.shape[1]),
                      dtype=torch.int32, device=x_packed.device)
    bounds = offsets.tolist()
    for e in range(w_packed.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = binary_gemm_hd_plain(x_packed[lo:hi], w_packed[e])
    return out


def grouped_bitlinear_hd(x_packed: torch.Tensor, offsets: torch.Tensor,
                         w_packed: torch.Tensor) -> torch.Tensor:
    """Hamming distances of each run of rows against its own packed rows.

    x_packed: [S, Kw] int32; offsets: [E + 1] int32, non-decreasing from
    0 to S (run e is rows offsets[e] .. offsets[e + 1]); w_packed:
    [E, N, Kw] int32  ->  [S, N] int32, row r of run e against w[e].
    CUDA tensors launch the kernel once (counted in
    `grouped_bitlinear_hd.launches`); CPU tensors take the plain version.
    """
    _check_words("x_packed", x_packed)
    if w_packed.dtype != torch.int32 or w_packed.ndim != 3:
        raise TypeError(f"w_packed must be 3-D int32 packed words, got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    if offsets.dtype != torch.int32 or offsets.shape != (
            w_packed.shape[0] + 1,):
        raise TypeError(f"offsets must be int32 [{w_packed.shape[0] + 1}], "
                        f"got {offsets.dtype} {tuple(offsets.shape)}")
    if x_packed.shape[1] != w_packed.shape[2]:
        raise ValueError(f"packed widths differ: {tuple(x_packed.shape)} vs "
                         f"{tuple(w_packed.shape)}")
    if not x_packed.device == offsets.device == w_packed.device:
        raise ValueError("x_packed, offsets and w_packed are on different "
                         "devices")
    return _grouped_op(x_packed, offsets, w_packed)


grouped_bitlinear_hd.launches = 0


@torch.library.custom_op("repro_torch::grouped_bitlinear_hd", mutates_args=())
def _grouped_op(x_packed: torch.Tensor, offsets: torch.Tensor,
                w_packed: torch.Tensor) -> torch.Tensor:
    raise ValueError(f"unsupported device {x_packed.device}")


@_grouped_op.register_fake
def _(x_packed, offsets, w_packed):
    return x_packed.new_empty((x_packed.shape[0], w_packed.shape[1]),
                              dtype=torch.int32)


_grouped_op.register_kernel("cpu")(grouped_bitlinear_hd_plain)


@_grouped_op.register_kernel("cuda")
def launch_grouped(x_packed: torch.Tensor, offsets: torch.Tensor,
                   w_packed: torch.Tensor) -> torch.Tensor:
    """The grouped kernel's launch on the card (the op's CUDA kernel;
    checked operands)."""
    s, kw = x_packed.shape
    e, n, _ = w_packed.shape
    out = torch.empty((s, n), dtype=torch.int32, device=x_packed.device)
    if s == 0 or n == 0:
        return out
    x, w, o = x_packed.contiguous(), w_packed.contiguous(), offsets.contiguous()
    if -(-s // 32) + e > 65535:
        raise ValueError(f"S = {s} rows over {e} runs exceed the 32 x 128 "
                         "tile's grid")
    lib = _build.library("binary_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_bitlinear_launch(x.data_ptr(), o.data_ptr(),
                                           w.data_ptr(), out.data_ptr(), s,
                                           e, n, kw, stream)
    _build.check(lib, err, "grouped_bitlinear_hd")
    grouped_bitlinear_hd.launches += 1
    return out
