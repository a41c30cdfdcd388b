"""Host twins of the launch plans of kernels 1 and 2, on the CPU.

`binary_gemm.gemm_plan` is the twin of csrc/binary_gemm.cu
`binary_gemm_plan` and `cam_search.cam_plan` of csrc/cam_search.cu
`cam_vote_plan` (tests/test_torch_cuda.py holds each twin equal to its
launcher on the card).  Here: the paper's shapes keep the plans they had
(kernel 1's 32 x 128 tile at M = 4096, N = 128; kernel 2's single row
tile at the 10- and 20-class heads), the LM shapes get theirs (kernel 2's
grid fills the card at C = 128,256 with no m16 tile all padding; the
long-context prefill takes the large tile; decode splits K), the twins'
constants equal the sources', every plan's tiles cover every output once,
and every plan's shared memory fits a block.  The large tile's one-product
distance, HD = popc(x) + popc(w) - 2 popc(x & w), is emulated and held
against the reference's kernel on rows that stress it (all ones, all
zeros, bit 31 set).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import packed
from repro.kernels import ops as jops
from repro_torch.core.binarize import popcount32
from repro_torch.kernels import binary_gemm, cam_search

CSRC = Path(binary_gemm.__file__).resolve().parent / "csrc"
H100_WAVE = 132  # one block on every SM of an H100


def _const(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    m = re.search(rf"\b{name} = (\d+)", text)
    assert m, f"{name} not in {source}"
    return int(m.group(1))


# ------------------------------------------------------------- kernel 1
@pytest.mark.parametrize("m,n,kw", [
    (4096, 128, 128), (4096, 128, 25),     # HG and MNIST MLP layer 1
    (4096, 128, 225), (4096, 128, 36),     # the CNN FC
    (4096, 20, 6), (4096, 10, 6),          # the heads
    (256, 128, 25), (64, 10, 6),           # the quickstart's HD-once route
    (4, 256, 2), (256, 256, 2),            # picbnn_serve's exact readout
    (64, 8192, 64), (64, 2048, 256),       # LM prefill at 64 tokens
])
def test_paper_shapes_keep_the_32x128_tile(m, n, kw):
    plan = binary_gemm.gemm_plan(m, n, kw)
    assert plan["plan"] == binary_gemm.TILE32X128
    assert plan["grid"] == (-(-n // 128), -(-m // 32))
    assert plan["smem"] == 0


@pytest.mark.parametrize("m,n,kw", [(32768, 8192, 64), (32768, 2048, 256)])
def test_long_context_prefill_takes_the_large_tile(m, n, kw):
    plan = binary_gemm.gemm_plan(m, n, kw, aligned=True)
    assert plan["plan"] == binary_gemm.LARGE
    assert plan["tile"] == (128, 256)
    assert plan["grid"] == (H100_WAVE, 1)  # persistent: one block an SM
    # the large tile copies 16-byte granules only
    assert binary_gemm.gemm_plan(m, n, kw, aligned=False)["plan"] == \
        binary_gemm.TILE32X128


@pytest.mark.parametrize("m,n,kw,plan", [
    # the large tile from three 32 x 128 blocks an SM: 264 blocks, then
    # 266 (N = 256) and 268 (N = 512)
    (4224, 256, 64, "tile32x128"), (4225, 256, 64, "large"),
    (4225, 255, 64, "tile32x128"), (2113, 512, 64, "large"),
    (2112, 512, 64, "tile32x128"), (4225, 256, 62, "tile32x128"),
    (16, 2048, 64, "split_k"), (17, 2048, 64, "tile32x128"),
    (4, 2048, 63, "tile32x128"), (1, 1, 64, "split_k"),
])
def test_gemm_plan_boundaries(m, n, kw, plan):
    assert binary_gemm.gemm_plan(m, n, kw)["plan"] == plan


@pytest.mark.parametrize("m,n,kw", [(4, 2048, 256), (1, 2048, 256),
                                    (4, 8192, 64), (1, 8192, 64)])
def test_decode_bitlinear_splits_k(m, n, kw):
    """Decode's w_down (x[4, 256] w[2048, 256]) had 16 blocks of the 32 x
    128 tile; split over K its grid fills the card."""
    plan = binary_gemm.gemm_plan(m, n, kw)
    assert plan["plan"] == binary_gemm.SPLIT_K
    assert plan["grid"][0] * plan["grid"][1] >= H100_WAVE
    warps = _const("binary_gemm.cu", "kSplitWarps")
    assert plan["threads"] == 32 * warps
    assert -(-kw // 8) >= warps  # every warp holds a K step


def _gemm_cover(m, n, kw, sms):
    """Each output's owner under the plan, as the launcher walks it."""
    plan = binary_gemm.gemm_plan(m, n, kw, True, sms)
    owned = np.zeros((m, n), np.int64)
    bm, bn = plan["tile"]
    if plan["plan"] == binary_gemm.LARGE:
        tiles_n = -(-n // bn)
        tiles = -(-m // bm) * tiles_n
        for blk in range(plan["grid"][0]):
            for tile in range(blk, tiles, plan["grid"][0]):
                tm, tn = divmod(tile, tiles_n)
                owned[tm * bm:(tm + 1) * bm, tn * bn:(tn + 1) * bn] += 1
    else:
        for gx in range(plan["grid"][0]):
            for gy in range(plan["grid"][1]):
                owned[gy * bm:(gy + 1) * bm, gx * bn:(gx + 1) * bn] += 1
    return owned


@pytest.mark.parametrize("m,n,kw", [(1000, 700, 64), (513, 257, 8),
                                    (300, 130, 7), (5, 1001, 96)])
def test_gemm_plans_cover_every_output_once(m, n, kw):
    """With 7 SMs the first two take the large tile, with 132 the 32 x
    128 one."""
    for sms in (7, 132):
        assert (_gemm_cover(m, n, kw, sms) == 1).all()
    assert binary_gemm.gemm_plan(1000, 700, 64, True, 7)["plan"] == \
        binary_gemm.LARGE


def test_gemm_twin_constants_equal_the_source():
    src = "binary_gemm.cu"
    assert (_const(src, "kBM"), _const(src, "kBN")) == (32, 128)
    assert (_const(src, "kLM"), _const(src, "kLN")) == (128, 256)
    assert _const(src, "kSmallWaves") == binary_gemm.SMALL_WAVES
    rows = _const(src, "kLM") + _const(src, "kLN")
    stages = _const(src, "kLStages")
    smem = (4 * stages * rows * _const(src, "kLKC")
            + 4 * (8 * 16 * _const(src, "kStgLd") + 2 * rows)
            + 8 * stages + 1024)
    assert binary_gemm.LARGE_SMEM == smem <= binary_gemm.SMEM_LIMIT
    # the 32 x 128 tile's static ring stays under the 48 KB static cap
    assert 4 * _const(src, "kStages") * (32 + 128) * (
        _const(src, "kKC") + 4) <= 48 * 1024


def _one_product_hd(x, w):
    """The large tile's arithmetic in plain PyTorch: per word
    popc(x) + popc(w) - 2 popc(x & w), each row's popcounts taken once."""
    px = popcount32(x).sum(1, dtype=torch.int32)
    pw = popcount32(w).sum(1, dtype=torch.int32)
    both = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.int32)
    for k in range(x.shape[1]):
        both += popcount32(x[:, k, None] & w[None, :, k])
    return px[:, None] + pw[None, :] - 2 * both


@pytest.mark.parametrize("kw", [1, 7, 8])
def test_one_product_identity_equals_reference(kw):
    rng = np.random.default_rng(kw)
    xj, x = packed(rng, 21, 32 * kw)
    wj, w = packed(rng, 13, 32 * kw)
    # all-ones and all-zero rows (HD 0 and K against each other), and a
    # word with only bit 31 set
    for t, j in ((x, xj), (w, wj)):
        t[0], t[1], t[2] = -1, 0, -2 ** 31
        j[0], j[1], j[2] = 0xFFFFFFFF, 0, 0x80000000
    want = np.asarray(jops.binary_gemm_hd(jnp.asarray(xj), jnp.asarray(wj),
                                          bm=16, bn=16, chunk=4))
    got = _one_product_hd(x, w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(binary_gemm.binary_gemm_hd(x, w).numpy(),
                                  want)
    assert want[0, 0] == 0 and want[0, 1] == want[1, 0] == 32 * kw


# ------------------------------------------------------------- kernel 2
@pytest.mark.parametrize("c,kw", [(10, 4), (20, 6), (10, 6)])
def test_paper_heads_keep_one_row_tile(c, kw):
    for sampled in (False, True):
        plan = cam_search.cam_plan(4096, c, kw, sampled)
        assert plan["grid"] == (128, 1)  # 32-query tiles, one row tile
        assert plan["bq"] == 32 and plan["n_chunks"] == 1
        assert plan["mode"] == cam_search.ROWS_GLOBAL  # no ring to fill


@pytest.mark.parametrize("b", [1, 2, 4, 15, 16, 17, 31, 32])
def test_vocab_head_grid_fills_the_card(b):
    """q[b, 64] against rows[128256, 64]: at least two waves of blocks on
    132 SMs, and every m16 tile of a block holds a query."""
    plan = cam_search.cam_plan(b, 128256, 64, False)
    blocks = plan["grid"][0] * plan["grid"][1]
    assert blocks >= 2 * H100_WAVE
    assert plan["bq"] == (16 if b <= 16 else 32)
    assert -(-min(b, plan["bq"]) // 16) == plan["bq"] // 16
    assert plan["grid"][1] * plan["gpb"] * cam_search.CAM_GROUP_ROWS >= 128256
    assert plan["mode"] == cam_search.ROWS_TMA
    assert cam_search.cam_plan(b, 128256, 64, False, aligned=False)[
        "mode"] == cam_search.ROWS_WORDS
    assert cam_search.cam_plan(b, 128256, 63, False)["mode"] == \
        cam_search.ROWS_WORDS


def test_vocab_head_votes_count_directly_at_decode():
    """At B = 4 a block's 4 x 256 votes are fewer than the table's 2,048
    entries, so it counts them; at B = 16 it builds the table."""
    for b, table in ((1, False), (4, False), (16, True), (32, True)):
        plan = cam_search.cam_plan(b, 128256, 64, False)
        rows = plan["gpb"] * cam_search.CAM_GROUP_ROWS
        assert cam_search.uses_table(min(b, plan["bq"]) * rows,
                                     plan["vtab_n"]) == table
    assert cam_search.cam_plan(4, 128256, 64, True)["vtab_n"] == 0
    assert not cam_search.uses_table(10 ** 6, 0)


def _cam_cover(b, c, kw):
    plan = cam_search.cam_plan(b, c, kw, False)
    owned = np.zeros((b, c), np.int64)
    rows = plan["gpb"] * cam_search.CAM_GROUP_ROWS
    for qx in range(plan["grid"][0]):
        for ry in range(plan["grid"][1]):
            owned[qx * plan["bq"]:(qx + 1) * plan["bq"],
                  ry * rows:(ry + 1) * rows] += 1
    return owned


@pytest.mark.parametrize("b,c,kw", [(1, 128256, 64), (33, 5000, 64),
                                    (4, 2048, 48), (1001, 100, 33),
                                    (4096, 20, 6), (2, 50304, 80)])
def test_cam_plan_covers_every_vote_once(b, c, kw):
    assert (_cam_cover(b, c, kw) == 1).all()


def test_cam_twin_constants_equal_the_source():
    src = "cam_search.cu"
    assert _const(src, "kGroupRows") == cam_search.CAM_GROUP_ROWS
    assert _const(src, "kMaxKC") == cam_search.CAM_MAX_KC
    assert _const(src, "kStages") == cam_search.CAM_STAGES
    assert _const(src, "kBlocksPerSm") == cam_search.CAM_BLOCKS_PER_SM
    assert _const(src, "kVoteTab") == cam_search.VOTE_TABLE_MAX
    assert _const(src, "kTmaKC") == cam_search.CAM_TMA_KC
    assert "kBarWords = 2 * kStages" in (CSRC / src).read_text()
    assert cam_search.CAM_BARRIER_WORDS == 2 * cam_search.CAM_STAGES
    assert _const("picbnn.cuh", "kSmemLimit") == cam_search.SMEM_LIMIT \
        == binary_gemm.SMEM_LIMIT


@pytest.mark.parametrize("sampled", [False, True])
def test_cam_plan_smem_fits_over_shapes(sampled):
    """Every plan's shared memory is within SMEM_LIMIT, K chunks are whole
    8-word steps that cover Kw, and a plan is refused only where even a
    16-query tile overflows."""
    for kw in (1, 2, 6, 7, 31, 32, 33, 48, 64, 80, 100, 257, 900, 2000,
               2900, 4000):
        for b in (1, 16, 17, 32, 4096):
            try:
                plan = cam_search.cam_plan(b, 128256, kw, sampled)
            except ValueError:
                assert kw >= 2900
                continue
            assert plan["smem"] <= cam_search.SMEM_LIMIT
            assert plan["kc"] % 8 == 0 and plan["kc"] <= cam_search.CAM_MAX_KC
            assert plan["kc"] * plan["n_chunks"] >= kw
            assert plan["kc"] * (plan["n_chunks"] - 1) < kw
