"""The port's kernels (`repro_torch.kernels`) against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode with small blocks, as its own tests
run them.  Every comparison is bit-exact: these are integer kernels.  The
CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (BANK_BIAS, BANK_NETS, packed, pm1,
                         random_folded)
from repro_torch import convert
from repro.core import ensemble as jens
from repro.kernels import fused_mlp as jfm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import cam as tcam
from repro_torch.core import ensemble as tens
from repro_torch.kernels import binary_gemm, cam_search, fused_mlp, ops, ref

# (M, N, K bits): single word, n_bits % 32 != 0, Kw below one 32-word
# tile, ragged M/N, and K over one tile
GEMM_SHAPES = [(1, 1, 32), (8, 10, 192), (33, 7, 64), (20, 40, 300),
               (5, 3, 1100)]


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_binary_gemm_matches_reference(m, n, k):
    rng = np.random.default_rng(m * 1000 + n)
    xj, x = packed(rng, m, k)
    wj, w = packed(rng, n, k)
    want = np.asarray(jops.binary_gemm_hd(jnp.asarray(xj), jnp.asarray(wj),
                                          bm=16, bn=16, chunk=4))
    np.testing.assert_array_equal(binary_gemm.binary_gemm_hd(x, w).numpy(),
                                  want)
    np.testing.assert_array_equal(ref.binary_gemm_hd_ref(x, w).numpy(), want)
    np.testing.assert_array_equal(
        ops.binary_gemm_dot(x, w, k).numpy(),
        np.asarray(jops.binary_gemm_dot(jnp.asarray(xj), jnp.asarray(wj), k,
                                        bm=16, bn=16, chunk=4)))


def _thresholds(form, rng, b, c, k):
    """The three threshold forms, drawn with numpy for both sides."""
    base = k // 2 - 32 + np.arange(0, 65, 2)
    if form == "int":
        return base.astype(np.int32), None
    if form == "float":
        return (base + rng.uniform(-1, 1, base.shape)).astype(np.float32), None
    samples = base[None, None, :] + rng.normal(0, 3, (b, c, base.size))
    return base.astype(np.int32), samples.astype(np.float32)


@pytest.mark.parametrize("form", ["int", "float", "sampled"])
@pytest.mark.parametrize("b,c,k", [(23, 12, 256), (9, 5, 64)])
def test_cam_vote_matches_reference(form, b, c, k):
    rng = np.random.default_rng(b + c)
    qj, q = packed(rng, b, k)
    rj, rows = packed(rng, c, k)
    thr, samples = _thresholds(form, rng, b, c, k)
    want = np.asarray(jops.cam_vote(
        jnp.asarray(qj), jnp.asarray(rj), jnp.asarray(thr), bq=16, bc=16,
        chunk=4, thr_samples=None if samples is None else jnp.asarray(samples)))
    got = ops.cam_vote(q, rows, torch.from_numpy(thr), thr_samples=(
        None if samples is None else torch.from_numpy(samples)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if form == "int":
        np.testing.assert_array_equal(
            ref.cam_vote_ref(q, rows, torch.from_numpy(thr)).numpy(),
            np.asarray(jref.cam_vote_ref(jnp.asarray(qj), jnp.asarray(rj),
                                         jnp.asarray(thr))))


def _net_operands(sizes, seed, bias):
    jf, tf = random_folded(sizes, seed, bias)
    jh = jens.build_head(jf[-1], jens.EnsembleConfig(bias_cells=bias))
    th = tens.build_head(tf[-1], tens.EnsembleConfig(bias_cells=bias))
    from repro.core import binarize as jbin
    from repro_torch.core import binarize as tbin

    jws = tuple(jbin.pack_bits(jnp.asarray((l.weights_pm1 > 0)
                                           .astype(np.uint8))) for l in jf[:-1])
    tws = tuple(tbin.pack_bits(torch.from_numpy(
        (l.weights_pm1 > 0).astype(np.uint8))) for l in tf[:-1])
    jcs = tuple(jnp.asarray(l.c, jnp.int32) for l in jf[:-1])
    tcs = tuple(torch.as_tensor(l.c, dtype=torch.int32) for l in tf[:-1])
    n_bits = tuple(int(l.n_in) for l in tf[:-1])
    return (jws, jcs, jh), (tws, tcs, th), n_bits


FUSED_NETS = [(*BANK_NETS[b], BANK_BIAS[b]) for b in sorted(BANK_NETS)] + [
    (120, 96, 64, 33, 7, 64),  # three hidden layers, odd widths
    (128, 10, 64),  # head-only
]


@pytest.mark.parametrize("net", FUSED_NETS, ids=lambda n: "-".join(map(str, n)))
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_matches_reference(net, form):
    *sizes, bias = net
    (jws, jcs, jh), (tws, tcs, th), n_bits = _net_operands(sizes, 11, bias)
    rng = np.random.default_rng(len(sizes) + sizes[0])
    b = 23
    x = pm1(rng, (b, sizes[0]))
    if len(sizes) == 2:  # head-only: the input is the biased head query
        from repro.core import cam as jcam

        jx = jcam.query_with_bias(jnp.asarray(x), bias)
        tx = tcam.query_with_bias(torch.from_numpy(x), bias)
    else:
        from repro.core import binarize as jbin
        from repro_torch.core import binarize as tbin

        jx, tx = jbin.pack_pm1(jnp.asarray(x)), tbin.pack_pm1(
            torch.from_numpy(x))
    thr, samples = _thresholds(form, rng, b, sizes[-1], sizes[-2] + bias)
    want = np.asarray(jfm.fused_mlp_votes(
        jx, jws, jcs, n_bits, jh.cam.rows_packed, jnp.asarray(thr),
        bias_cells=bias, bq=16, interpret=True,
        thr_samples=None if samples is None else jnp.asarray(samples)))
    got = fused_mlp.fused_mlp_votes(
        tx, tws, tcs, n_bits, th.cam.rows_packed, torch.from_numpy(thr),
        bias_cells=bias,
        thr_samples=None if samples is None else torch.from_numpy(samples))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, sizes[-1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_mlp_width_guards_match_reference():
    """A head-only query packed WITHOUT the bias drive bits is refused by
    both packages (fused_mlp.py:240-250), as is a too-narrow repack."""
    (jws, jcs, jh), (tws, tcs, th), n_bits = _net_operands((128, 10), 3, 64)
    x = pm1(np.random.default_rng(0), (4, 128))
    from repro.core import binarize as jbin
    from repro_torch.core import binarize as tbin

    with pytest.raises(ValueError, match="bias drive"):
        jfm.fused_mlp_votes(jbin.pack_pm1(jnp.asarray(x)), (), (), (),
                            jh.cam.rows_packed, jh.thresholds, bias_cells=64,
                            bq=16, interpret=True)
    with pytest.raises(ValueError, match="bias drive"):
        fused_mlp.fused_mlp_votes(tbin.pack_pm1(torch.from_numpy(x)), (), (),
                                  (), th.cam.rows_packed, th.thresholds,
                                  bias_cells=64)
    (_, _, _), (tws, tcs, th2), n_bits = _net_operands((64, 40, 5), 3, 64)
    xq = tbin.pack_pm1(torch.from_numpy(pm1(np.random.default_rng(1),
                                            (4, 64))))
    narrow = th2.cam.rows_packed[:, :2]  # 40 + 64 bias bits need 4 words
    with pytest.raises(ValueError, match="do not fit"):
        fused_mlp.fused_mlp_votes(xq, tws, tcs, n_bits, narrow,
                                  th2.thresholds, bias_cells=64)
    with pytest.raises(ValueError, match="length mismatch"):
        fused_mlp.fused_mlp_votes(xq, tws, (), n_bits, th2.cam.rows_packed,
                                  th2.thresholds, bias_cells=64)


def test_wrappers_reject_bad_operands():
    x = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        binary_gemm.binary_gemm_hd(x.to(torch.int64), x)
    with pytest.raises(ValueError, match="widths differ"):
        binary_gemm.binary_gemm_hd(x, torch.zeros((3, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="thr_samples shape"):
        cam_search.cam_vote(x, x, torch.arange(4),
                            thr_samples=torch.zeros((3, 3, 5)))
    with pytest.raises(ValueError, match="thresholds"):
        cam_search.cam_vote(x, x, torch.zeros((2, 2), dtype=torch.int32))



def test_sign_at_zero_maps_to_plus_one():
    """With C = 0 and an even fan-in, y = n - 2*HD + C hits 0 often; the
    port must map it to +1 exactly as the reference (fused_mlp.py:120)."""
    from repro.core import binarize as jbin
    from repro_torch.core import binarize as tbin

    (jws, _, jh), (tws, _, th), n_bits = _net_operands((64, 32, 6), 4, 64)
    jcs = (jnp.zeros(32, jnp.int32),)
    tcs = (torch.zeros(32, dtype=torch.int32),)
    x = pm1(np.random.default_rng(6), (40, 64))
    w_pm1 = tbin.from_bits(tbin.unpack_bits(tws[0], 64)).numpy()
    assert ((x @ w_pm1.T) == 0).any()  # the case under test really occurs
    want = np.asarray(jfm.fused_mlp_votes(
        jbin.pack_pm1(jnp.asarray(x)), jws, jcs, n_bits, jh.cam.rows_packed,
        jh.thresholds, bias_cells=64, bq=16, interpret=True))
    got = fused_mlp.fused_mlp_votes(
        tbin.pack_pm1(torch.from_numpy(x)), tws, tcs, n_bits,
        th.cam.rows_packed, th.thresholds, bias_cells=64)
    np.testing.assert_array_equal(got.numpy(), want)


def _ones_queries(n_bits):
    """Queries 0..n_bits, query h holding h ones: against an all-zero row
    query h sits at Hamming distance h (numpy words and the port's)."""
    from repro.core import binarize as jbin

    h = np.arange(n_bits + 1)[:, None]
    words = jbin.np_pack_bits((np.arange(n_bits)[None, :] < h).astype(np.uint8))
    return words, convert.rows_from_jax(words)


# (n_bits, C): n_bits + C even, odd and zero, negative and odd, negative
# and even, and above 2*n_bits (every bit set)
SIGN_CASES = [(64, 0), (64, 3), (63, 0), (63, -62), (40, -40), (40, -41),
              (40, -44), (33, -35), (50, 60), (96, -1)]


@pytest.mark.parametrize("n_bits,c", SIGN_CASES)
def test_sign_limit_equals_reference_compare(n_bits, c):
    """The FC stage's epilogue, hd <= (n_bits + C) >> 1 (`sign_limit`),
    against the reference kernel's y = n_bits - 2*hd + C >= 0 at every
    integer hd in [0, n_bits].  A one-neuron layer of zero weights sees
    query h at distance h; a zero head row with 31 bias cells then votes
    1 under the threshold 31 exactly when the neuron's bit is 0."""
    xw, x = _ones_queries(n_bits)
    kw = xw.shape[1]
    thr = np.array([31], np.int32)
    votes = np.asarray(jfm.fused_mlp_votes(
        jnp.asarray(xw), (jnp.zeros((1, kw), jnp.uint32),),
        (jnp.asarray([c], jnp.int32),), (n_bits,),
        jnp.zeros((1, 1), jnp.uint32), jnp.asarray(thr), bias_cells=31,
        bq=16, interpret=True))
    hd = torch.arange(n_bits + 1, dtype=torch.int32)
    lim = fused_mlp.sign_limit(n_bits, torch.tensor([c], dtype=torch.int32))
    assert lim.dtype == torch.int32
    np.testing.assert_array_equal((hd <= lim).numpy(), votes[:, 0] == 0)
    got = fused_mlp.fused_mlp_votes(
        x, (torch.zeros((1, kw), dtype=torch.int32),),
        (torch.tensor([c], dtype=torch.int32),), (n_bits,),
        torch.zeros((1, 1), dtype=torch.int32), torch.from_numpy(thr),
        bias_cells=31)
    np.testing.assert_array_equal(got.numpy(), votes)


# shared schedules: the paper's 33-pass sweep (int, and float between
# the integers), and ones with negative, repeated, non-integer and
# above-range thresholds
VOTE_SCHEDULES = {
    "paper-int": (np.arange(0, 65, 2)).astype(np.int32),
    "int-edges": np.array([-5, 0, 0, 7, 31, 64, 65, 1000], np.int32),
    "paper-float": (np.arange(0, 65, 2) + 0.5).astype(np.float32),
    "float-edges": np.array([-0.5, -3.0, 0.0, 0.25, 6.5, 6.999, 7.0, 63.75,
                             64.0, 64.5, 1e9], np.float32),
}


@pytest.mark.parametrize("name", sorted(VOTE_SCHEDULES))
def test_vote_table_equals_reference_vote(name):
    """The block's vote table (`vote_table`: entry h is the vote of
    distance h) against the reference's cam_vote at every integer
    distance in [0, n_bits]: query h holds h ones against a zero row."""
    n_bits = 64
    thr = VOTE_SCHEDULES[name]
    qw, _ = _ones_queries(n_bits)
    rows = np.zeros((1, qw.shape[1]), np.uint32)
    want = np.asarray(jops.cam_vote(
        jnp.asarray(qw), jnp.asarray(rows), jnp.asarray(thr), bq=16, bc=16,
        chunk=4, interpret=True))[:, 0]
    n = cam_search.vote_table_len(qw.shape[1], sampled=False)
    assert n == n_bits + 1
    got = cam_search.vote_table(torch.from_numpy(thr), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_vote_table_len_and_block_layout():
    """The block program's sizes (host twins of csrc/mlp_block.cuh): the
    vote table spans a head's distances up to its cap and is absent for
    sampled thresholds.  At bq = 32 the HG MLP's rows (67 KB) are staged
    in shared memory beside the tiles; the MNIST MLP's (19 KB, under
    ROWS_SMEM_MIN) and those of a 512-neuron layer on the HG input (too
    wide to fit) are read from global memory."""
    assert cam_search.vote_table_len(6, sampled=False) == 193
    assert cam_search.vote_table_len(6, sampled=True) == 0
    assert cam_search.vote_table_len(100, sampled=False) == \
        cam_search.VOTE_TABLE_MAX

    def smem(sizes):
        ws = [torch.zeros((n, -(-k // 32)), dtype=torch.int32)
              for k, n in zip(sizes[:-2], sizes[1:-1])]
        head = torch.zeros((sizes[-1], -(-(sizes[-2] + 64) // 32)),
                           dtype=torch.int32)
        return fused_mlp.mlp_smem_bytes(-(-sizes[0] // 32), ws, head, 32,
                                        sampled=False)

    base, rows = smem((4096, 128, 20))
    assert (base, rows) == (4 * (256 + 196 + 64 * (132 + 12)),
                            4 * (128 * 132 + 24 * 12))
    assert fused_mlp.rows_in_smem(base, rows)
    base, rows = smem((784, 128, 10))
    assert rows < fused_mlp.ROWS_SMEM_MIN
    assert not fused_mlp.rows_in_smem(base, rows)
    base, rows = smem((4096, 512, 20))
    assert base <= fused_mlp.SMEM_LIMIT < base + rows
    assert not fused_mlp.rows_in_smem(base, rows)
