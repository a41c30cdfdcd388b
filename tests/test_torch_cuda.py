"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and the pipeline and server on the card against the CPU.

Every test here needs an NVIDIA card (marker `cuda`) and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import pipeline as tpipe
from repro_torch.configs.paper_cnn import build_cnn_pipeline
from repro_torch.core import binarize, bnn, cam, convnet, ensemble, mapping
from repro_torch.core.device_model import NOISELESS, SILICON
from repro_torch.data import synthetic
from repro_torch.kernels import (binary_gemm, cam_search, fused_conv,
                                 fused_mlp, ops)
from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
from repro_torch.spec import InferenceSpec

pytestmark = pytest.mark.cuda

# (M, N, K bits): single word, n_bits % 32 != 0, Kw below one 32-word
# tile, ragged M/N, K over one tile, and the HG layer-1 shape; then the
# edges of the tensor-core tile (32 x 128 outputs, K in 16-word chunks
# of 8-word steps): M = 4095 / 4097, N = 10 / 20 (the heads) / 129,
# Kw = 1, 6, 7 (odd: 4-byte copies), 36, 225 (the CNN FC shapes)
GEMM_SHAPES = [(1, 1, 32), (8, 10, 192), (33, 7, 64), (20, 40, 300),
               (5, 3, 1100), (4096, 128, 4096),
               (4095, 128, 225 * 32), (4097, 20, 6 * 32), (4096, 10, 6 * 32),
               (4097, 129, 36 * 32), (4095, 129, 32), (33, 129, 7 * 32),
               (100, 20, 7 * 32 - 5)]
# hidden/head widths and bias cells: the three bank nets, a deep net, a
# head-only net, MNIST and HG
NETS = [(300, 192, 12, 64), (784, 64, 10, 64), (96, 32, 5, 32),
        (120, 96, 64, 33, 7, 64), (128, 10, 64), (784, 128, 10, 64),
        (4096, 128, 20, 64)]
SPECS = (InferenceSpec(), InferenceSpec(reduction="argmax"),
         InferenceSpec(cumulative=True))
# tests/test_conv.py's CNN configs: (side, thermometer width, conv specs,
# hidden, classes) — MNIST and HG at the paper's widths, unaligned
# channels with a stride-1 layer, and conv -> head direct
CNNS = {
    "mnist-28": (28, 8, ((3, 32, 2), (3, 32, 2)), (128,), 10),
    "hg-64": (64, 4, ((3, 32, 2), (3, 32, 2)), (128,), 20),
    "unaligned-12": (12, 3, ((3, 24, 2), (3, 20, 1)), (48,), 7),
    "head-direct-10": (10, 2, ((3, 32, 2),), (), 5),
}


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)


def _packed(rng, n, k, dev):
    bits = rng.integers(0, 2, (n, k)).astype(np.uint8)
    return binarize.words_to_torch(binarize.np_pack_bits(bits), dev)


def _folded(sizes, seed, bias):
    rng = np.random.default_rng(seed)
    return [bnn.FoldedLayer(
        weights_pm1=rng.choice([-1, 1], (n_out, n_in)).astype(np.int8),
        c=bnn.parity_adjust_c(rng.integers(-bias, bias + 1, n_out), n_in,
                              bias))
        for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def _thresholds(form, rng, b, c, k, dev):
    base = k // 2 - 32 + np.arange(0, 65, 2)
    samples = None
    if form == "float":
        base = base + rng.uniform(-1, 1, base.shape).astype(np.float32)
    elif form == "sampled":
        samples = torch.from_numpy((base[None, None, :] + rng.normal(
            0, 3, (b, c, base.size))).astype(np.float32)).to(dev)
    thr = torch.from_numpy(base.astype(
        np.float32 if form == "float" else np.int32)).to(dev)
    return thr, samples


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_binary_gemm_equals_plain(dev, m, n, k):
    rng = np.random.default_rng(k)
    x, w = _packed(rng, m, k, dev), _packed(rng, n, k, dev)
    before = binary_gemm.binary_gemm_hd.launches
    got = binary_gemm.binary_gemm_hd(x, w)
    torch.cuda.synchronize()
    assert binary_gemm.binary_gemm_hd.launches == before + 1
    assert torch.equal(got, binary_gemm.binary_gemm_hd_plain(x, w))


@pytest.mark.parametrize("kw", [6, 7, 225])
def test_binary_gemm_views_off_16_bytes_equal_plain(dev, kw):
    """Row views whose first word is not on a 16-byte boundary: the
    kernel's aligned granules reach back before the view and past it."""
    rng = np.random.default_rng(kw)
    x_full = _packed(rng, 4100, 32 * kw, dev)
    w_full = _packed(rng, 131, 32 * kw, dev)
    for lo in (1, 2, 3):
        x, w = x_full[lo:lo + 4096], w_full[lo:]
        assert torch.equal(binary_gemm.binary_gemm_hd(x, w),
                           binary_gemm.binary_gemm_hd_plain(x, w))


@pytest.mark.parametrize("form", ["int", "float", "sampled"])
@pytest.mark.parametrize("b,c,k", [(1000, 20, 192), (7, 3, 40)])
def test_cam_vote_equals_plain(dev, form, b, c, k):
    rng = np.random.default_rng(b)
    q, rows = _packed(rng, b, k, dev), _packed(rng, c, k, dev)
    thr, samples = _thresholds(form, rng, b, c, k, dev)
    before = cam_search.cam_vote.launches
    got = cam_search.cam_vote(q, rows, thr, thr_samples=samples)
    assert cam_search.cam_vote.launches == before + 1
    assert torch.equal(got, cam_search.cam_vote_plain(q, rows, thr,
                                                      thr_samples=samples))


@pytest.mark.parametrize("net", NETS, ids=lambda n: "-".join(map(str, n)))
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_equals_plain(dev, net, form):
    *sizes, bias = net
    pipe = tpipe.compile_pipeline(_folded(sizes, 11, bias),
                                  ensemble.EnsembleConfig(bias_cells=bias),
                                  device=dev)
    rng = np.random.default_rng(2)
    b = 1001
    x = torch.from_numpy(rng.choice([-1.0, 1.0], (b, sizes[0])).astype(
        np.float32)).to(dev)
    xq = pipe._pack_input(x)
    thr, samples = _thresholds(form, rng, b, sizes[-1], sizes[-2] + bias,
                               dev)
    args = (xq, pipe.layer_ws, pipe.layer_cs, pipe.layer_n_bits,
            pipe.head.cam.rows_packed, thr)
    before = fused_mlp.fused_mlp_votes.launches
    got = fused_mlp.fused_mlp_votes(*args, bias_cells=bias,
                                    thr_samples=samples)
    assert fused_mlp.fused_mlp_votes.launches == before + 1
    assert torch.equal(got, fused_mlp.fused_mlp_votes_plain(
        *args, bias_cells=bias, thr_samples=samples))


def test_fused_mlp_sign_at_zero_equals_plain(dev):
    """C = 0 with an even fan-in makes y = 0 common: 0 maps to +1."""
    pipe = tpipe.compile_pipeline(_folded((64, 32, 6), 4, 64),
                                  ensemble.EnsembleConfig(), device=dev)
    x = torch.from_numpy(np.random.default_rng(6).choice(
        [-1.0, 1.0], (999, 64)).astype(np.float32)).to(dev)
    cs = [torch.zeros(32, dtype=torch.int32, device=dev)]
    args = (pipe._pack_input(x), pipe.layer_ws, cs, pipe.layer_n_bits,
            pipe.head.cam.rows_packed, pipe.head.thresholds)
    assert torch.equal(fused_mlp.fused_mlp_votes(*args, bias_cells=64),
                       fused_mlp.fused_mlp_votes_plain(*args, bias_cells=64))


def test_fused_mlp_guards(dev):
    sizes = (40,) * 10 + (5,)
    pipe = tpipe.compile_pipeline(_folded(sizes, 1, 64),
                                  ensemble.EnsembleConfig(), device=dev)
    x = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="hidden layers"):
        fused_mlp.fused_mlp_votes(x, pipe.layer_ws, pipe.layer_cs,
                                  pipe.layer_n_bits, pipe.head.cam.rows_packed,
                                  pipe.head.thresholds, bias_cells=64)
    with pytest.raises(ValueError, match="bq"):
        fused_mlp.fused_mlp_votes(x, [], [], [], x, pipe.head.thresholds,
                                  bias_cells=0, bq=12)


# kernels 2 and 3 on the FC/head stage: nets at the tiles' edges (100
# hidden neurons, not a multiple of 8; 20 and 100 classes; rows read from
# global memory, and rows of 55 KB staged in shared memory), eight hidden
# layers of odd widths, and a 512-neuron layer on the HG input, whose
# rows do not fit in shared memory (read from global memory)
EDGE_NETS = [(200, 100, 20, 64), (96, 40, 100, 32), (4096, 100, 100, 32)]
DEEP_NET = (64, 48, 40, 33, 96, 20, 64, 128, 70, 12, 32)
WIDE_NET = (4096, 512, 20, 64)


def _mlp_args(sizes, bias, b, form, dev, seed=2, p=None):
    """Kernel 3's operands for a random net: packed ±1 queries, the
    pipeline's rows and C's, and a threshold form (`p` thresholds in
    steps of 1 where given, else the paper's 33 in steps of 2)."""
    pipe = tpipe.compile_pipeline(_folded(sizes, 11, bias),
                                  ensemble.EnsembleConfig(bias_cells=bias),
                                  device=dev)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.choice([-1.0, 1.0], (b, sizes[0])).astype(
        np.float32)).to(dev)
    k = sizes[-2] + bias
    if p is None:
        thr, samples = _thresholds(form, rng, b, sizes[-1], k, dev)
    else:
        base = k // 2 - p // 2 + np.arange(p)
        samples = None
        if form == "sampled":
            samples = torch.from_numpy((base[None, None, :] + rng.normal(
                0, 3, (b, sizes[-1], p))).astype(np.float32)).to(dev)
        thr = torch.from_numpy(
            (base + 0.5).astype(np.float32) if form == "float"
            else base.astype(np.int32)).to(dev)
    return (pipe._pack_input(x), pipe.layer_ws, pipe.layer_cs,
            pipe.layer_n_bits, pipe.head.cam.rows_packed, thr), samples


def _check_fused_mlp(args, bias, samples=None, **kw):
    """One launch of kernel 3, counted, `torch.equal` to its plain
    version."""
    before = fused_mlp.fused_mlp_votes.launches
    got = fused_mlp.fused_mlp_votes(*args, bias_cells=bias,
                                    thr_samples=samples, **kw)
    torch.cuda.synchronize()
    assert fused_mlp.fused_mlp_votes.launches == before + 1
    assert torch.equal(got, fused_mlp.fused_mlp_votes_plain(
        *args, bias_cells=bias, thr_samples=samples))


@pytest.mark.parametrize("net", EDGE_NETS,
                         ids=lambda n: "-".join(map(str, n)))
@pytest.mark.parametrize("b", [1, 15, 16, 17, 4097])
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_batch_edges_equal_plain(dev, net, b, form):
    """Batches around the m16 tile and the 32-query block tile, with the
    rows read from global memory or staged in shared memory."""
    *sizes, bias = net
    args, samples = _mlp_args(sizes, bias, b, form, dev, seed=b)
    base, rows = fused_mlp.mlp_smem_bytes(args[0].shape[1], args[1],
                                          args[4], 32, samples is not None)
    assert fused_mlp.rows_in_smem(base, rows) == (sizes[0] == 4096)
    _check_fused_mlp(args, bias, samples)


@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_eight_layers_equal_plain(dev, form):
    *sizes, bias = DEEP_NET
    assert len(sizes) - 2 == fused_mlp.MAX_LAYERS
    args, samples = _mlp_args(sizes, bias, 333, form, dev)
    _check_fused_mlp(args, bias, samples)


@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_head_only_equal_plain(dev, form):
    """No hidden layers: the query is `cam.query_with_bias` of ±1
    activations, the head stage alone."""
    folded = _folded((128, 20), 3, 64)
    head = ensemble.build_head(folded[-1], ensemble.EnsembleConfig())
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.choice([-1.0, 1.0], (1001, 128)).astype(
        np.float32)).to(dev)
    q = cam.query_with_bias(h, 64)
    thr, samples = _thresholds(form, rng, 1001, 20, 192, dev)
    args = (q, [], [], [], head.cam.rows_packed.to(dev), thr)
    _check_fused_mlp(args, 64, samples)


@pytest.mark.parametrize("b", [1, 15, 16, 17, 4097])
def test_fused_mlp_sign_at_zero_batch_edges(dev, b):
    """C = 0 with an even fan-in (y = 0 common, mapped to +1) at the
    tiles' edges."""
    pipe = tpipe.compile_pipeline(_folded((64, 32, 6), 4, 64),
                                  ensemble.EnsembleConfig(), device=dev)
    x = torch.from_numpy(np.random.default_rng(b).choice(
        [-1.0, 1.0], (b, 64)).astype(np.float32)).to(dev)
    cs = [torch.zeros(32, dtype=torch.int32, device=dev)]
    args = (pipe._pack_input(x), pipe.layer_ws, cs, pipe.layer_n_bits,
            pipe.head.cam.rows_packed, pipe.head.thresholds)
    _check_fused_mlp(args, 64)


@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_rows_from_global_equal_plain(dev, form):
    """A net whose rows do not fit in shared memory beside the tiles:
    the stage reads them from global memory."""
    *sizes, bias = WIDE_NET
    args, samples = _mlp_args(sizes, bias, 1001, form, dev)
    base, rows = fused_mlp.mlp_smem_bytes(args[0].shape[1], args[1],
                                          args[4], 32, samples is not None)
    assert base <= fused_mlp.SMEM_LIMIT < base + rows
    assert not fused_mlp.rows_in_smem(base, rows)
    _check_fused_mlp(args, bias, samples)


@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_mlp_256_thresholds_equal_plain(dev, form):
    *sizes, bias = EDGE_NETS[0]
    args, samples = _mlp_args(sizes, bias, 1001, form, dev, p=256)
    assert args[5].shape[0] == 256
    _check_fused_mlp(args, bias, samples)


@pytest.mark.parametrize("bq", [16, 32, 64])
def test_fused_mlp_tile_loop_equal_plain(dev, bq):
    """More tiles than one wave of blocks: each block walks several,
    fetching the next tile's input while the current one runs."""
    args, _ = _mlp_args((784, 128, 10), 64, 40000 + bq, "int", dev)
    _check_fused_mlp(args, 64, bq=bq)


@pytest.mark.parametrize("c", [3, 20, 100])
@pytest.mark.parametrize("kw", [1, 6, 33])
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_cam_vote_tile_edges_equal_plain(dev, c, kw, form):
    rng = np.random.default_rng(c * 100 + kw)
    b = 1001
    q, rows = _packed(rng, b, 32 * kw, dev), _packed(rng, c, 32 * kw, dev)
    thr, samples = _thresholds(form, rng, b, c, 32 * kw, dev)
    before = cam_search.cam_vote.launches
    got = cam_search.cam_vote(q, rows, thr, thr_samples=samples)
    torch.cuda.synchronize()
    assert cam_search.cam_vote.launches == before + 1
    assert torch.equal(got, cam_search.cam_vote_plain(q, rows, thr,
                                                      thr_samples=samples))


@pytest.mark.parametrize("c,kw", [(100, 80), (3, 900)])
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_cam_vote_wide_rows_equal_plain(dev, c, kw, form):
    """Class rows of 80 words (three K chunks of 32 through the ring) and
    of 900 words (29 chunks, a 32-query tile of 116 KB in shared
    memory)."""
    rng = np.random.default_rng(kw)
    b = 777
    q, rows = _packed(rng, b, 32 * kw, dev), _packed(rng, c, 32 * kw, dev)
    thr, samples = _thresholds(form, rng, b, c, 32 * kw, dev)
    plan = cam_search.cam_plan(b, c, kw, samples is not None)
    assert plan["n_chunks"] == -(-kw // cam_search.CAM_MAX_KC)
    assert plan["bq"] == 32 and plan["smem"] <= cam_search.SMEM_LIMIT
    before = cam_search.cam_vote.launches
    got = cam_search.cam_vote(q, rows, thr, thr_samples=samples)
    torch.cuda.synchronize()
    assert cam_search.cam_vote.launches == before + 1
    assert torch.equal(got, cam_search.cam_vote_plain(q, rows, thr,
                                                      thr_samples=samples))


@pytest.mark.parametrize("b", [1, 17, 40001])
def test_cam_vote_batch_edges_equal_plain(dev, b):
    """A lone query, one past an m16 tile, and more tiles than a wave."""
    rng = np.random.default_rng(b)
    q, rows = _packed(rng, b, 192, dev), _packed(rng, 20, 192, dev)
    thr, _ = _thresholds("int", rng, b, 20, 192, dev)
    before = cam_search.cam_vote.launches
    got = cam_search.cam_vote(q, rows, thr)
    torch.cuda.synchronize()
    assert cam_search.cam_vote.launches == before + 1
    assert torch.equal(got, cam_search.cam_vote_plain(q, rows, thr))


@pytest.mark.parametrize("net", NETS, ids=lambda n: "-".join(map(str, n)))
def test_pipeline_on_card_equals_cpu(dev, net):
    *sizes, bias = net
    folded, cfg = _folded(sizes, 5, bias), ensemble.EnsembleConfig(
        bias_cells=bias)
    cpu = tpipe.compile_pipeline(folded, cfg, device="cpu", min_bucket=8)
    x = np.random.default_rng(9).choice([-1.0, 1.0], (333, sizes[0]))
    card = tpipe.compile_pipeline(folded, cfg, min_bucket=8)
    assert card.device.type == "cuda"
    for spec in SPECS:
        assert torch.equal(card.run(x, spec).cpu(), cpu.run(x, spec))


def test_head_vote_on_card_equals_fused(dev):
    folded = _folded((64, 10), 3, 64)
    head = ensemble.build_head(folded[-1], ensemble.EnsembleConfig())
    h = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 1.0], (500, 64)).astype(np.float32))
    want = ensemble.votes_fused(head, h)
    before = fused_mlp.fused_mlp_votes.launches
    got = ensemble.votes_kernel(head.to(dev), h.to(dev))
    assert fused_mlp.fused_mlp_votes.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(cam.query_with_bias(h.to(dev), 64).cpu(),
                       cam.query_with_bias(h, 64))


def test_served_on_card_equals_direct(dev):
    pipes = {f"n{i}": tpipe.compile_pipeline(
        _folded(net[:-1], i, net[-1]),
        ensemble.EnsembleConfig(bias_cells=net[-1]), min_bucket=8)
        for i, net in enumerate(NETS[:3])}
    server = PicBnnServer(BatchingPolicy(max_batch=32, max_wait_us=500))
    for name, pipe in pipes.items():
        server.register(name, pipe)
    server.warmup()
    rng = np.random.default_rng(0)
    xs = {n: rng.choice([-1.0, 1.0], (70, p.n_in)).astype(np.float32)
          for n, p in pipes.items()}
    with server:
        singles = {n: [server.submit(n, x[i]) for i in range(30)]
                   for n, x in xs.items()}
        bursts = {n: server.submit_many(n, x[30:]) for n, x in xs.items()}
        for n, pipe in pipes.items():
            direct = pipe.run(xs[n], InferenceSpec()).cpu().numpy()
            np.testing.assert_array_equal(
                np.stack([h.result(timeout=60).votes for h in singles[n]]),
                direct[:30])
            np.testing.assert_array_equal(bursts[n].votes_all(timeout=60),
                                          direct[30:])
    assert server.stats().n_requests == 70 * len(pipes)


def _cnn(name, dev, seed=1, **kw):
    side, width, convs, hidden, n_cls = CNNS[name]
    cfg = convnet.CNNConfig(
        side=side, encoding=binarize.InputEncoding("thermometer", width),
        conv=tuple(convnet.ConvSpec(*c) for c in convs), hidden=hidden,
        n_classes=n_cls)
    folded = convnet.random_folded_cnn(cfg, seed=seed)
    return cfg, folded, build_cnn_pipeline(cfg, folded, device=dev, **kw)


def _conv_args(pipe, x):
    conv = pipe.conv
    xp = conv.maps(conv.pack(x))
    return (xp, conv.ws, conv.cs, conv.metas, pipe.layer_ws, pipe.layer_cs,
            pipe.layer_n_bits, pipe.head.cam.rows_packed)


@pytest.mark.parametrize("name", sorted(CNNS))
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_conv_equals_plain(dev, name, form):
    cfg, _, pipe = _cnn(name, dev)
    rng = np.random.default_rng(3)
    b = 333
    x = torch.from_numpy(rng.random((b, cfg.n_in)).astype(np.float32)).to(dev)
    args = _conv_args(pipe, x)
    head = pipe.head
    thr, samples = _thresholds(form, rng, b, head.n_classes, head.cam.n_bits,
                               dev)
    kw = dict(bias_cells=head.bias_cells, head_direct=not cfg.hidden,
              thr_samples=samples)
    before = fused_conv.fused_conv_votes.launches
    got = fused_conv.fused_conv_votes(*args, thr, **kw)
    torch.cuda.synchronize()
    assert fused_conv.fused_conv_votes.launches == before + 1
    assert torch.equal(got, fused_conv.fused_conv_votes_plain(*args, thr,
                                                              **kw))


@pytest.mark.parametrize("name", sorted(CNNS))
def test_conv_stage_equals_plain(dev, name):
    cfg, _, pipe = _cnn(name, dev, seed=2)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (257, cfg.n_in)).astype(np.float32)).to(dev)
    xp, ws, cs, metas = _conv_args(pipe, x)[:4]
    bias = pipe.head.bias_cells if not cfg.hidden else 0
    before = fused_conv.conv_stage_packed.launches
    got = fused_conv.conv_stage_packed(xp, ws, cs, metas, bias_cells=bias)
    assert fused_conv.conv_stage_packed.launches == before + 1
    want = fused_conv.conv_stage_packed_plain(
        xp, ws, cs, metas, fused_conv.bias_drive_words(bias) if bias else None)
    assert torch.equal(got, want)
    kw_q = want.shape[1] + 3  # zero words up to a wider operand
    assert torch.equal(
        fused_conv.conv_stage_packed(xp, ws, cs, metas, bias_cells=bias,
                                     kw_q=kw_q),
        fused_conv.conv_stage_packed_plain(
            xp, ws, cs, metas,
            fused_conv.bias_drive_words(bias) if bias else None, kw_q))
    # an empty batch launches nothing, and counts nothing
    before = fused_conv.conv_stage_packed.launches
    assert fused_conv.conv_stage_packed(xp[:0], ws, cs, metas,
                                        bias_cells=bias).shape[0] == 0
    assert fused_conv.conv_stage_packed.launches == before


def test_fused_conv_sign_at_zero_equals_plain(dev):
    """C = 0 with an even dot width (k = 3, c_in = 2: 18 bits): y = 0 is
    common and maps to +1."""
    cfg, _, pipe = _cnn("head-direct-10", dev, seed=6)
    x = torch.from_numpy(np.random.default_rng(6).random(
        (199, cfg.n_in)).astype(np.float32)).to(dev)
    args = list(_conv_args(pipe, x))
    assert args[3][0].n_bits == 18
    args[2] = [torch.zeros(32, dtype=torch.int32, device=dev)]
    kw = dict(bias_cells=pipe.head.bias_cells, head_direct=True)
    thr = pipe.head.thresholds
    assert torch.equal(fused_conv.fused_conv_votes(*args, thr, **kw),
                       fused_conv.fused_conv_votes_plain(*args, thr, **kw))
    assert torch.equal(
        fused_conv.conv_stage_packed(*args[:4], bias_cells=64),
        fused_conv.conv_stage_packed_plain(
            *args[:4], fused_conv.bias_drive_words(64)))


@pytest.mark.parametrize("name", sorted(CNNS))
@pytest.mark.parametrize("b", [1, fused_conv.QUERIES_PER_BLOCK - 1,
                               fused_conv.QUERIES_PER_BLOCK + 1])
def test_fused_conv_block_edges_equal_plain(dev, name, b):
    """Batches around one block's queries: a lone query, a block short
    of one, and one query into a second block."""
    cfg, _, pipe = _cnn(name, dev, seed=8)
    x = torch.from_numpy(np.random.default_rng(b).random(
        (b, cfg.n_in)).astype(np.float32)).to(dev)
    args = _conv_args(pipe, x)
    head = pipe.head
    kw = dict(bias_cells=head.bias_cells, head_direct=not cfg.hidden)
    before = (fused_conv.fused_conv_votes.launches,
              fused_conv.conv_stage_packed.launches)
    got = fused_conv.fused_conv_votes(*args, head.thresholds, **kw)
    bias = head.bias_cells if not cfg.hidden else 0
    stage = fused_conv.conv_stage_packed(*args[:4], bias_cells=bias)
    torch.cuda.synchronize()
    assert (fused_conv.fused_conv_votes.launches,
            fused_conv.conv_stage_packed.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert torch.equal(got, fused_conv.fused_conv_votes_plain(
        *args, head.thresholds, **kw))
    assert torch.equal(stage, fused_conv.conv_stage_packed_plain(
        *args[:4], fused_conv.bias_drive_words(bias) if bias else None))


@pytest.mark.parametrize("b", [1, fused_conv.QUERIES_PER_BLOCK - 1,
                               fused_conv.QUERIES_PER_BLOCK + 1, 199])
def test_fused_conv_sign_at_zero_block_edges(dev, b):
    """The sign-at-zero net (c_in = 2, C = 0) at the block's edges."""
    cfg, _, pipe = _cnn("head-direct-10", dev, seed=6)
    x = torch.from_numpy(np.random.default_rng(b + 1).random(
        (b, cfg.n_in)).astype(np.float32)).to(dev)
    args = list(_conv_args(pipe, x))
    args[2] = [torch.zeros(32, dtype=torch.int32, device=dev)]
    kw = dict(bias_cells=pipe.head.bias_cells, head_direct=True)
    thr = pipe.head.thresholds
    assert torch.equal(fused_conv.fused_conv_votes(*args, thr, **kw),
                       fused_conv.fused_conv_votes_plain(*args, thr, **kw))
    assert torch.equal(
        fused_conv.conv_stage_packed(*args[:4], bias_cells=64),
        fused_conv.conv_stage_packed_plain(
            *args[:4], fused_conv.bias_drive_words(64)))


# maps of 8 and 16 channels after the input (taps on whole, zero-padded
# channel words) with a flatten that is not word-aligned; an input of 20
# channels (whole words, not compacted); two 5x5 layers on 128 channels
# (100 dense words a position, 13 K steps; filters fill most of shared
# memory)
ODD_MAPS = {
    "narrow": (13, 5, ((3, 8, 1), (3, 16, 2)), (40,), 6),
    "wide-input": (9, 20, ((3, 32, 2),), (16,), 4),
    "wide-taps": (16, 2, ((3, 128, 1), (5, 128, 1), (5, 128, 1)), (8,), 3),
}


@pytest.mark.parametrize("name", sorted(ODD_MAPS))
@pytest.mark.parametrize("form", ["int", "float", "sampled"])
def test_fused_conv_narrow_maps_equal_plain(dev, form, name):
    side, width, convs, hidden, n_cls = ODD_MAPS[name]
    cfg = convnet.CNNConfig(
        side=side, encoding=binarize.InputEncoding("thermometer", width),
        conv=tuple(convnet.ConvSpec(*c) for c in convs), hidden=hidden,
        n_classes=n_cls)
    pipe = build_cnn_pipeline(cfg, convnet.random_folded_cnn(cfg, seed=3),
                              device=dev)
    rng = np.random.default_rng(7)
    b = 37
    x = torch.from_numpy(rng.random((b, cfg.n_in)).astype(np.float32)).to(dev)
    args = _conv_args(pipe, x)
    head = pipe.head
    thr, samples = _thresholds(form, rng, b, head.n_classes, head.cam.n_bits,
                               dev)
    kw = dict(bias_cells=head.bias_cells, thr_samples=samples)
    assert torch.equal(fused_conv.fused_conv_votes(*args, thr, **kw),
                       fused_conv.fused_conv_votes_plain(*args, thr, **kw))
    assert torch.equal(fused_conv.conv_stage_packed(*args[:4]),
                       fused_conv.conv_stage_packed_plain(*args[:4]))


def test_fused_conv_guards(dev):
    # deeper than the kernel's conv cap
    deep = convnet.CNNConfig(
        side=4, encoding=binarize.InputEncoding("thermometer", 2),
        conv=(convnet.ConvSpec(1, 32, 1),) * (fused_conv.MAX_CONV + 1),
        hidden=(8,), n_classes=3)
    pipe = build_cnn_pipeline(deep, convnet.random_folded_cnn(deep, 0),
                              device=dev)
    with pytest.raises(ValueError, match="conv layers"):
        pipe.run(np.zeros((2, deep.n_in), np.float32), InferenceSpec())
    # 16 queries of a 400 x 400 image overflow a block's shared memory
    # (the input compacted to 1 bit a pixel: 20 KB a query)
    wide = convnet.CNNConfig(
        side=400, encoding=binarize.InputEncoding("thermometer", 1),
        conv=(convnet.ConvSpec(3, 32, 8),), hidden=(8,), n_classes=3)
    pipe = build_cnn_pipeline(wide, convnet.random_folded_cnn(wide, 0),
                              device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        pipe.run(np.zeros((2, wide.n_in), np.float32), InferenceSpec())
    # operands on another device than the input
    cfg, _, pipe = _cnn("unaligned-12", dev)
    args = list(_conv_args(pipe, torch.zeros((3, cfg.n_in), device=dev)))
    args[1] = [w.cpu() for w in args[1]]
    with pytest.raises(ValueError, match="conv rows is on cpu"):
        fused_conv.fused_conv_votes(*args, pipe.head.thresholds,
                                    bias_cells=pipe.head.bias_cells)


@pytest.mark.parametrize("name", sorted(CNNS))
def test_cnn_pipeline_on_card_equals_cpu(dev, name):
    cfg, folded, card = _cnn(name, None, seed=5, min_bucket=8)
    assert card.device.type == "cuda"
    cpu = build_cnn_pipeline(cfg, folded, device="cpu", min_bucket=8)
    x = np.random.default_rng(9).random((133, cfg.n_in)).astype(np.float32)
    for spec in SPECS:
        for b in (1, 133):
            assert torch.equal(card.run(x[:b], spec).cpu(),
                               cpu.run(x[:b], spec))


def test_served_cnn_on_card_equals_direct(dev):
    cfg, _, pipe = _cnn("mnist-28", None, seed=7, min_bucket=8)
    server = PicBnnServer(BatchingPolicy(max_batch=32, max_wait_us=500))
    server.register("cnn", pipe)
    server.warmup()
    x = np.random.default_rng(1).random((70, cfg.n_in)).astype(np.float32)
    direct = pipe.run(x, InferenceSpec()).cpu().numpy()
    with server:
        singles = [server.submit("cnn", x[i]) for i in range(30)]
        burst = server.submit_many("cnn", x[30:])
        np.testing.assert_array_equal(
            np.stack([h.result(timeout=60).votes for h in singles]),
            direct[:30])
        np.testing.assert_array_equal(burst.votes_all(timeout=60),
                                      direct[30:])


def test_spmd_two_streams_many_bursts_equal_direct(dev):
    """fanout="spmd" over [card, card]: each bucket split in two, each
    half on its own stream, gathered on the first.  Hundreds of bursts
    keep batches in flight back to back, so a slice's votes freed before
    the gather that reads them would be overwritten by the next batch."""
    _, _, cnn = _cnn("mnist-28", None, seed=7, min_bucket=8)
    pipes = {"mlp": tpipe.compile_pipeline(
        _folded(NETS[1][:-1], 1, NETS[1][-1]),
        ensemble.EnsembleConfig(bias_cells=NETS[1][-1]), min_bucket=8),
        "cnn": cnn}
    server = PicBnnServer(BatchingPolicy(max_batch=64, max_wait_us=200),
                          devices=[dev, dev], fanout="spmd")
    for name, pipe in pipes.items():
        server.register(name, pipe)
    server.warmup()
    rng = np.random.default_rng(2)
    xs = {"mlp": rng.choice([-1.0, 1.0], (4000, pipes["mlp"].n_in)),
          "cnn": rng.random((4000, pipes["cnn"].n_in))}
    xs = {n: x.astype(np.float32) for n, x in xs.items()}
    direct = {n: pipes[n].run(x, InferenceSpec()).cpu().numpy()
              for n, x in xs.items()}
    cuts = np.cumsum(rng.integers(1, 40, 400))
    cuts = cuts[cuts < 4000]
    with server:
        bursts = [(n, lo, hi, server.submit_many(n, xs[n][lo:hi]))
                  for lo, hi in zip(np.r_[0, cuts[:-1]], cuts)
                  for n in pipes]
        for n, lo, hi, h in bursts:
            np.testing.assert_array_equal(h.votes_all(timeout=120),
                                          direct[n][lo:hi])
    assert server.stats().n_requests == 2 * int(cuts[-1])


# ---------------------------------------------------------------------------
# silicon mode on the card: kernels 3 and 4 in their sampled form, fed by
# the port's sampler
# ---------------------------------------------------------------------------
SILICON_MODELS = {"mnist-mlp": (784, 128, 10, 64), "hg-mlp": (4096, 128, 20, 64),
                  "mnist-28": None, "unaligned-12": None}


def _silicon_pair(name):
    """(card pipeline, CPU pipeline, input batch maker) under SILICON."""
    if SILICON_MODELS[name] is None:
        cfg, folded, card = _cnn(name, None, seed=3, min_bucket=8,
                                 noise=SILICON)
        cpu = build_cnn_pipeline(cfg, folded, device="cpu", min_bucket=8,
                                 noise=SILICON)
        return card, cpu, lambda rng, b: rng.random((b, cfg.n_in)).astype(
            np.float32)
    *sizes, bias = SILICON_MODELS[name]
    folded = _folded(sizes, 4, bias)
    cfg = ensemble.EnsembleConfig(bias_cells=bias)
    card = tpipe.compile_pipeline(folded, cfg, min_bucket=8, noise=SILICON)
    cpu = tpipe.compile_pipeline(folded, cfg, device="cpu", min_bucket=8,
                                 noise=SILICON)
    return card, cpu, lambda rng, b: rng.choice(
        [-1.0, 1.0], (b, sizes[0])).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SILICON_MODELS))
@pytest.mark.parametrize("b", [1, 17, 4097])
def test_silicon_batch_votes_equal_replayed_samples(dev, name, b):
    """noise="batch" votes launch kernel 3 / 4 with the sampler's [B, C, P]
    operand; the same draw, replayed from the generator state and copied
    to the CPU, gives the same votes against the CPU pipeline's
    distances."""
    card, cpu, make = _silicon_pair(name)
    x = make(np.random.default_rng(b), b)
    gen = torch.Generator(dev).manual_seed(11)
    kernel = (fused_conv.fused_conv_votes if card.conv is not None
              else fused_mlp.fused_mlp_votes)
    for spec in (InferenceSpec(noise="batch"),
                 InferenceSpec(noise="batch", reduction="argmax")):
        state = gen.get_state()
        before = kernel.launches
        got = card.run(x, spec, key=gen).cpu()
        assert kernel.launches == before + 1
        replay = torch.Generator(dev)
        replay.set_state(state)
        bp = tpipe.next_bucket(b, 8)
        s = card.physics.sample(replay, (bp,), card.n_classes).cpu()
        xp, _ = cpu._bucketed(cpu._pack_input(torch.from_numpy(x)))
        votes = (cpu._head_distances(xp).float() <= s).sum(
            0, dtype=torch.int32)[:b]
        want = votes if spec.reduction == "none" else \
            torch.argmax(votes, dim=-1).to(torch.int32)
        assert torch.equal(got, want), spec.describe()


@pytest.mark.parametrize("name", ["mnist-mlp", "mnist-28"])
def test_silicon_hd_once_specs_on_card(dev, name):
    """Per-request (kernel 1 route): the card's votes equal its own compare
    of its keyed samples, agree with the CPU on nearly every vote, and
    NOISELESS pipelines give every noisy spec the noiseless votes."""
    card, cpu, make = _silicon_pair(name)
    x = make(np.random.default_rng(0), 300)
    keys = np.random.default_rng(1).integers(0, 2 ** 32, (300, 2),
                                             dtype=np.uint64).astype(np.uint32)
    spec = InferenceSpec(noise="per_request", mc_samples=4)
    before = binary_gemm.binary_gemm_hd.launches
    got = card.run(x, spec, keys=keys)
    assert binary_gemm.binary_gemm_hd.launches > before
    xp, _ = card._bucketed(card._pack_input(torch.from_numpy(x).to(dev)))
    kw = card._each_keys(keys, 300, xp.shape[0])
    t = card.physics.sample_keyed(kw, card.n_classes, 4)
    want = (card._head_distances(xp).float() <= t).sum(0, dtype=torch.int32)
    assert torch.equal(got, want[:, :300])
    agree = (got.cpu() == cpu.run(x, spec, keys=keys)).float().mean()
    assert agree > 0.999
    nl = dataclasses.replace(card, physics=card.physics.__class__.for_head(
        card.head, NOISELESS), _programs={})
    base = nl.run(x, InferenceSpec())
    gen = torch.Generator(dev).manual_seed(0)
    for s in (InferenceSpec(noise="batch"),
              InferenceSpec(noise="per_request"),
              InferenceSpec(noise="batch", cumulative=True)):
        out = nl.run(x, s, key=gen if s.needs_key else None,
                     keys=keys if s.needs_keys else None)
        assert torch.equal(out[-1] if s.cumulative else out, base)


def test_served_silicon_on_card_equals_direct(dev):
    card, _, make = _silicon_pair("mnist-mlp")
    x = make(np.random.default_rng(2), 70)
    keys = np.arange(140, dtype=np.uint32).reshape(70, 2)
    server = PicBnnServer(BatchingPolicy(max_batch=32, max_wait_us=500))
    server.register("si", card, mc_samples=3)
    server.warmup()
    spec = InferenceSpec(noise="per_request", mc_samples=3, reduction="sum")
    direct = card.run(x, spec, keys=keys).cpu().numpy()
    with server:
        singles = [server.submit("si", x[i], key=keys[i]) for i in range(30)]
        burst = server.submit_many("si", x[30:], keys=keys[30:])
        np.testing.assert_array_equal(
            np.stack([h.result(timeout=60).votes for h in singles]),
            direct[:30])
        np.testing.assert_array_equal(burst.votes_all(timeout=60),
                                      direct[30:])


# ---------------------------------------------------------------------------
# training on the card: a step against the CPU, the trained nets through
# kernels 3 and 4, the CAM mapping, the int8 product
# ---------------------------------------------------------------------------
# card vs CPU on the same params and batch: float32 sums in another order
# (cuDNN's TF32 is switched off for the comparison; the ±1 forward
# products are exact either way)
CARD_GRAD_TOL = 1e-5


def _train_models(which):
    """(loss, config, params drawn on the CPU, inputs, labels)."""
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    if which == "mlp":
        cfg = bnn.MLPConfig((784, 128, 10))
        x = rng.choice([-1.0, 1.0], (128, 784)).astype(np.float32)
        return bnn.loss_fn, cfg, bnn.init_params(gen, cfg), x, \
            rng.integers(0, 10, 128)
    side, width, convs, hidden, n_cls = CNNS["mnist-28"]
    cfg = convnet.CNNConfig(
        side=side, encoding=binarize.InputEncoding("thermometer", width),
        conv=tuple(convnet.ConvSpec(*c) for c in convs), hidden=hidden,
        n_classes=n_cls)
    x = rng.random((128, cfg.n_in)).astype(np.float32)
    return convnet.cnn_loss, cfg, convnet.init_cnn_params(gen, cfg), x, \
        rng.integers(0, n_cls, 128)


@pytest.mark.parametrize("which", ["mlp", "cnn"])
def test_training_step_on_card_equals_cpu(dev, which):
    loss, cfg, params, x, y = _train_models(which)
    out = []
    for d in (dev, torch.device("cpu")):
        p = {g: [{k: v.to(d).requires_grad_(k in bnn.TRAINED)
                  for k, v in layer.items()} for layer in ls]
             for g, ls in params.items()}
        leaves = [layer[k] for ls in p.values() for layer in ls
                  for k in bnn.TRAINED]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            value, new = loss(p, x, y, cfg)
            grads = torch.autograd.grad(value, leaves)
        out.append((value.detach().cpu(), [g.cpu() for g in grads],
                    [layer[k].detach().cpu() for ls in new.values()
                     for layer in ls for k in ("mean", "var")]))
    (lc, gc, sc), (lh, gh, sh) = out
    torch.testing.assert_close(lc, lh, rtol=0, atol=CARD_GRAD_TOL)
    for a, b in zip(gc + sc, gh + sh, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=CARD_GRAD_TOL)


def _trained_pair(dev):
    """A small MLP and CNN trained on the card for a few steps."""
    tx, ty, vx, vy = synthetic.make_dataset(synthetic.MNIST_LIKE, 512, 200)
    mcfg = bnn.MLPConfig((784, 64, 10))
    mlp = bnn.train_mlp(torch.Generator().manual_seed(0), mcfg,
                        synthetic.binarize_images(tx), ty, epochs=2,
                        batch=128, lr=2e-3)
    _, ccfg, _, _, _ = _train_models("cnn")
    cnn = convnet.train_cnn(torch.Generator().manual_seed(0), ccfg, tx, ty,
                            epochs=2, batch=128, lr=2e-3)
    assert mlp["layers"][0]["w"].device == dev  # the card by default
    assert cnn["conv"][0]["var"].device == dev
    return mcfg, mlp, ccfg, cnn, vx, vy


def test_trained_votes_through_kernels_on_card_equal_cpu(dev):
    mcfg, mlp, ccfg, cnn, vx, vy = _trained_pair(dev)
    vxb = synthetic.binarize_images(vx)
    for folded, x, kernel, kw in (
            (bnn.fold(mlp, mcfg), vxb, fused_mlp.fused_mlp_votes, {}),
            (convnet.fold_cnn(cnn, ccfg), vx, fused_conv.fused_conv_votes,
             dict(image_side=ccfg.side, image_encoding=ccfg.encoding))):
        card = tpipe.compile_pipeline(folded, ensemble.EnsembleConfig(), **kw)
        cpu = tpipe.compile_pipeline(folded, ensemble.EnsembleConfig(),
                                     device="cpu", **kw)
        before = kernel.launches
        for spec in SPECS[:2]:
            assert torch.equal(card.run(x, spec).cpu(), cpu.run(x, spec))
        assert kernel.launches > before


def test_layer_forward_on_card_equals_cpu(dev):
    mcfg, mlp, _, _, vx, _ = _trained_pair(dev)
    mapped = mapping.map_layer(bnn.fold(mlp, mcfg)[0], mcfg.bias_cells)
    assert len(mapped.col_tiles) == 4  # 784 bits on 256-bit rows
    x = torch.from_numpy(synthetic.binarize_images(vx))
    for mode in ("exact", "hierarchical"):
        got = mapping.layer_forward(mapped, x.to(dev), mode)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), mapping.layer_forward(mapped, x, mode))


@pytest.mark.parametrize("m", [1, 15, 17, 4096])
@pytest.mark.parametrize("k,n", [(7, 10), (100, 3), (785, 128), (64, 8)])
def test_binary_gemm_mxu_edges_equal_plain(dev, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.choice([-1.0, 1.0], (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.choice([-1.0, 1.0], (k, n)).astype(np.float32))
    got = ops.binary_gemm_mxu(x.to(dev), w.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), ops.binary_gemm_mxu_plain(x, w))
    # leading dimensions, as the reference's dot_general takes them
    got3 = ops.binary_gemm_mxu(x.reshape(1, m, k).to(dev), w.to(dev))
    assert torch.equal(got3.cpu(), got.cpu().reshape(1, m, n))


# ---------------------------------------------------------------------------
# The LM serving path: BitLinear FFN on kernel 1, CAM head on kernel 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 4, 17, 32])
@pytest.mark.parametrize("c,kw", [(128256, 64), (2048, 48), (50304, 80)])
def test_cam_vote_at_vocab_scale_equals_plain(dev, b, c, kw):
    """Kernel 2 at LM-head widths: vocabularies past the vote table's
    2,048 entries, on a grid of query tiles x row tiles."""
    from repro_torch.models.binary_lm import cam_thresholds
    from repro_torch import configs

    gen = torch.Generator(dev).manual_seed(c + b)
    q = torch.randint(-2 ** 31, 2 ** 31, (b, kw), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    rows = torch.randint(-2 ** 31, 2 ** 31, (c, kw), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    cfg = dataclasses.replace(configs.get_config("llama3.2-1b+cam-head"),
                              d_model=32 * kw, vocab_size=c)
    thr = cam_thresholds(cfg, dev)
    assert torch.equal(cam_search.cam_vote(q, rows, thr),
                       cam_search.cam_vote_plain(q, rows, thr))


@pytest.mark.parametrize("b", [1, 16, 17, 33])
@pytest.mark.parametrize("form", ["int", "float"])
def test_cam_vote_vocab_batches_equal_plain(dev, b, form):
    """C = 128,256: one 16-query tile (B <= 16), a 32-query tile with a
    live second m16 tile (17), and a second query tile (33); the int and
    float schedules, through the table (B >= 16) and counted (B = 1)."""
    rng = np.random.default_rng(b)
    q, rows = _packed(rng, b, 2048, dev), _packed(rng, 128256, 2048, dev)
    thr, _ = _thresholds(form, rng, b, 128256, 2048, dev)
    before = cam_search.cam_vote.launches
    got = cam_search.cam_vote(q, rows, thr)
    torch.cuda.synchronize()
    assert cam_search.cam_vote.launches == before + 1
    assert torch.equal(got, cam_search.cam_vote_plain(q, rows, thr))


def test_cam_vote_sampled_at_vocab_scale_equals_plain(dev):
    """The sampled form at C = 50,304 rows of 80 words, B = 2: every vote
    counts its own P samples."""
    rng = np.random.default_rng(50304)
    q, rows = _packed(rng, 2, 2560, dev), _packed(rng, 50304, 2560, dev)
    thr, samples = _thresholds("sampled", rng, 2, 50304, 2560, dev)
    assert torch.equal(cam_search.cam_vote(q, rows, thr, thr_samples=samples),
                       cam_search.cam_vote_plain(q, rows, thr,
                                                 thr_samples=samples))


@pytest.mark.parametrize("c", [63, 64, 65, 255, 256, 257, 128255, 128257])
@pytest.mark.parametrize("kw", [7, 64])
@pytest.mark.parametrize("form", ["int", "sampled"])
def test_cam_vote_row_tile_edges_equal_plain(dev, c, kw, form):
    """C at one row group (64 rows) and one row tile (256 rows at the
    vocabulary plan) +-1, and around C = 128,256; odd Kw takes the 4-byte
    copies."""
    rng = np.random.default_rng(c + kw)
    b = 5
    q, rows = _packed(rng, b, 32 * kw, dev), _packed(rng, c, 32 * kw, dev)
    thr, samples = _thresholds(form, rng, b, c, 32 * kw, dev)
    if c > 1000:
        plan = cam_search.cam_plan(b, c, kw, samples is not None)
        assert plan["gpb"] * cam_search.CAM_GROUP_ROWS == 256
    assert torch.equal(cam_search.cam_vote(q, rows, thr, thr_samples=samples),
                       cam_search.cam_vote_plain(q, rows, thr,
                                                 thr_samples=samples))


def test_cam_vote_views_off_16_bytes_equal_plain(dev):
    """Query and row views whose first word is not on 16 bytes: the
    kernel copies them word by word."""
    rng = np.random.default_rng(3)
    q_flat = _packed(rng, 5, 2048, dev).reshape(-1)
    r_flat = _packed(rng, 3001, 2048, dev).reshape(-1)
    thr, _ = _thresholds("int", rng, 4, 3000, 2048, dev)
    for lo in (1, 2, 3):
        q = q_flat[lo:lo + 4 * 64].view(4, 64)
        rows = r_flat[lo:lo + 3000 * 64].view(3000, 64)
        assert torch.equal(cam_search.cam_vote(q, rows, thr),
                           cam_search.cam_vote_plain(q, rows, thr))


def test_cam_plan_equals_launcher(dev):
    """`cam_plan` is the host twin of the launcher's plan."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.library("cam_search")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    v = (ctypes.c_int * 8)()
    modes = (cam_search.ROWS_WORDS, cam_search.ROWS_TMA,
             cam_search.ROWS_GLOBAL)
    for b in (1, 4, 16, 17, 32, 33, 777, 4096):
        for c, kw in ((10, 4), (20, 6), (2048, 48), (128256, 64), (3, 900),
                      (100, 80), (50304, 80)):
            for sampled, aligned in ((0, 0), (0, 1), (1, 1)):
                assert lib.cam_vote_plan(b, c, kw, sampled, aligned, sms,
                                         v) == 0
                p = cam_search.cam_plan(b, c, kw, bool(sampled),
                                        bool(aligned), sms)
                assert list(v) == [p["bq"], p["kc"], p["n_chunks"], p["gpb"],
                                   p["grid"][1], p["vtab_n"], p["smem"],
                                   modes.index(p["mode"])]


# kernel 1 at each plan's edges: (M, N, Kw) around the large tile (from
# three 32 x 128 blocks an SM on an H100: M at 32 x 132 +-1 with N = 256
# +-1; M and N off the tile by one), split_k's (M <= 16, Kw >= 64) and
# the 32 x 128 tile's, with Kw in {1, 7, 64, 225, 256}
PLAN_EDGES = [(4224, 256, 64), (4225, 256, 64), (4225, 255, 64),
              (16769, 257, 8), (8449, 511, 64), (8447, 513, 256),
              (4097, 2049, 256), (4097, 1023, 225), (700, 300, 7),
              (600, 300, 1), (16, 2048, 64), (17, 2048, 64), (1, 2049, 256),
              (4, 255, 225), (16, 9, 7), (4, 2048, 63), (3, 5, 1)]


@pytest.mark.parametrize("m,n,kw", PLAN_EDGES)
def test_binary_gemm_plan_edges_equal_plain(dev, m, n, kw):
    rng = np.random.default_rng(m + n + kw)
    x, w = _packed(rng, m, 32 * kw, dev), _packed(rng, n, 32 * kw, dev)
    before = binary_gemm.binary_gemm_hd.launches
    got = binary_gemm.binary_gemm_hd(x, w)
    torch.cuda.synchronize()
    assert binary_gemm.binary_gemm_hd.launches == before + 1
    assert torch.equal(got, binary_gemm.binary_gemm_hd_plain(x, w))


@pytest.mark.parametrize("m,n,kw", [(16900, 512, 64), (4, 512, 256),
                                    (64, 300, 64)])
def test_binary_gemm_views_off_16_bytes_at_each_plan(dev, m, n, kw):
    """Views off 16 bytes leave the large tile for the 32 x 128 one (its
    granules reach past the view); split_k reads words."""
    rng = np.random.default_rng(kw + m)
    x_flat = _packed(rng, m + 1, 32 * kw, dev).reshape(-1)
    w_flat = _packed(rng, n + 1, 32 * kw, dev).reshape(-1)
    for lo in (0, 1, 3):  # words: the rows' first words move off 16 bytes
        x = x_flat[lo:lo + m * kw].view(m, kw)
        w = w_flat[lo:lo + n * kw].view(n, kw)
        assert binary_gemm.words_aligned(x, w) == (lo == 0)
        assert torch.equal(binary_gemm.binary_gemm_hd(x, w),
                           binary_gemm.binary_gemm_hd_plain(x, w))


@pytest.mark.parametrize("m,n,kw", [(17000, 300, 64), (8, 300, 256),
                                    (100, 300, 7)])
def test_binary_gemm_all_ones_and_zero_rows(dev, m, n, kw):
    """All-ones against all-ones and all-zero rows (HD 0 and K) and words
    of bit 31 alone, at each plan: the one-product identity with every
    popcount at its extreme."""
    rng = np.random.default_rng(m)
    x, w = _packed(rng, m, 32 * kw, dev), _packed(rng, n, 32 * kw, dev)
    for t in (x, w):
        t[0], t[1], t[2] = -1, 0, -2 ** 31
        t[-1] = -1
    got = binary_gemm.binary_gemm_hd(x, w)
    assert torch.equal(got, binary_gemm.binary_gemm_hd_plain(x, w))
    assert int(got[0, 0]) == 0 and int(got[0, 1]) == 32 * kw
    assert int(got[-1, -1]) == 0 and int(got[1, 0]) == 32 * kw


def test_gemm_plan_equals_launcher(dev):
    """`gemm_plan` is the host twin of the launcher's plan."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.library("binary_gemm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    v = (ctypes.c_int * 4)()
    names = (binary_gemm.TILE32X128, binary_gemm.LARGE, binary_gemm.SPLIT_K)
    for m, n, kw in PLAN_EDGES + [(32768, 8192, 64), (32768, 2048, 256),
                                  (4096, 128, 128), (4, 8192, 64)]:
        for aligned in (0, 1):
            assert lib.binary_gemm_plan(m, n, kw, aligned, sms, v) == 0
            p = binary_gemm.gemm_plan(m, n, kw, bool(aligned), sms)
            assert [names[v[0]], v[1], v[2], v[3]] == \
                [p["plan"], *p["grid"], p["smem"]]


@pytest.mark.parametrize("arch", ["llama3.2-1b+binary-ffn+cam-head",
                                  "llama3.2-1b+cam-head-exact",
                                  "musicgen-medium+binary-ffn+cam-head"])
def test_lm_serving_on_card_launches_kernels_and_equals_cpu(dev, arch):
    """prefill + decode of a +smoke model (float32) on the card launch
    kernel 1 (BitLinear, exact head) and kernel 2 (votes head), and give
    the CPU's logits and votes on the same weights."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import steps

    cfg = configs.get_config(arch.replace("+", "+smoke+", 1))
    card = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    cpu = M.CausalLM(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    key = "embeds" if cfg.embeds_input else "tokens"
    rng = np.random.default_rng(1)
    seq = (torch.from_numpy(rng.standard_normal((3, 9, cfg.d_model))
                            .astype(np.float32)) if cfg.embeds_input
           else torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 9))))
    binary_gemm.binary_gemm_hd.launches = cam_search.cam_vote.launches = 0
    outs = {}
    for name, model, d in (("card", card, dev), ("cpu", cpu, "cpu")):
        lg, cache = steps.prefill_step(cfg, model, {key: seq[:, :8].to(d)})
        dec, _ = steps.decode_step(cfg, model, cache, seq[:, 8:9].to(d), 8)
        outs[name] = (lg.cpu(), dec.cpu())
    assert binary_gemm.binary_gemm_hd.launches > 0 or not cfg.binary_ffn
    votes = cfg.cam_head_mode == "votes"
    assert (cam_search.cam_vote.launches > 0) == votes
    np.testing.assert_allclose(outs["card"][0], outs["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(outs["card"][1], outs["cpu"][1])


@pytest.mark.parametrize("arch", ["llama3.2-1b+smoke",
                                  "llama3.2-1b+smoke+binary-ffn",
                                  "mixtral-8x7b+smoke"])
def test_lm_train_step_on_card_equals_cpu(dev, arch):
    """One train step (loss, grads, AdamW with float32 masters) on the card
    against the same on the CPU, float32 (TF32 off): loss to 1e-5
    relative, grad norm to 1e-4 relative, parameters after the update to
    1e-5; no kernel launches inside the step."""
    from repro_torch import configs
    from repro_torch.data.tokens import DataConfig, synthetic_stream
    from repro_torch.models import model as M
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(configs.get_config(arch), remat="full")
    tcfg = TrainConfig(opt=O.OptimizerConfig(warmup_steps=0))
    card = init_train_state(cfg, tcfg, torch.Generator(dev).manual_seed(0))
    cpu_model = M.CausalLM(cfg, "cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card["params"].state_dict().items()})
    cpu = {"params": cpu_model, "opt": O.init_opt_state(tcfg.opt, cpu_model)}
    batch = next(synthetic_stream(DataConfig(batch=4, seq_len=32,
                                             vocab_size=cfg.vocab_size)))
    step = make_train_step(cfg, tcfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    binary_gemm.binary_gemm_hd.launches = 0
    try:
        card, got = step(card, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert binary_gemm.binary_gemm_hd.launches == 0
    cpu, want = step(cpu, batch)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                    rel=1e-4)
    for k, p in card["params"].named_parameters():
        np.testing.assert_allclose(
            p.detach().cpu().numpy(),
            cpu["params"].get_parameter(k).detach().numpy(), atol=1e-5,
            rtol=0, err_msg=k)


def test_bf16_train_state_checkpoint_round_trips_on_card(dev, tmp_path):
    """A bf16 CausalLM train state on the card through AsyncCheckpointer
    and restore(device=): bit for bit, back on the card, and written
    into fresh live tensors by load_into."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.train import TrainConfig, init_train_state

    cfg = dataclasses.replace(configs.get_config("llama3.2-1b+smoke"),
                              dtype="bfloat16")
    state = init_train_state(cfg, TrainConfig(),
                             torch.Generator(dev).manual_seed(0))
    ac = ckpt.AsyncCheckpointer(tmp_path)
    ac.save_async(3, state)
    ac.wait()
    values, step = ckpt.restore(tmp_path, None, state, device=dev)
    assert step == 3
    assert values["params"]["embed"].dtype == torch.bfloat16
    assert values["params"]["embed"].device.type == "cuda"
    fresh = init_train_state(cfg, TrainConfig(),
                             torch.Generator(dev).manual_seed(1))
    ckpt.load_into(fresh, values)
    for (name, a), (_, b) in zip(ckpt.leaf_paths(fresh),
                                 ckpt.leaf_paths(state)):
        assert torch.equal(a, b), name
