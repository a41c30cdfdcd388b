"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and the pipeline and server on the card against the CPU.

Every test here needs an NVIDIA card (marker `cuda`) and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import pipeline as tpipe
from repro_torch.core import binarize, bnn, cam, ensemble
from repro_torch.kernels import binary_gemm, cam_search, fused_mlp
from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
from repro_torch.spec import InferenceSpec

pytestmark = pytest.mark.cuda

# (M, N, K bits): single word, n_bits % 32 != 0, Kw below one 32-word
# tile, ragged M/N, K over one tile, and the HG layer-1 shape
GEMM_SHAPES = [(1, 1, 32), (8, 10, 192), (33, 7, 64), (20, 40, 300),
               (5, 3, 1100), (4096, 128, 4096)]
# hidden/head widths and bias cells: the three bank nets, a deep net, a
# head-only net, MNIST and HG
NETS = [(300, 192, 12, 64), (784, 64, 10, 64), (96, 32, 5, 32),
        (120, 96, 64, 33, 7, 64), (128, 10, 64), (784, 128, 10, 64),
        (4096, 128, 20, 64)]
SPECS = (InferenceSpec(), InferenceSpec(reduction="argmax"),
         InferenceSpec(cumulative=True))


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
