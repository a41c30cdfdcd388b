"""The input-packing kernel (`kernels/pack_input.py`) and where the
pipeline takes it.

On the CPU: `_pack_input` keeps the plain route (`binarize.pack_pm1`, or
`InputEncoding.pack` through `ConvFront.pack`) and launches nothing; a
bit-plane code and a head-only MLP keep their own routes; the levels the
kernel makes are the float32 thermometer thresholds; the wrapper refuses
a wrong dtype, rank or device; and the plain twins' words equal the JAX
reference's (`repro.core.binarize`, imported inside those tests) on the
very inputs the card's tests feed the kernel, but for denormals: XLA
reads a denormal as zero, so a positive denormal packs 0 in the
reference and 1 in the port, whose compares are IEEE's (x > 0), and the
tests pin exactly those bits. On the card (marker `cuda`, skipped
without one): the kernel's words equal the plain twins' bit for bit, at
the benchmark's shape and at the edges (tail words, bit 31, zeros of
both signs, NaN, infinities, denormals, pixels on and one ulp off every
level, a code past the kernel's table of 1,024 levels, views), and `run`
on small HG-shaped pipelines launches it once a call and equals the CPU.
The card's run imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pack_input.py
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch import pipeline as tpipe
from repro_torch.configs.paper_cnn import build_cnn_pipeline
from repro_torch.core import binarize, bnn, convnet, ensemble
from repro_torch.core.cam import query_with_bias
from repro_torch.kernels import pack_input
from repro_torch.spec import InferenceSpec

WIDTHS = (1, 4, 8, 32, 33, 40)
ENCODINGS = [("thermometer", w) for w in WIDTHS] + [("sign", 1)]
# and a code wider than the kernel's shared table of 1,024 levels
KERNEL_ENCODINGS = ENCODINGS + [("thermometer", 1030)]
# the sign pack's shapes: the benchmark's, MNIST's 784 (24.5 words), one
# word and a bit, under one word, a single bit
SIGN_SHAPES = [(32768, 4096), (7, 784), (3, 33), (5, 31), (1, 1)]
F32 = np.finfo(np.float32)
SPECIAL = np.float32([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                      F32.smallest_subnormal, -F32.smallest_subnormal,
                      1e-40, -1e-40, F32.tiny, -F32.tiny, F32.max, -F32.max,
                      1.0, -1.0])


def _folded(sizes, seed, bias):
    rng = np.random.default_rng(seed)
    return [bnn.FoldedLayer(
        weights_pm1=rng.choice([-1, 1], (n_out, n_in)).astype(np.int8),
        c=bnn.parity_adjust_c(rng.integers(-bias, bias + 1, n_out), n_in,
                              bias))
        for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def _mlp(sizes, dev, bias=64):
    return tpipe.compile_pipeline(_folded(sizes, 11, bias),
                                  ensemble.EnsembleConfig(bias_cells=bias),
                                  device=dev)


def _cnn(encoding, dev, side=16, n_cls=5):
    cfg = convnet.CNNConfig(side=side, encoding=encoding,
                            conv=(convnet.ConvSpec(3, 32, 2),),
                            hidden=(32,), n_classes=n_cls)
    return build_cnn_pipeline(cfg, convnet.random_folded_cnn(cfg, seed=3),
                              device=dev)


def _pm1_rows(b, n, seed=0):
    """±1-ish rows: mostly normals, a share of the special values, one row
    all positive (every bit, bit 31 too) and one positive only at bit 31
    of each word."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)).astype(np.float32)
    x = np.where(rng.random((b, n)) < 0.25,
                 rng.choice(SPECIAL, (b, n)), x).astype(np.float32)
    x[0] = 1.0
    if b > 1:
        x[1] = -1.0
        x[1, 31::32] = 1.0
    return torch.from_numpy(x)


def _pixels(width, b, p, seed=0):
    """Pixels on every level and one ulp either side of it, the special
    values and uniform [0, 1) draws, shuffled into [b, p]."""
    lv = (np.float32([0.5]) if width == 0
          else binarize.thermometer_thresholds(width))
    edges = np.concatenate([lv, np.nextafter(lv, np.float32(-np.inf)),
                            np.nextafter(lv, np.float32(np.inf)), SPECIAL])
    rng = np.random.default_rng(seed)
    x = rng.random(b * p).astype(np.float32)
    x[:edges.size * 4] = np.tile(edges, 4)[:b * p]
    return torch.from_numpy(rng.permutation(x).reshape(b, p))


def _counts():
    return (pack_input.sign_words.launches,
            pack_input.threshold_words.launches)


# the inputs of the card's tests below, for the CPU's comparisons with the
# reference: the sign pack's shapes (but the benchmark's, 537 MB a side,
# held on the card only), its views, and the threshold code's shapes
SIGN_INPUTS = [(f"{b}x{n}", (b, n)) for b, n in SIGN_SHAPES[1:]] + [
    (f"{kind}{n}", (kind, n)) for n in (4096, 784, 33)
    for kind in ("strided", "offset")]
PIXEL_SHAPES = [(5, 211), (3, 64 * 64)]


def _sign_input(spec, dev="cpu"):
    """The rows of a SIGN_INPUTS entry on `dev`: a shape, or a strided
    view / a contiguous view off 16-byte alignment of wider rows."""
    if isinstance(spec[0], int):
        return _pm1_rows(*spec, seed=spec[1]).to(dev)
    kind, n = spec
    base = _pm1_rows(12, 2 * n, seed=n).to(dev)
    return (base[:, ::2] if kind == "strided"
            else base.reshape(-1)[1:1 + 11 * n].view(11, n))


def _view_pixels(dev="cpu"):
    """A strided view and a view off 16-byte alignment of the pixels."""
    base = _pixels(4, 6, 2 * 211, seed=5).to(dev)
    return base[:, ::2], base.reshape(-1)[3:3 + 5 * 211].view(5, 211)


def _reference():
    """jax.numpy and the reference's binarize, imported when a CPU test
    runs, never at collection (the card's run has no JAX)."""
    import jax.numpy as jnp
    from repro.core import binarize as jbin

    return jnp, jbin


def _u32(words) -> np.ndarray:
    return np.asarray(words).view(np.uint32)


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("kind,width", ENCODINGS)
def test_levels_are_the_float32_thresholds(kind, width):
    """The levels the kernel makes (csrc/pack_input.cu `level`): 0.5 for
    the sign code, else float32 (t + 1) / (width + 1), one IEEE division
    rounded to nearest a level, are the very floats `InputEncoding.pack`
    compares with."""
    got = (np.float32([0.5]) if kind == "sign" else np.float32(
        [np.float32(t + 1) / np.float32(width + 1) for t in range(width)]))
    want = (np.float32([0.5]) if kind == "sign"
            else binarize.thermometer_thresholds(width))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("sizes", [(784, 32, 10), (33, 16, 5), (31, 8, 3)])
def test_mlp_pack_on_cpu_is_pm1_and_launches_nothing(sizes):
    pipe = _mlp(sizes, "cpu")
    x = _pm1_rows(9, sizes[0])
    before = _counts()
    got = pipe._pack_input(x)
    assert torch.equal(got, binarize.pack_pm1(x))
    assert torch.equal(pack_input.sign_words(x), got)
    assert got.shape == (9, binarize.packed_width(sizes[0]))
    assert _counts() == before


@pytest.mark.parametrize("kind,width", ENCODINGS)
def test_cnn_pack_on_cpu_is_the_encoding_and_launches_nothing(kind, width):
    enc = binarize.InputEncoding(kind, width)
    pipe = _cnn(enc, "cpu")
    x = _pixels(0 if kind == "sign" else width, 3, 256)
    before = _counts()
    got = pipe._pack_input(x)
    want = enc.pack(x)
    assert torch.equal(got, want.reshape(3, -1))
    assert torch.equal(pack_input.threshold_words(x, enc), want)
    assert _counts() == before


def test_bitplane_and_head_only_keep_their_routes():
    enc = binarize.InputEncoding("bitplane", 4)
    cnn = _cnn(enc, "cpu")
    x = _pixels(4, 3, 256)
    assert torch.equal(cnn._pack_input(x), enc.pack(x).reshape(3, -1))
    with pytest.raises(ValueError, match="bit-plane"):
        pack_input.threshold_words(x, enc)
    head_only = _mlp((96, 10), "cpu")
    h = _pm1_rows(5, 96)
    assert head_only.head_only
    assert torch.equal(head_only._pack_input(h), query_with_bias(h, 64))


@pytest.mark.parametrize("name", ["mlp", "cnn", "bitplane", "head_only"])
def test_run_pack_counts_no_kernel_on_cpu(name):
    if name in ("mlp", "head_only"):
        sizes = (64, 16, 4) if name == "mlp" else (64, 4)
        pipe, x = _mlp(sizes, "cpu"), _pm1_rows(4, 64)
    else:
        pipe = _cnn(binarize.InputEncoding(
            "thermometer" if name == "cnn" else "bitplane", 4), "cpu")
        x = _pixels(4, 4, 256)
    obs.take()
    obs.enable()
    try:
        pipe.run(x, InferenceSpec())
    finally:
        obs.disable()
    recs, _ = obs.take()
    packs = [r for r in recs if r.name == "run.pack"]
    assert len(packs) == 1 and packs[0].counts == {"kernel": 0}


@pytest.mark.parametrize("x,err", [
    (torch.zeros(2, 8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 8, dtype=torch.int32), TypeError),
    (torch.zeros(8), ValueError),
    (torch.zeros(2, 2, 8), ValueError),
    (torch.zeros(2, 8, device="meta"), ValueError),
], ids=["float64", "int32", "rank1", "rank3", "device"])
def test_wrapper_checks_its_operands(x, err):
    with pytest.raises(err):
        pack_input.sign_words(x)
    with pytest.raises(err):
        pack_input.threshold_words(x, binarize.InputEncoding("thermometer",
                                                             4))


@pytest.mark.parametrize("spec", [s for _, s in SIGN_INPUTS],
                         ids=[i for i, _ in SIGN_INPUTS])
def test_sign_inputs_pack_as_the_reference_packs(spec):
    """The card's sign inputs: `pack_pm1` (the kernel's twin) gives the
    reference's words, but where XLA reads a positive denormal as zero."""
    jnp, jbin = _reference()
    x = _sign_input(spec)
    xn = x.numpy()
    port = _u32(binarize.pack_pm1(x).numpy())
    assert np.array_equal(_u32(pack_input.sign_words(x).numpy()), port)
    ref = _u32(jbin.pack_pm1(jnp.asarray(xn)))
    denormal = (xn > 0) & (xn < F32.tiny)
    flipped = _u32(binarize.pack_pm1(
        torch.from_numpy(np.where(denormal, 1, -1).astype(np.float32)))
        .numpy())
    np.testing.assert_array_equal(port ^ ref, flipped)


@pytest.mark.parametrize("shape", PIXEL_SHAPES + ["views"],
                         ids=["5x211", "3x4096", "views"])
@pytest.mark.parametrize("kind,width", KERNEL_ENCODINGS)
def test_pixels_pack_as_the_reference_packs(kind, width, shape):
    """The card's pixels (on, and one ulp off, every level; the special
    values): `InputEncoding.pack` gives the reference's words exactly
    (every level is a normal float, so XLA's denormals-as-zero changes no
    comparison)."""
    jnp, jbin = _reference()
    enc = binarize.InputEncoding(kind, width)
    xs = (_view_pixels() if shape == "views" else
          [_pixels(0 if kind == "sign" else width, *shape, seed=width)])
    for x in xs:
        port = _u32(enc.pack(x).numpy())
        assert np.array_equal(
            _u32(pack_input.threshold_words(x, enc).numpy()), port)
        ref = jbin.pack_bits(jbin.InputEncoding(kind, width).encode_bits(
            jnp.asarray(x.numpy())))
        np.testing.assert_array_equal(port, _u32(ref))


# --------------------------------------------------------------- the card


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)


def _sign_kernel(x):
    before = pack_input.sign_words.launches
    got = pack_input.sign_words(x)
    torch.cuda.synchronize()
    assert pack_input.sign_words.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SIGN_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sign_kernel_equals_pack_pm1(dev, shape):
    x = _pm1_rows(*shape, seed=shape[1])
    xd = x.to(dev)
    got = _sign_kernel(xd)
    assert torch.equal(got, binarize.pack_pm1(xd))
    if x.numel() < 1 << 20:
        assert torch.equal(got.cpu(), binarize.pack_pm1(x))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 784, 33])
def test_sign_kernel_on_views(dev, n):
    """A strided view (copied to contiguous first) and a contiguous view
    off 16-byte alignment pack as their values do."""
    for kind in ("strided", "offset"):
        xd = _sign_input((kind, n), dev)
        assert xd.is_contiguous() == (kind == "offset")
        assert kind == "strided" or xd.data_ptr() % 16
        got = _sign_kernel(xd)
        assert torch.equal(got, binarize.pack_pm1(xd))
        assert torch.equal(got.cpu(),
                           binarize.pack_pm1(_sign_input((kind, n))))


def _threshold_kernel(x, enc):
    before = pack_input.threshold_words.launches
    got = pack_input.threshold_words(x, enc)
    torch.cuda.synchronize()
    assert pack_input.threshold_words.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind,width", KERNEL_ENCODINGS)
@pytest.mark.parametrize("shape", PIXEL_SHAPES, ids=["5x211", "3x4096"])
def test_threshold_kernel_equals_encoding_pack(dev, kind, width, shape):
    enc = binarize.InputEncoding(kind, width)
    x = _pixels(0 if kind == "sign" else width, *shape, seed=width)
    xd = x.to(dev)
    got = _threshold_kernel(xd, enc)
    assert torch.equal(got, enc.pack(xd))
    assert torch.equal(got.cpu(), enc.pack(x))


@pytest.mark.cuda
def test_threshold_kernel_at_the_benchmark_shape(dev):
    enc = binarize.InputEncoding("thermometer", 4)
    x = _pixels(4, 32768, 4096, seed=26).to(dev)
    assert torch.equal(_threshold_kernel(x, enc), enc.pack(x))


@pytest.mark.cuda
def test_threshold_kernel_on_views(dev):
    enc = binarize.InputEncoding("thermometer", 4)
    for xd, x in zip(_view_pixels(dev), _view_pixels()):
        got = _threshold_kernel(xd, enc)
        assert torch.equal(got, enc.pack(xd))
        assert torch.equal(got.cpu(), enc.pack(x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hg_mlp", "hg_cnn"])
def test_run_launches_the_kernel_once_a_call_and_equals_cpu(dev, name):
    """Small HG-shaped pipelines: the MLP's 4,096 ±1 inputs and the CNN's
    64 x 64 thermometer-4 pixels."""
    if name == "hg_mlp":
        make = lambda d: _mlp((4096, 32, 20), d)  # noqa: E731
        x = _pm1_rows(33, 4096, seed=7)
        fn = pack_input.sign_words
    else:
        make = lambda d: _cnn(binarize.InputEncoding("thermometer", 4),
                              d, side=64, n_cls=20)  # noqa: E731
        x = _pixels(4, 33, 64 * 64, seed=7)
        fn = pack_input.threshold_words
    card, cpu = make(dev), make("cpu")
    want = cpu.run(x, InferenceSpec())
    before = fn.launches
    obs.take()
    obs.enable()
    try:
        for i in range(3):
            got = card.run(x.to(dev), InferenceSpec())
            assert fn.launches == before + i + 1
            assert torch.equal(got.cpu(), want)
    finally:
        obs.disable()
    recs, _ = obs.take()
    assert [r.counts for r in recs if r.name == "run.pack"] == \
        [{"kernel": 1}] * 3
