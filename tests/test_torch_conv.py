"""The port's binary CNN (`repro_torch.core.convnet`, the input encodings,
`kernels.fused_conv`, the conv branch of `compile_pipeline`, serving)
against the JAX reference, on the four configs of tests/test_conv.py.

Inputs are made with numpy from a seed and handed to both packages.
Every result is integer (packed words, votes, staircases) and compared
bit for bit.  The reference's Pallas kernel runs in interpret mode only
on the two small configs; the 64x64 config goes through its XLA route
with a few images.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import i32
from repro.configs import paper_cnn as jpaper
from repro.core import binarize as jbin
from repro.core import convnet as jconv
from repro.kernels import fused_conv as jfc
from repro.kernels import ref as jref
from repro.spec import InferenceSpec as JSpec
from repro_torch import convert
from repro_torch import pipeline as tpipe
from repro_torch.configs import paper_cnn as tpaper
from repro_torch.core import binarize as tbin
from repro_torch.core import convnet as tconv
from repro_torch.core import ensemble as tens
from repro_torch.kernels import fused_conv, ref
from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
from repro_torch.spec import InferenceSpec

# tests/test_conv.py's CONFIGS: (side, encoding, conv specs, hidden, classes)
CONFIGS = {
    "mnist-28": (28, ("thermometer", 8), ((3, 32, 2), (3, 32, 2)), (128,), 10),
    "hg-64": (64, ("thermometer", 4), ((3, 32, 2), (3, 32, 2)), (128,), 20),
    "unaligned-12": (12, ("thermometer", 3), ((3, 24, 2), (3, 20, 1)), (48,),
                     7),
    "head-direct-10": (10, ("thermometer", 2), ((3, 32, 2),), (), 5),
}
SMALL = ("unaligned-12", "head-direct-10")
SPECS = {
    "votes": (JSpec(), InferenceSpec()),
    "argmax": (JSpec(reduction="argmax"), InferenceSpec(reduction="argmax")),
    "cumulative": (JSpec(cumulative=True), InferenceSpec(cumulative=True)),
}


def _configs(name):
    """The config as the reference's CNNConfig and as the port's."""
    side, enc, convs, hidden, n_cls = CONFIGS[name]
    j = jconv.CNNConfig(side=side, encoding=jbin.InputEncoding(*enc),
                        conv=tuple(jconv.ConvSpec(*c) for c in convs),
                        hidden=hidden, n_classes=n_cls)
    t = tconv.CNNConfig(side=side, encoding=tbin.InputEncoding(*enc),
                        conv=tuple(tconv.ConvSpec(*c) for c in convs),
                        hidden=hidden, n_classes=n_cls)
    return j, t


def _images(side, n, seed=1):
    return np.random.default_rng(seed).random((n, side * side)).astype(
        np.float32)


def _pipes(name, seed=None, **kw):
    jc, tc = _configs(name)
    jf = jconv.random_folded_cnn(jc, seed=sum(map(ord, name))
                                 if seed is None else seed)
    jp = jpaper.build_cnn_pipeline(jc, jf, impl="xla", min_bucket=8)
    tp = tpaper.build_cnn_pipeline(tc, convert.folded_from_jax(jf),
                                   device="cpu", min_bucket=8, **kw)
    return jc, tc, jf, jp, tp


# ---------------------------------------------------------------- encodings


def _boundary_pixels(width, seed):
    """Pixels exactly on every thermometer level, just below each, random
    ones, and the ends of [0, 1]."""
    thr = tbin.thermometer_thresholds(width)
    rnd = np.random.default_rng(seed).random(40).astype(np.float32)
    return np.concatenate([thr, np.nextafter(thr, np.float32(0)), rnd,
                           np.float32([0.0, 0.5, 1.0])]).astype(np.float32)


@pytest.mark.parametrize("kind,width",
                         [("thermometer", w) for w in range(1, 9)]
                         + [("bitplane", w) for w in range(1, 9)]
                         + [("sign", 1), ("thermometer", 32),
                            ("thermometer", 33), ("bitplane", 16)])
def test_encodings_and_lean_packing_match_reference(kind, width):
    x = _boundary_pixels(width, width).reshape(1, -1)
    je, te = jbin.InputEncoding(kind, width), tbin.InputEncoding(kind, width)
    bits = np.asarray(je.encode_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(te.encode_bits(x).numpy(), bits)
    np.testing.assert_array_equal(te.encode_pm1(x).numpy(),
                                  np.asarray(je.encode_pm1(jnp.asarray(x))))
    want = i32(jbin.pack_bits(jnp.asarray(bits)))
    got = te.pack(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbin.pack_bits(te.encode_bits(x)).numpy(),
                                  want)
    if kind == "thermometer" and width >= 32:  # bit 31 is an ordinary bit
        assert (got.numpy()[..., 0] < 0).any()


@pytest.mark.parametrize("width", [1, 3, 8])
def test_decodes_match_reference(width):
    x = _boundary_pixels(width, 7)
    for jenc, jdec, tenc, tdec in (
            (jbin.thermometer_bits, jbin.thermometer_decode,
             tbin.thermometer_bits, tbin.thermometer_decode),
            (jbin.bitplane_bits, jbin.bitplane_decode,
             tbin.bitplane_bits, tbin.bitplane_decode)):
        bits = np.array(jenc(jnp.asarray(x), width))
        np.testing.assert_array_equal(tenc(x, width).numpy(), bits)
        np.testing.assert_array_equal(tdec(bits).numpy(),
                                      np.asarray(jdec(jnp.asarray(bits))))


def test_encoding_checks_and_random_pm1():
    for kind, width in (("gray", 2), ("sign", 2), ("thermometer", 0)):
        with pytest.raises(ValueError):
            tbin.InputEncoding(kind, width)
    with pytest.raises(ValueError):
        tbin.thermometer_bits(np.zeros(3, np.float32), 0)
    gen = torch.Generator().manual_seed(0)
    v = tbin.random_pm1(gen, (200, 100))
    assert v.dtype == torch.float32 and set(v.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(v.mean())) < 0.03  # a fair coin: 20,000 draws
    again = tbin.random_pm1(torch.Generator().manual_seed(0), (200, 100))
    assert torch.equal(v, again)


# ------------------------------------------------------ folding and packing


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_folded_cnn_and_packing_match_reference(name):
    jc, tc = _configs(name)
    jf = jconv.random_folded_cnn(jc, seed=4)
    tf = tconv.random_folded_cnn(tc, seed=4)
    assert tc.fc_sizes == jc.fc_sizes and tc.n_in == jc.n_in
    assert tc.feature_sides() == jc.feature_sides()
    assert tc.feature_channels() == jc.feature_channels()
    assert len(tf) == len(jf)
    for jl, tl in zip(jf, tf):
        assert type(tl).__name__ == type(jl).__name__
        np.testing.assert_array_equal(tl.weights_pm1, jl.weights_pm1)
        np.testing.assert_array_equal(tl.c, jl.c)
        assert getattr(tl, "stride", 1) == getattr(jl, "stride", 1)
    n_conv = len(jc.conv)
    tmetas = fused_conv.conv_metas_for(tf[:n_conv], jc.side)
    jmetas = jfc.conv_metas_for(jf[:n_conv], jc.side)
    assert [dataclasses.astuple(m) for m in tmetas] == \
        [dataclasses.astuple(m) for m in jmetas]
    for jl, tl in zip(jf[:n_conv], tf[:n_conv]):
        np.testing.assert_array_equal(fused_conv.pack_conv_rows(tl).numpy(),
                                      i32(jfc.pack_conv_rows(jl)))
    mf = tmetas[-1]
    n_pos = mf.out_side ** 2
    w_bits = (jf[n_conv].weights_pm1 > 0).astype(np.uint8)
    np.testing.assert_array_equal(
        fused_conv.pack_fc_rows_positionwise(w_bits, n_pos, mf.c_out).numpy(),
        i32(jfc.pack_fc_rows_positionwise(w_bits, n_pos, mf.c_out)))
    for bias in (1, 32, 33, 64):
        np.testing.assert_array_equal(fused_conv.bias_drive_words(bias),
                                      jfc.bias_drive_words(bias))
    # carried across: conv layers keep their stride
    for jl, cl in zip(jf, convert.folded_from_jax(jf)):
        assert type(cl).__name__ == type(jl).__name__
        assert getattr(cl, "stride", 1) == getattr(jl, "stride", 1)
    assert convert.encoding_from_jax(jc.encoding) == tc.encoding



def test_fold_cnn_matches_reference_on_numpy_params():
    """Latent weights with exact zeros (sign(0) -> +1), negative and zero
    gammas (row flips), made with numpy and folded by both packages."""
    jc, tc = _configs("unaligned-12")
    rng = np.random.default_rng(3)
    params = {"conv": [], "fc": []}
    c_in = jc.encoding.width
    for spec in jc.conv:
        w = rng.normal(size=(spec.k, spec.k, c_in, spec.c_out))
        w[rng.random(w.shape) < 0.1] = 0.0
        params["conv"].append(_bn(rng, w, spec.c_out))
        c_in = spec.c_out
    for n_in, n_out in zip(jc.fc_sizes[:-1], jc.fc_sizes[1:]):
        w = rng.normal(size=(n_in, n_out))
        w[rng.random(w.shape) < 0.1] = 0.0
        params["fc"].append(_bn(rng, w, n_out))
    want = jconv.fold_cnn(params, jc)
    got = tconv.fold_cnn(convert.params_from_jax(params), tc)
    assert len(got) == len(want)
    for jl, tl in zip(want, got):
        assert type(tl).__name__ == type(jl).__name__
        np.testing.assert_array_equal(tl.weights_pm1, jl.weights_pm1)
        np.testing.assert_array_equal(tl.c, jl.c)


def _bn(rng, w, n):
    gamma = rng.normal(size=n)
    gamma[0] = 0.0
    return {"w": w.astype(np.float32), "gamma": gamma.astype(np.float32),
            "beta": rng.normal(size=n).astype(np.float32),
            "mean": rng.normal(size=n).astype(np.float32) * 3,
            "var": rng.random(n).astype(np.float32) * 4 + 0.1}


def test_conv2d_oracle_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.choice([-1.0, 1.0], (3, 9, 9, 5)).astype(np.float32)
    w = rng.choice([-1, 1], (7, 3, 3, 5)).astype(np.int8)
    for stride in (1, 2):
        np.testing.assert_array_equal(
            ref.binary_conv2d_ref(x, w, stride).numpy(),
            np.asarray(jref.binary_conv2d_ref(x, w, stride)))


# -------------------------------------------------------------- the kernel


def _kernel_operands(tp, x):
    conv = tp.conv
    xp = conv.maps(conv.pack(torch.from_numpy(x)))
    return xp, (xp, conv.ws, conv.cs, conv.metas, tp.layer_ws, tp.layer_cs,
                tp.layer_n_bits, tp.head.cam.rows_packed)


def _jax_operands(jc, jf, x):
    """The reference's fused_conv_votes operands, packed by the reference."""
    n_conv = len(jc.conv)
    metas = jfc.conv_metas_for(jf[:n_conv], jc.side)
    xp = jbin.pack_bits(jc.encoding.encode_bits(
        jnp.asarray(x).reshape(-1, jc.side, jc.side)))
    hidden = jf[n_conv:-1]
    mf = metas[-1]
    ws = tuple(
        jfc.pack_fc_rows_positionwise(
            (l.weights_pm1 > 0).astype(np.uint8), mf.out_side ** 2, mf.c_out)
        if i == 0 else jbin.pack_bits(jnp.asarray(
            (l.weights_pm1 > 0).astype(np.uint8)))
        for i, l in enumerate(hidden))
    return (xp, tuple(jfc.pack_conv_rows(l) for l in jf[:n_conv]),
            tuple(jnp.asarray(l.c, jnp.int32) for l in jf[:n_conv]), metas,
            ws, tuple(jnp.asarray(l.c, jnp.int32) for l in hidden),
            tuple(int(l.n_in) for l in hidden))


def _forms(rng, b, c, n_bits):
    base = n_bits // 2 - 32 + np.arange(0, 65, 2)
    yield "int", base.astype(np.int32), None
    yield "float", (base + rng.uniform(-1, 1, base.shape)).astype(
        np.float32), None
    yield "sampled", base.astype(np.int32), (base[None, None, :] + rng.normal(
        0, 3, (b, c, base.size))).astype(np.float32)


@pytest.mark.parametrize("name", SMALL)
def test_fused_conv_votes_matches_pallas_reference(name):
    jc, tc, jf, jp, tp = _pipes(name)
    x = _images(jc.side, 9, seed=2)
    xp, args = _kernel_operands(tp, x)
    jargs = _jax_operands(jc, jf, x)
    np.testing.assert_array_equal(xp.numpy(), i32(jargs[0]))
    head = jp.head
    rng = np.random.default_rng(5)
    n_bits = head.cam.n_bits
    for form, thr, samples in _forms(rng, 9, head.n_classes, n_bits):
        want = np.asarray(jfc.fused_conv_votes(
            *jargs, head.cam.rows_packed, jnp.asarray(thr),
            bias_cells=head.bias_cells, bq=4, interpret=True,
            head_direct=not jc.hidden,
            thr_samples=None if samples is None else jnp.asarray(samples)))
        got = fused_conv.fused_conv_votes(
            *args, torch.from_numpy(thr), bias_cells=head.bias_cells,
            head_direct=not tc.hidden,
            thr_samples=None if samples is None else torch.from_numpy(samples))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=form)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_conv_stage_matches_reference(name):
    jc, tc, jf, jp, tp = _pipes(name)
    x = _images(jc.side, 3 if jc.side >= 64 else 7, seed=3)
    xp, _ = _kernel_operands(tp, x)
    jxp, jws, jcs, metas, *_ = _jax_operands(jc, jf, x)
    bias = tp.head.bias_cells if not tc.hidden else 0
    want = i32(jfc.conv_stage_packed(
        jxp, jws, jcs, metas,
        jfc.bias_drive_words(bias) if bias else None))
    conv = tp.conv
    for got in (fused_conv.conv_stage_packed(xp, conv.ws, conv.cs,
                                             conv.metas, bias_cells=bias),
                fused_conv.conv_stage_packed_plain(
                    xp, conv.ws, conv.cs, conv.metas,
                    fused_conv.bias_drive_words(bias) if bias else None)):
        np.testing.assert_array_equal(got.numpy(), want)
    # kw_q: zero words after the flatten, up to an operand's width
    got = fused_conv.conv_stage_packed(xp, conv.ws, conv.cs, conv.metas,
                                       bias_cells=bias,
                                       kw_q=want.shape[1] + 3)
    np.testing.assert_array_equal(got[:, :want.shape[1]].numpy(), want)
    assert not got[:, want.shape[1]:].any()


def test_sign_at_zero_maps_to_plus_one():
    """C = 0 with an even dot width (k = 3, c_in = 2: 18 bits) makes
    y = 0 common; the reference maps it to +1, and so must the port."""
    jc, tc, jf, jp, tp = _pipes("head-direct-10", seed=6)
    x = _images(jc.side, 11, seed=4)
    xp, args = _kernel_operands(tp, x)
    jargs = list(_jax_operands(jc, jf, x))
    assert args[3][0].n_bits == 18
    zero = (torch.zeros(32, dtype=torch.int32),)
    args = args[:2] + (zero,) + args[3:]
    jargs[2] = (jnp.zeros(32, jnp.int32),)
    y = tp.conv.metas[0].n_bits - 2 * fused_conv.conv_hd_packed_plain(
        xp, tp.conv.ws[0], tp.conv.metas[0])
    assert (y == 0).any()
    head = jp.head
    want = np.asarray(jfc.fused_conv_votes(
        *jargs, head.cam.rows_packed, head.thresholds,
        bias_cells=head.bias_cells, bq=4, interpret=True, head_direct=True))
    got = fused_conv.fused_conv_votes(
        *args, tp.head.thresholds, bias_cells=tp.head.bias_cells,
        head_direct=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_conv_guards():
    jc, tc, jf, jp, tp = _pipes("head-direct-10")
    xp, args = _kernel_operands(tp, _images(jc.side, 2))
    thr, bias = tp.head.thresholds, tp.head.bias_cells
    rows = tp.head.cam.rows_packed
    with pytest.raises(ValueError, match="x_packed"):
        fused_conv.fused_conv_votes(xp[:, 1:], *args[1:], thr,
                                    bias_cells=bias, head_direct=True)
    with pytest.raises(ValueError, match="no FC layers"):
        fused_conv.fused_conv_votes(*args, thr, bias_cells=bias)
    with pytest.raises(ValueError, match="no conv layers"):
        fused_conv.fused_conv_votes(xp, [], [], [], [], [], [], rows, thr,
                                    bias_cells=bias, head_direct=True)
    with pytest.raises(ValueError, match="length mismatch"):
        fused_conv.fused_conv_votes(xp, args[1], [], args[3], [], [], [],
                                    rows, thr, bias_cells=bias,
                                    head_direct=True)
    with pytest.raises(ValueError, match="thr_samples"):
        fused_conv.fused_conv_votes(
            *args, thr, bias_cells=bias, head_direct=True,
            thr_samples=torch.zeros((2, rows.shape[0], 5)))
    _, tc2, _, _, tp2 = _pipes("unaligned-12")
    xp2, args2 = _kernel_operands(tp2, _images(tc2.side, 2))
    with pytest.raises(ValueError, match="head_direct=True with FC"):
        fused_conv.fused_conv_votes(*args2, tp2.head.thresholds,
                                    bias_cells=bias, head_direct=True)
    with pytest.raises(ValueError, match="word-aligned"):
        fused_conv.conv_stage_packed(xp2, *args2[1:4], bias_cells=bias)
    with pytest.raises(ValueError, match="more than the first operand"):
        fused_conv.conv_stage_packed(xp2, *args2[1:4], kw_q=1)


# ------------------------------------------------------------ the pipeline


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cnn_pipeline_matches_reference_at_ragged_batches(name):
    jc, tc, jf, jp, tp = _pipes(name)
    big = jc.side >= 64
    x = _images(jc.side, 5 if big else 21, seed=5)
    for b in (2, 5) if big else (1, 7, 9, 21):
        for sname, (jspec, tspec) in SPECS.items():
            want = np.asarray(jp.run(jnp.asarray(x[:b]), jspec))
            got = tp.run(x[:b], tspec)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{sname} B={b}")
    oracle = ref.conv_votes_ref(convert.folded_from_jax(jf), tp.head,
                                torch.from_numpy(x), tc.encoding, tc.side)
    np.testing.assert_array_equal(tp.run(x, InferenceSpec()).numpy(),
                                  oracle.numpy())
    np.testing.assert_array_equal(
        oracle.numpy(),
        np.asarray(jref.conv_votes_ref(jf, jp.head, x, jc.encoding,
                                       jc.side)))


def test_cnn_pipeline_is_padding_invariant_and_moves():
    _, tc, _, _, tp = _pipes("unaligned-12", seed=9)
    x = _images(tc.side, 21, seed=4)
    full = tp.run(x, InferenceSpec())
    for b in (1, 7, 8, 9, 21):
        assert torch.equal(tp.run(x[:b], InferenceSpec()), full[:b])
    assert tp.n_in == tc.side ** 2
    assert tp.to("cpu") is tp
    times = tp.warmup(16)
    assert set(b for _, b in times) == {8, 16}


def test_compile_pipeline_conv_validation():
    """The reference's conv guards (tests/test_conv.py
    test_compile_pipeline_conv_validation), as the port raises them."""
    jc, tc = _configs("head-direct-10")
    folded = tconv.random_folded_cnn(tc, seed=1)
    cfg = tens.EnsembleConfig()
    with pytest.raises(ValueError, match="image_side"):
        tpipe.compile_pipeline(folded, cfg, device="cpu")
    with pytest.raises(ValueError, match="conv-only"):
        tpipe.compile_pipeline(folded[-1:], cfg, device="cpu",
                               image_side=10)
    with pytest.raises(ValueError, match="prefix"):
        tpipe.compile_pipeline([folded[-1], folded[0]], cfg, device="cpu",
                               image_side=10)
    with pytest.raises(ValueError, match="encoding width"):
        tpipe.compile_pipeline(
            folded, cfg, device="cpu", image_side=10,
            image_encoding=tbin.InputEncoding("thermometer", 5))
    bad = tconv.CNNConfig(side=10, encoding=tbin.InputEncoding("thermometer",
                                                               2),
                          conv=(tconv.ConvSpec(3, 24, 2),), hidden=(),
                          n_classes=5)
    with pytest.raises(ValueError, match="word-aligned"):
        tpaper.build_cnn_pipeline(bad, tconv.random_folded_cnn(bad, seed=2),
                                  device="cpu")
    with pytest.raises(ValueError, match="flattened conv features"):
        tpipe.compile_pipeline(folded, cfg, device="cpu", image_side=12)
    # deploy_cnn is ported: it builds a Deployment with the config's
    # geometry, and refuses an option the reference does not know
    dep = tpaper.deploy_cnn(tc, folded, device="cpu")
    assert (dep.image_side, dep.image_encoding) == (tc.side, tc.encoding)
    with pytest.raises(ValueError, match="unknown compile options"):
        tpaper.deploy_cnn(tc, folded, block_size=4)


def test_paper_cnn_configs_match_reference():
    for jcfg, tcfg in ((jpaper.MNIST_CNN, tpaper.MNIST_CNN),
                       (jpaper.HG_CNN, tpaper.HG_CNN)):
        assert tcfg.fc_sizes == jcfg.fc_sizes
        assert tcfg.feature_sides() == jcfg.feature_sides()
        assert (tcfg.encoding.kind, tcfg.encoding.width) == (
            jcfg.encoding.kind, jcfg.encoding.width)
        assert tcfg.bias_cells == jcfg.bias_cells
    assert tpaper.MNIST_CNN.flat_features == 1152
    assert tpaper.HG_CNN.flat_features == 7200
    assert tuple(tpaper.CNN_ENSEMBLE.thresholds) == tuple(
        jpaper.CNN_ENSEMBLE.thresholds)


def test_served_cnn_votes_equal_direct_run():
    _, tc, _, _, tp = _pipes("unaligned-12", seed=11, max_bucket=32)
    x = _images(tc.side, 24, seed=8)
    direct = tp.run(x, InferenceSpec()).numpy()
    srv = PicBnnServer(BatchingPolicy(max_batch=32, max_wait_us=200),
                       devices=["cpu"])
    srv.register("cnn", tp)
    with srv:
        singles = [srv.submit("cnn", x[i]) for i in range(5)]
        burst = srv.submit_many("cnn", x[5:])
        np.testing.assert_array_equal(
            np.stack([h.result(timeout=60).votes for h in singles]),
            direct[:5])
        np.testing.assert_array_equal(burst.votes_all(timeout=60),
                                      direct[5:])
    with pytest.raises(ValueError, match="expected image"):
        srv2 = PicBnnServer(devices=["cpu"])
        srv2.register("cnn", tp)
        srv2.submit("cnn", x[0, :-1])



# ------------------------------------- the kernel's dense tap layout (host)

# (side, c_in, k, stride, c_out): thermometer widths 1-4 and 8 (compact
# input maps), a 5-channel (pitch 8) and 16-channel map, 24 and 32
# channels (whole words), 40 channels (two words), 1x1 and 5x5 kernels
DENSE_LAYERS = [(9, 1, 3, 2, 8), (10, 2, 3, 2, 32), (12, 3, 3, 2, 24),
                (13, 4, 3, 2, 32), (11, 8, 3, 2, 32), (9, 5, 3, 1, 7),
                (8, 16, 3, 1, 32), (7, 24, 3, 1, 20), (7, 32, 3, 2, 32),
                (6, 40, 3, 1, 9), (6, 4, 1, 1, 5), (11, 3, 5, 2, 33)]


def _kernel_word(meta, pitch, d):
    """Dense word d's run (src, n) by the arithmetic of csrc/fused_conv.cu
    `dense_word`."""
    if pitch >= 32:
        tap = d // meta.cw_in
        return ((((tap // meta.k) * meta.side + tap % meta.k) * meta.cw_in
                 + d % meta.cw_in) * 32, 32)
    per = 32 // pitch
    wr = -(-meta.k // per)
    dx0 = d % wr * per
    return ((d // wr * meta.side + dx0) * pitch, min(per, meta.k - dx0) * pitch)


def _dense_hd(maps, w, meta, plan):
    """Hamming distances through the dense rows the kernel builds."""
    rows = fused_conv.dense_rows_plain(maps, meta, plan)
    filt = fused_conv.dense_filter_rows_plain(w, meta, plan)
    assert tuple(filt.shape) == (meta.c_out, plan.words)
    hd = tbin.popcount32(rows[:, :, None, :] ^ filt[None, None]).sum(-1)
    return hd.reshape(maps.shape[0], meta.out_side, meta.out_side, -1)


@pytest.mark.parametrize("side,c_in,k,stride,c_out", DENSE_LAYERS)
@pytest.mark.parametrize("compact", [True, False])
def test_dense_taps_match_reference_conv_hd(side, c_in, k, stride, c_out,
                                            compact):
    """The dense K rows and filter rows of csrc/fused_conv.cu, built from
    the host plan, give the reference's `conv_hd_packed` distances; the
    plan's runs are the ones the kernel's word table computes."""
    rng = np.random.default_rng(side * 100 + c_in)
    cw = tbin.packed_width(c_in)
    out_side = (side - k) // stride + 1
    meta = fused_conv.ConvMeta(side, cw, k, stride, out_side, c_out,
                               tbin.packed_width(c_out), k * k * c_in)
    jmeta = jfc.ConvMeta(*dataclasses.astuple(meta))
    x_bits = rng.integers(0, 2, (3 * side * side, c_in)).astype(np.uint8)
    x = tbin.np_pack_bits(x_bits).reshape(3, side, side, cw)
    w = tbin.np_pack_bits(rng.integers(0, 2, (c_out * k * k, c_in)).astype(
        np.uint8)).reshape(c_out, k * k * cw)
    want = np.asarray(jfc.conv_hd_packed(jnp.asarray(x), jnp.asarray(w),
                                         jmeta))
    compact = compact and fused_conv.dense_pitch(c_in) < 32
    plan = fused_conv.dense_plan(meta, compact)
    assert plan.words == (k * k * cw if plan.pitch >= 32
                          else k * -(-k * plan.pitch // 32))
    assert plan.pitch >= c_in and (plan.pitch <= 16 or plan.pitch == 32 * cw)
    assert plan.store == plan.pitch  # a compact map, or whole words
    xt = tbin.words_to_torch(x)
    maps = (fused_conv.compact_map_plain(xt, plan.pitch) if compact
            else xt.reshape(3, -1))
    assert maps.shape[1] == -(-side * side * plan.store // 32)
    wt = tbin.words_to_torch(w)
    np.testing.assert_array_equal(_dense_hd(maps, wt, meta, plan).numpy(),
                                  want)
    assert plan.runs == tuple(_kernel_word(meta, plan.pitch, d)
                              for d in range(plan.words))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_plans_of_the_configs(name):
    """The configs' conv stacks: the input compacted (thermometer width
    <= 16), later layers on whole channel words; conv 1 of the paper's
    CNNs in one 256-bit K step (a word a kernel row: HG's 36 bits and
    MNIST's 72 in 3 words), conv 2 in two; 16 queries fit in shared
    memory, two blocks an SM at the paper's widths."""
    _, tc, _, _, tp = _pipes(name)
    metas = tp.conv.metas
    plans = fused_conv.dense_plans(metas)
    assert plans[0].store == plans[0].pitch < 32
    assert all(p.store == 32 * m.cw_in for p, m in zip(plans[1:], metas[1:]))
    if name in ("hg-64", "mnist-28"):
        assert [p.words for p in plans] == [3, 9]
        assert [p.ksteps for p in plans] == [1, 2]
    kw_q = (tp.layer_ws[0] if tp.layer_ws else tp.head.cam.rows_packed
            ).shape[1]
    tail = [w.shape[1] for w in tp.layer_ws[1:]] + (
        [tp.head.cam.rows_packed.shape[1]] if tp.layer_ws else [])
    buf0, buf1, nbytes, meta = fused_conv._layout(tuple(metas), kw_q,
                                                  tuple(tail))
    assert buf0 % 8 == 4 and buf1 % 8 == 4
    assert len(meta) == 8 * len(metas)
    assert nbytes <= fused_conv.SMEM_LIMIT // 2
