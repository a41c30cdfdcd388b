"""The port's folded layers, CAM arrays and Algorithm-1 head
(`repro_torch.core.{bnn,cam,ensemble}`, `repro_torch.convert`) against the
JAX reference on the three bank-configuration nets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import BANK_BIAS, BANK_NETS, i32, pm1, random_folded
from repro.core import bnn as jbnn
from repro.core import cam as jcam
from repro.core import ensemble as jens
from repro_torch import convert
from repro_torch.core import bnn as tbnn
from repro_torch.core import cam as tcam
from repro_torch.core import ensemble as tens


def _heads(bank):
    sizes, bias = BANK_NETS[bank], BANK_BIAS[bank]
    jf, tf = random_folded(sizes, sum(map(ord, bank)), bias)
    jh = jens.build_head(jf[-1], jens.EnsembleConfig(bias_cells=bias))
    th = tens.build_head(tf[-1], tens.EnsembleConfig(bias_cells=bias))
    return sizes, jf, tf, jh, th


@pytest.mark.parametrize("bank", sorted(BANK_NETS))
def test_head_and_votes_match_reference(bank):
    sizes, jf, tf, jh, th = _heads(bank)
    np.testing.assert_array_equal(i32(th.cam.rows_packed),
                                  i32(jh.cam.rows_packed))
    assert th.cam.n_bits == jh.cam.n_bits and th.n_classes == jh.n_classes
    assert th.thresholds.dtype == torch.int32
    np.testing.assert_array_equal(th.thresholds.numpy(),
                                  np.asarray(jh.thresholds))
    rng = np.random.default_rng(3)
    h = pm1(rng, (21, sizes[1]))
    jv = np.asarray(jens.votes_fused(jh, jnp.asarray(h)))
    tv = tens.votes_fused(th, torch.from_numpy(h))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tens.votes_kernel(th, torch.from_numpy(h))
                                  .numpy(), jv)
    for mode in ("fused", "kernel"):
        np.testing.assert_array_equal(
            tens.predict(th, torch.from_numpy(h),
                         tens.EnsembleConfig(mode=mode)).numpy(),
            np.asarray(jens.predict(jh, jnp.asarray(h),
                                    jens.EnsembleConfig(mode="fused"))))
    np.testing.assert_array_equal(
        tens.topk_from_votes(tv, 3).numpy(),
        np.asarray(jens.topk_from_votes(jnp.asarray(jv), 3)))
    p = len(tens.PAPER_THRESHOLDS)
    js = np.asarray(jens.sweep_from_votes(jnp.asarray(jv), p))
    ts = tens.sweep_from_votes(tv, p)
    np.testing.assert_array_equal(ts.numpy(), js)
    labels = rng.integers(0, sizes[-1], 21)
    assert tens.accuracy_from_cumulative(ts, labels) == \
        jens.accuracy_from_cumulative(jnp.asarray(js), labels)


@pytest.mark.parametrize("bank", sorted(BANK_NETS))
def test_folded_forward_and_search_hd(bank):
    sizes, jf, tf, jh, th = _heads(bank)
    rng = np.random.default_rng(5)
    x = pm1(rng, (13, sizes[0]))
    np.testing.assert_array_equal(
        tbnn.folded_forward_exact(tf, torch.from_numpy(x)).numpy(),
        np.asarray(jbnn.folded_forward_exact(jf, jnp.asarray(x))))
    h = pm1(rng, (13, sizes[1]))
    jq = jcam.query_with_bias(jnp.asarray(h), jh.bias_cells)
    tq = tcam.query_with_bias(torch.from_numpy(h), th.bias_cells)
    np.testing.assert_array_equal(i32(tq), i32(jq))
    np.testing.assert_array_equal(th.cam.search_hd(tq).numpy(),
                                  np.asarray(jh.cam.search_hd(jq)))


@pytest.mark.parametrize("bias_cells", [32, 64])
def test_parity_rounding_and_bias_cells(bias_cells):
    """Odd-parity C rounds DOWN (cam.py:203-220), including negatives."""
    rng = np.random.default_rng(bias_cells)
    w = rng.choice([-1, 1], (2 * bias_cells + 1, 40)).astype(np.int8)
    c = np.arange(-bias_cells, bias_cells + 1)
    got = tcam.write_weights_with_bias(w, c, bias_cells)
    want = jcam.write_weights_with_bias(w, c, bias_cells)
    np.testing.assert_array_equal(i32(got.rows_packed), i32(want.rows_packed))
    for n_in in (39, 40):
        np.testing.assert_array_equal(
            tbnn.parity_adjust_c(c, n_in, bias_cells),
            jbnn.parity_adjust_c(c, n_in, bias_cells))
    bits = rng.integers(0, 2, (4, 70)).astype(np.uint8)
    np.testing.assert_array_equal(
        i32(tcam.CAMArray.from_bits(torch.from_numpy(bits)).rows_packed),
        i32(jcam.CAMArray.from_bits(jnp.asarray(bits)).rows_packed))


def test_bank_configs():
    assert [(c.rows, c.width) for c in tcam.LOGICAL_CONFIGS] == \
        [(c.rows, c.width) for c in jcam.LOGICAL_CONFIGS]
    for width in (1, 64, 65, 128, 200, 256, 300):
        a, b = tcam.pick_bank_config(width), jcam.pick_bank_config(width)
        assert (a.rows, a.width, a.capacity_bits) == \
            (b.rows, b.width, b.capacity_bits)


def test_fold_from_trained_params_matches_reference():
    cfg = jbnn.MLPConfig(layer_sizes=(40, 24, 6), bias_cells=16)
    params = jbnn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:  # non-trivial BN, some gamma < 0
        n = layer["gamma"].shape[0]
        layer["gamma"] = jnp.asarray(rng.normal(size=n), jnp.float32)
        layer["beta"] = jnp.asarray(rng.normal(size=n) * 3, jnp.float32)
        layer["mean"] = jnp.asarray(rng.normal(size=n) * 5, jnp.float32)
        layer["var"] = jnp.asarray(rng.uniform(0.5, 4, n), jnp.float32)
    want = jbnn.fold(params, cfg)
    got = tbnn.fold(convert.params_from_jax(params),
                    tbnn.MLPConfig(layer_sizes=(40, 24, 6), bias_cells=16))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.weights_pm1, w.weights_pm1)
        np.testing.assert_array_equal(g.c, w.c)
        assert (g.n_in, g.n_out) == (w.n_in, w.n_out)


def test_noise_slice_raises():
    with pytest.raises(NotImplementedError, match="noise"):
        tens.EnsembleConfig(noise=object())
    _, _, tf, _, th = _heads("2048x64")
    with pytest.raises(NotImplementedError, match="noise"):
        tens.build_head(tf[-1], tens.EnsembleConfig(calibrated=True))
    with pytest.raises(NotImplementedError, match="noise"):
        tens.predict(th, torch.ones(2, 32), tens.EnsembleConfig(
            mode="faithful"))
