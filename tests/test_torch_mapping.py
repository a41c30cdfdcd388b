"""The port's CAM bank mapping and Table-II cost model
(`repro_torch.core.mapping`, `convnet.cnn_inference_cost`) against the JAX
reference on the same numpy-seeded nets: tile plans, the written tiles and
`layer_forward` in both modes bit for bit (tests/test_mapping.py's nets
plus a dedicated bias tile), the cost floats exactly, and the small
pieces this slice adds beside them (`CAMArray.from_pm1`,
`ops.binary_gemm_mxu`'s plain version, `binarize.hamming_pm1` and
`pack_bits_reference`)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY_CNN, cnn_configs, i32, pm1
from benchmarks import table2
from repro.configs import paper_cnn as jpaper_cnn
from repro.core import binarize as jbin
from repro.core import bnn as jbnn
from repro.core import cam as jcam
from repro.core import convnet as jconv
from repro.core import mapping as jmap
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.configs import paper_cnn as tpaper_cnn
from repro_torch.core import binarize as tbin
from repro_torch.core import cam as tcam
from repro_torch.core import convnet as tconv
from repro_torch.core import mapping as tmap
from repro_torch.core.device_model import (
    INFERENCES_PER_S_PER_W,
    MNIST_INFERENCES_PER_S,
    PICBNN_POWER_MW,
)
from repro_torch.kernels import ops as tops

# (n_out, n_in, bias cells): test_mapping.py's single-tile and MNIST
# shapes, the paper's HG layers, odd widths, and n_in = 256 at 256-bit
# rows, where the bias cells get a tile of their own
LAYERS = {
    "single-tile": (64, 128, 64),
    "mnist-in": (128, 784, 64),
    "mnist-out": (10, 128, 64),
    "hg-in": (128, 4096, 64),
    "odd": (37, 901, 64),
    "narrow": (300, 5, 64),
    "bias-tile": (20, 256, 64),
    "bias-tile-512": (9, 512, 64),
    "bias-32": (600, 40, 32),
}


def _layers(n_out, n_in, seed, cmax=30):
    rng = np.random.default_rng(seed)
    jl = jbnn.FoldedLayer(
        weights_pm1=rng.choice([-1, 1], (n_out, n_in)).astype(np.int8),
        c=rng.integers(-cmax, cmax + 1, n_out),
    )
    return jl, convert.folded_from_jax([jl])[0]


@pytest.mark.parametrize("name", LAYERS)
def test_map_layer_and_layer_forward_bit_equal(name):
    n_out, n_in, bias = LAYERS[name]
    jl, tl = _layers(n_out, n_in, seed=len(name))
    jm = jmap.map_layer(jl, bias_cells=bias)
    tm = tmap.map_layer(tl, bias_cells=bias)
    assert dataclasses.asdict(tm.plan) == dataclasses.asdict(jm.plan)
    assert tm.col_widths == jm.col_widths
    assert (tm.n_out, tm.n_in) == (jm.n_out, jm.n_in)
    np.testing.assert_array_equal(tm.c, jm.c)
    for tt, jt in zip(tm.col_tiles, jm.col_tiles, strict=True):
        assert tt.n_bits == jt.n_bits
        np.testing.assert_array_equal(i32(tt.rows_packed),
                                      i32(np.asarray(jt.rows_packed)))
    if name.startswith("bias-tile"):
        assert jm.col_widths[-1] == bias and len(jm.col_tiles) == n_in // \
            jm.plan.row_bits + 1
    x = pm1(np.random.default_rng(7), (9, n_in))
    for mode in ("exact", "hierarchical"):
        got = tmap.layer_forward(tm, torch.from_numpy(x), mode)
        want = np.asarray(jmap.layer_forward(jm, jnp.asarray(x), mode))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # the tile queries, bias drive included
    for tq, jq in zip(tmap._tile_queries(tm, torch.from_numpy(x)),
                      jmap._tile_queries(jm, jnp.asarray(x)), strict=True):
        np.testing.assert_array_equal(i32(tq), i32(np.asarray(jq)))
    with pytest.raises(ValueError):
        tmap.layer_forward(tm, torch.from_numpy(x), "tiled")


def test_plan_layer_equals_reference_over_shapes():
    for n_out in (1, 10, 128, 512, 513, 1024, 2049, 5000):
        for n_in in (1, 5, 64, 128, 192, 256, 784, 4096, 4097):
            for bias in (0, 32, 64):
                assert (dataclasses.asdict(tmap.plan_layer(n_out, n_in, bias))
                        == dataclasses.asdict(
                            jmap.plan_layer(n_out, n_in, bias)))
    custom = ((100, 50), (200, 25))
    assert (dataclasses.asdict(tmap.plan_layer(150, 60, 8, custom))
            == dataclasses.asdict(jmap.plan_layer(150, 60, 8, custom)))


def _port_table2(name, sizes, n_passes=33):
    """benchmarks/table2.analyze on the port's mapping and constants."""
    plans = [tmap.plan_layer(sizes[i + 1], sizes[i], bias_cells=64)
             for i in range(len(sizes) - 1)]
    cost = tmap.model_inference_cost(plans, n_output_passes=n_passes)
    ops_rate = cost.binary_ops / cost.latency_s
    paper = name == "mnist"
    return [
        ("throughput_inf_per_s", name, cost.inferences_per_s,
         MNIST_INFERENCES_PER_S if paper else ""),
        ("energy_per_inference_nj", name, cost.energy_j * 1e9, ""),
        ("inf_per_s_per_w", name, 1.0 / cost.energy_j,
         INFERENCES_PER_S_PER_W if paper else ""),
        ("cycles_per_inference", name, cost.cycles, ""),
        ("binary_ops_per_inference", name, cost.binary_ops, ""),
        ("effective_tops", name, ops_rate / 1e12, ""),
        ("tops_per_w", name, ops_rate / 1e12 / (PICBNN_POWER_MW * 1e-3), ""),
    ]


@pytest.mark.parametrize("name,sizes", [("mnist", (784, 128, 10)),
                                        ("hand-gesture", (4096, 128, 20))])
def test_table2_numbers_equal_reference_exactly(name, sizes):
    assert _port_table2(name, sizes) == table2.analyze(name, sizes)
    for passes in (1, 17, 33):
        jp = [jmap.plan_layer(b, a, 64) for a, b in zip(sizes, sizes[1:])]
        tp = [tmap.plan_layer(b, a, 64) for a, b in zip(sizes, sizes[1:])]
        for kw in ({}, {"batch_per_tune": 1}, {"layer_queries": [3, 1]}):
            tc = tmap.model_inference_cost(tp, passes, **kw)
            jc = jmap.model_inference_cost(jp, passes, **kw)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert tc.inferences_per_s == jc.inferences_per_s
    # the paper's MNIST figures (tests/test_mapping.py's band)
    if name == "mnist":
        cost = tmap.model_inference_cost(tp, 33)
        assert 500e3 <= cost.inferences_per_s <= 700e3
        assert 300e6 <= 1.0 / cost.energy_j <= 1.5e9
    with pytest.raises(ValueError, match="length mismatch"):
        tmap.model_inference_cost(tp, 33, layer_queries=[1])


@pytest.mark.parametrize("which", ["mnist", "hg", "tiny"])
def test_cnn_inference_cost_equals_reference(which):
    if which == "tiny":
        jcfg, tcfg = cnn_configs(TINY_CNN)
    else:
        jcfg = {"mnist": jpaper_cnn.MNIST_CNN, "hg": jpaper_cnn.HG_CNN}[which]
        tcfg = {"mnist": tpaper_cnn.MNIST_CNN, "hg": tpaper_cnn.HG_CNN}[which]
    for passes in (33, 5):
        tc = tconv.cnn_inference_cost(tcfg, passes)
        jc = jconv.cnn_inference_cost(jcfg, passes)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.inferences_per_s == jc.inferences_per_s


def test_cam_from_pm1_equals_reference():
    rng = np.random.default_rng(3)
    for n, k in ((1, 1), (7, 31), (16, 32), (5, 100)):
        v = pm1(rng, (n, k))
        t = tcam.CAMArray.from_pm1(torch.from_numpy(v))
        j = jcam.CAMArray.from_pm1(jnp.asarray(v))
        assert t.n_bits == j.n_bits == k
        np.testing.assert_array_equal(i32(t.rows_packed),
                                      i32(np.asarray(j.rows_packed)))
        # numpy input too, as map_layer passes it
        np.testing.assert_array_equal(
            i32(tcam.CAMArray.from_pm1(v).rows_packed), i32(t.rows_packed))


def test_binary_gemm_mxu_plain_equals_reference():
    rng = np.random.default_rng(4)
    for lead, k, n in (((1,), 1, 1), ((15,), 7, 3), ((17,), 33, 10),
                       ((3, 5), 100, 9), ((), 13, 4)):
        x = pm1(rng, (*lead, k))
        w = pm1(rng, (k, n))
        got = tops.binary_gemm_mxu(torch.from_numpy(x), torch.from_numpy(w))
        want = np.asarray(jops.binary_gemm_mxu(jnp.asarray(x), jnp.asarray(w)))
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="chain"):
        tops.binary_gemm_mxu(torch.ones(2, 3), torch.ones(4, 5))


def test_hamming_pm1_and_pack_bits_reference():
    rng = np.random.default_rng(5)
    a, b = pm1(rng, (6, 4, 70)), pm1(rng, (4, 70))
    got = tbin.hamming_pm1(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jbin.hamming_pm1(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and it agrees with the packed distance
    np.testing.assert_array_equal(
        got.numpy(), tbin.hamming_packed(tbin.pack_pm1(torch.from_numpy(a)),
                                         tbin.pack_pm1(torch.from_numpy(b))))
    for k in (1, 31, 32, 33, 95):
        bits = rng.integers(0, 2, (3, k)).astype(np.uint8)
        bits[0, -1] = 1  # the last word's top valid bit
        got = tbin.pack_bits_reference(torch.from_numpy(bits))
        want = np.asarray(jbin.pack_bits_reference(jnp.asarray(bits)))
        np.testing.assert_array_equal(i32(got), i32(want))
