"""The benchmark's yardstick on the CPU: the plain reference against
`repro_torch` at small batches (both configurations, a small MLP and CNN
beside them, votes with noise off and with per-row keys), the controls as
real departures, and the bound arithmetic (kernel 3 at HG B = 4096:
0.0007 ms, as the kernel table; kernel 4: 0.0026 ms, its pixels counted
at the encoding's 4 bits, where the table's 0.0202 counted an int32 word
a pixel), pinned at the cells' shapes, with the floating-point term."""

import json
from pathlib import Path

import pytest
import torch

from bench import model, roofline
from bench.reference import bnn as reference
from bench.reference import keyed

BENCH = Path(__file__).resolve().parent
SILICON = {"sigma_hd": 1.0, "sigma_vref": 0.01, "sigma_tjitter": 0.02,
           "temp_drift_hd": 0.0}
SMALL = {
    "mlp-2hidden": dict(model="mlp", layer_sizes=[300, 96, 48, 7],
                        bias_cells=32, thresholds=list(range(0, 33, 2)),
                        c_max=32),
    "cnn-12": dict(model="cnn", side=12,
                   encoding={"kind": "thermometer", "width": 3},
                   conv=[{"k": 3, "c_out": 32, "stride": 2},
                         {"k": 3, "c_out": 32, "stride": 1}],
                   hidden=[48], n_classes=7, bias_cells=64,
                   thresholds=list(range(0, 65, 2)), c_max=24),
}


def _config(name: str) -> dict:
    if name in SMALL:
        return SMALL[name]
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _case(name: str, seed: int, b: int):
    cfg = _config(name)
    gen = torch.Generator().manual_seed(seed)
    net = model.make_net(cfg, gen)
    rows = model.make_rows(cfg, gen, 1, b)[0]
    keys = model.make_keys(gen, 1, b)[0]
    return cfg, net, rows, keys


@pytest.mark.parametrize("name,b", [("hg_mlp", 48), ("hg_cnn", 6),
                                    ("mlp-2hidden", 70), ("cnn-12", 20)])
@pytest.mark.parametrize("noise", ["off", "per_request"])
def test_reference_equals_the_port_on_cpu(name, b, noise):
    from repro_torch.spec import InferenceSpec

    cfg, net, rows, keys = _case(name, 2**31 + 17, b)
    if noise == "off":
        pipe = model.build_pipeline(cfg, net, None, "cpu")
        got = pipe.run(rows, InferenceSpec())
        want = reference.votes(net, cfg, rows)
    else:
        pipe = model.build_pipeline(cfg, net, SILICON, "cpu")
        got = pipe.run(rows, InferenceSpec(noise="per_request"), keys=keys)
        want = reference.votes(net, cfg, rows, keys, SILICON)
        assert not torch.equal(want, reference.votes(net, cfg, rows)), \
            "the silicon draws changed no vote"
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert want.min() < want.max(), "every vote alike: a vacuous check"


@pytest.mark.parametrize("name,control", [("hg_cnn", "bf16_inputs"),
                                          ("cnn-12", "bf16_inputs"),
                                          ("hg_mlp", "half_bias_cells"),
                                          ("mlp-2hidden", "half_bias_cells")])
def test_controls_change_votes(name, control):
    cfg, net, rows, _ = _case(name, 5, 64)
    assert not torch.equal(reference.votes(net, cfg, rows),
                           reference.votes(net, cfg, rows, control=control))


def test_bf16_inputs_leave_pm1_rows_exact():
    cfg, net, rows, _ = _case("hg_mlp", 6, 64)
    assert torch.equal(reference.votes(net, cfg, rows),
                       reference.votes(net, cfg, rows, control="bf16_inputs"))


def test_float32_normals_depart_from_float64():
    words = model.make_keys(torch.Generator().manual_seed(3), 1, 512)[0]
    z64 = keyed.normals(words, 33, 20, 2)
    z32 = keyed.normals(words, 33, 20, 2, float64=False)
    assert not torch.equal(z64, z32)
    assert (z64 - z32).abs().max() < 1e-4
    assert abs(float(z64.mean())) < 0.02 and abs(float(z64.std()) - 1) < 0.02


def test_keyed_draws_depend_on_the_row_key_alone():
    words = model.make_keys(torch.Generator().manual_seed(4), 1, 64)[0]
    base = torch.arange(0, 65, 2, dtype=torch.float32) + 64
    zeros = torch.zeros(33)
    t = keyed.thresholds(words, base, zeros, zeros, SILICON, 20)
    t_sub = keyed.thresholds(words[10:30], base, zeros, zeros, SILICON, 20)
    assert torch.equal(t[:, :, 10:30], t_sub)


def test_parity_rule_leaves_no_dead_zone():
    c = torch.arange(-80, 81).numpy()
    for n_in in (4096, 7200, 36, 300):
        adj = model.parity_adjust(c, n_in, 64)
        assert adj.min() >= -64 and adj.max() <= 64
        assert ((adj + n_in) % 2 == 1).all()


@pytest.mark.parametrize("fn,cfg,ms", [(roofline.fused_mlp, "hg_mlp", 0.0007),
                                       (roofline.fused_conv, "hg_cnn", 0.0026)])
def test_bounds_match_the_kernel_table(fn, cfg, ms):
    w = fn(_config(cfg), 4096)
    assert round(w.bound_s() * 1e3, 4) == ms
    assert w.bound_by() == "bytes"


def test_step_and_gemm_bounds_count_each_byte_once():
    mlp = _config("hg_mlp")
    # 4096 float32 rows of 4096, weights, C's, head rows and thresholds,
    # int32 votes
    assert roofline.step(mlp, 4096).nbytes == (
        4 * 4096 * 4096 + 4 * (128 * 128 + 128) + 4 * (20 * 6 + 33)
        + 4 * 4096 * 20)
    assert roofline.step(mlp, 4096, 16).nbytes == \
        roofline.step(mlp, 4096).nbytes + 16 * 4096
    g = roofline.gemm_hd(32768, 128, 4096)
    assert g.nbytes == 4 * (32768 * 128 + 128 * 128 + 32768 * 128)
    assert g.bitops == 32768 * 128 * 4096
    assert roofline.hd_once_gemms(mlp, 8).bitops == 8 * (128 * 4096 + 20 * 192)


def test_conv_bound_counts_each_pixel_at_its_encoding_bits():
    cnn = _config("hg_cnn")
    tail = roofline.fc_tail(4096, [(128, 7200)], 192, 20, 33)
    convs = roofline.conv_stack(4096, 64, [(3, 2, 4, 32), (3, 2, 32, 32)])
    # thermometer-4: 4 bits a pixel in; filters at c_in bits a tap
    assert roofline.fused_conv(cnn, 4096).nbytes == (
        4096 * 64 * 64 * 4 / 8 + convs.nbytes + tail.nbytes)
    assert convs.nbytes == 32 * 9 * 4 / 8 + 4 * 32 + 32 * 9 * 32 / 8 + 4 * 32


# (configuration, work, key bytes a row) at the cells' batch, 32,768 rows:
# (bytes, bit-MACs, bound s), as `bench/roofline.py` gave them before
# `Work` took a floating-point term
PINS = {
    ("hg_mlp", "fused_mlp", 0): (19465316.0, 17305698304,
                                 5.810542089552239e-06),
    ("hg_mlp", "hd_once_gemms", 0): (37028320.0, 17305698304,
                                     1.1053229850746269e-05),
    ("hg_mlp", "step", 0): (539559012.0, 17305698304,
                            0.00016106239164179106),
    ("hg_mlp", "step", 16): (540083300.0, 17305698304,
                             0.00016121889552238807),
    ("hg_cnn", "fused_conv", 0): (69848180.0, 134549078016,
                                  2.0850202985074626e-05),
    ("hg_cnn", "hd_once_gemms", 0): (49791968.0, 30324817920,
                                     1.4863274029850747e-05),
    ("hg_cnn", "step", 0): (539610228.0, 134549078016, 0.00016107768),
    ("hg_cnn", "step", 16): (540134516.0, 134549078016,
                             0.000161234183880597),
}


@pytest.mark.parametrize("case", sorted(PINS), ids=str)
def test_bounds_at_the_cells_shapes_are_pinned(case):
    cfg, fn, key_bytes = case
    args = (key_bytes,) if fn == "step" else ()
    w = getattr(roofline, fn)(_config(cfg), 32768, *args)
    assert (w.nbytes, w.bitops, w.bound_s()) == PINS[case]
    assert w.flops == 0 and w.bound_by() == "bytes"


def test_a_flops_term_bounds_at_the_dense_bf16_rate():
    w = roofline.Work(0, 0, 2 * 989.5e12)
    assert w.bound_s() == 2.0 and w.bound_by() == "flops"
    total = w + roofline.Work(3.35e12, 0)
    assert total.flops == w.flops and total.bound_s() == 2.0
    assert roofline.Work(3.35e12, 0, 989.5e12).bound_by() == "bytes"
    assert roofline.Work(0, roofline.B1_MACS_PER_S, 989.5e12).bound_by() \
        == "operations"
