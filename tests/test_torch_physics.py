"""The port's device model, search physics and noisy Algorithm-1 modes
(`repro_torch.core.device_model`, `physics`, `keys`, `cam.search`,
`ensemble`'s noisy half) against the JAX reference.

Deterministic parts are exact (or to the float32 tolerance stated at
each assert); random draws agree in distribution: a torch generator does
not reproduce `jax.random`.  Distribution bar: per-class vote mean within
5 standard errors of the difference, std within 15 %, over >= 1024 draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import BANK_BIAS, BANK_NETS, PAPER_NETS, pm1, random_folded
from repro import pipeline as jpipe
from repro.core import bnn as jbnn
from repro.core import device_model as jdm
from repro.core import ensemble as jens
from repro.core import physics as jphys
from repro_torch import convert
from repro_torch import pipeline as tpipe
from repro_torch.core import binarize as tbin
from repro_torch.core import bnn as tbnn
from repro_torch.core import device_model as tdm
from repro_torch.core import ensemble as tens
from repro_torch.core import keys as tkeys
from repro_torch.core import physics as tphys
from repro_torch.core.cam import CAMArray
from repro_torch.spec import InferenceSpec

ZERO = tdm.NoiseModel(sigma_hd=0.0, sigma_vref=0.0, sigma_tjitter=0.0)
SIGMAS = {"sigma_hd": 2.0, "sigma_vref": 0.05, "sigma_tjitter": 0.1,
          "temp_drift_hd": 3.0}


def _one_sigma(name):
    return dataclasses.replace(ZERO, **{name: SIGMAS[name]})


def _heads(seed=0, n_classes=10, n_in=128, calibrated=False):
    """The same random output layer as a reference head and a port head."""
    rng = np.random.default_rng(seed)
    w = rng.choice([-1, 1], (n_classes, n_in)).astype(np.int8)
    c = rng.integers(-30, 31, n_classes)
    jh = jens.build_head(jbnn.FoldedLayer(weights_pm1=w, c=c),
                         jens.EnsembleConfig(calibrated=calibrated))
    th = tens.build_head(tbnn.FoldedLayer(weights_pm1=w, c=c),
                         tens.EnsembleConfig(calibrated=calibrated))
    return jh, th


def _assert_same_distribution(a, b):
    """a, b: [n, ...] vote draws of the two packages."""
    n = a.shape[0]
    se = np.sqrt(a.var(0) / n + b.var(0) / n)
    assert (np.abs(a.mean(0) - b.mean(0)) <= 5 * se).all(), (
        a.mean(0), b.mean(0), se)
    sa, sb = a.std(0), b.std(0)
    assert (np.abs(sa - sb) <= 0.15 * np.maximum(sa, sb)).all(), (sa, sb)
    assert sa.max() > 0.3  # the noise moved the votes at all


# ---------------------------------------------------------------------------
# device model: exact against the reference
# ---------------------------------------------------------------------------
def test_default_params_and_constants_match_reference():
    want, got = jdm.default_params(), tdm.default_params()
    for f in dataclasses.fields(jdm.AnalogParams):
        np.testing.assert_allclose(getattr(got, f.name),
                                   getattr(want, f.name), rtol=1e-6)
    np.testing.assert_array_equal(tdm.TABLE1, jdm.TABLE1)
    assert tdm.BANK_CONFIGS == jdm.BANK_CONFIGS
    assert dataclasses.asdict(tdm.EnergyModel()) == dataclasses.asdict(
        jdm.EnergyModel())
    assert tdm.EnergyModel().search_energy_j(512, 256) == \
        jdm.EnergyModel().search_energy_j(512, 256)
    for nm in ("SILICON", "NOISELESS"):
        assert convert.noise_from_jax(getattr(jdm, nm)) == getattr(tdm, nm)
    assert convert.analog_params_from_jax(want) == got


def test_hd_threshold_and_calibration_match_reference():
    """float32 model values within 2 ulp (numpy's float32 log/pow against
    XLA's), residuals and the calibrated model to 1e-4 HD."""
    p = jdm.default_params()
    v = jdm.TABLE1 / 1e3
    want = np.asarray(jdm.hd_threshold(p, v[:, 0], v[:, 1], v[:, 2]))
    got = tdm.hd_threshold(convert.analog_params_from_jax(p), v[:, 0],
                           v[:, 1], v[:, 2])
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    np.testing.assert_allclose(tdm.table1_residuals(p),
                               jdm.table1_residuals(p), atol=1e-4)
    np.testing.assert_allclose(tdm.default_calibrated().residuals_table1(),
                               jdm.default_calibrated().residuals_table1(),
                               atol=1e-4)
    # the torch twin (the knob-space sampler's) equals the numpy one
    tt = tdm.hd_threshold(p, torch.tensor(v[:, 0]), v[:, 1], v[:, 2])
    np.testing.assert_array_max_ulp(tt.numpy(), got, maxulp=2)


def test_knob_schedule_and_achieved_sweep_match_reference():
    """achieved_sweep(33, 64) to 1e-4.  The V_ref grid search agrees on
    every pass but those whose achieved tolerance is clipped to 0: there
    every grid point ties near |0 - target| and the pick turns on the
    last bit of the RBF residual, which XLA's and numpy's float32 log
    round differently."""
    np.testing.assert_allclose(tphys.achieved_sweep(33, 64),
                               jphys.achieved_sweep(33, 64), atol=1e-4)
    jk, ja = jphys._schedule_cached(33, 64)
    tk, ta = tphys._schedule_cached(33, 64)
    differ = (jk != tk).any(1)
    assert not differ[ja > 0].any()
    assert (ta[differ] == 0).all()


@pytest.mark.parametrize("noise", ["SILICON", "NOISELESS", "sigma_hd",
                                   "sigma_vref"])
@pytest.mark.parametrize("calibrated", [False, True])
def test_for_head_fields_match_reference(noise, calibrated):
    """thresholds, m_logical and dm_dvref to 1e-4 (dm_dvref on the passes
    whose knob points agree, see the schedule test above)."""
    jn = getattr(jdm, noise) if noise.isupper() else dataclasses.replace(
        jdm.NoiseModel(0.0, 0.0, 0.0), **{noise: SIGMAS[noise]})
    jh, th = _heads(calibrated=calibrated)
    jp = jphys.SearchPhysics.for_head(jh, jn)
    tp = tphys.SearchPhysics.for_head(th, convert.noise_from_jax(jn))
    np.testing.assert_allclose(th.thresholds.numpy(),
                               np.asarray(jh.thresholds), atol=1e-4)
    for f in ("thresholds", "m_logical", "dm_dvref"):
        got, want = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert got.dtype == np.float32 and got.shape == want.shape
        keep = np.ones(got.shape, bool)
        if f == "dm_dvref" and not calibrated and jn.sigma_vref:
            keep = ~(jphys._schedule_cached(33, 64)[0]
                     != tphys._schedule_cached(33, 64)[0]).any(1)
            assert keep.sum() >= 31
        np.testing.assert_allclose(got[keep], want[keep], atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("name", sorted({**BANK_NETS, **PAPER_NETS}))
def test_calibrated_votes_bit_equal(name):
    """Calibrated (float32) heads: thresholds to 1e-4, and the pipelines'
    votes bit-equal on the bank nets and the paper's MLP widths."""
    sizes = {**BANK_NETS, **PAPER_NETS}[name]
    bias = BANK_BIAS.get(name, 64)
    jf, tf = random_folded(sizes, sum(map(ord, name)), bias)
    j = jpipe.compile_pipeline(jf, jens.EnsembleConfig(
        bias_cells=bias, calibrated=True), impl="xla", min_bucket=8)
    t = tpipe.compile_pipeline(tf, tens.EnsembleConfig(
        bias_cells=bias, calibrated=True), device="cpu", min_bucket=8)
    assert t.head.thresholds.dtype == torch.float32
    np.testing.assert_allclose(t.head.thresholds.numpy(),
                               np.asarray(j.head.thresholds), atol=1e-4)
    x = pm1(np.random.default_rng(1), (13, sizes[0]))
    for spec in (InferenceSpec(), InferenceSpec(cumulative=True)):
        np.testing.assert_array_equal(t.run(x, spec).numpy(),
                                      np.asarray(j.run(jnp.asarray(x), spec)))
    with pytest.raises(ValueError, match="equispaced"):
        tens.build_head(tf[-1], tens.EnsembleConfig(thresholds=(0, 1, 5),
                                                    calibrated=True))


# ---------------------------------------------------------------------------
# the sampling core
# ---------------------------------------------------------------------------
def test_delta_arithmetic_matches_numpy_transcription():
    """combine_deltas on given normals equals a float32 numpy
    transcription of the reference's arithmetic (physics.py:130-138),
    with the reference's fields, to 1 ulp."""
    jh, _ = _heads(3)
    jp = jphys.SearchPhysics.for_head(jh, jdm.SILICON)
    rng = np.random.default_rng(0)
    p = jp.n_passes
    zv, zt = (rng.standard_normal((p, 7, 1)).astype(np.float32)
              for _ in range(2))
    zt[0, :3] = -30.0  # the jitter clamp at 0.5
    zr = rng.standard_normal((p, 7, 10)).astype(np.float32)
    ml = np.array(jp.m_logical).reshape(p, 1, 1)
    dm = np.array(jp.dm_dvref).reshape(p, 1, 1)
    n = jdm.SILICON
    f32 = np.float32
    dv = f32(n.sigma_vref) * zv
    tj = f32(1.0) + f32(n.sigma_tjitter) * zt
    want = (dm * dv + ml * (f32(1.0) / np.maximum(tj, f32(0.5)) - f32(1.0))
            + f32(n.sigma_hd) * zr + f32(n.temp_drift_hd))
    got = tphys.combine_deltas(
        convert.noise_from_jax(n), torch.from_numpy(ml),
        torch.from_numpy(dm), *map(torch.from_numpy, (zv, zt, zr)))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_noiseless_limits_are_bit_exact():
    _, th = _heads(1)
    base = th.thresholds.to(torch.float32)
    for noise in (tdm.NOISELESS, ZERO):
        ph = tphys.SearchPhysics.for_head(th, noise)
        gen = torch.Generator().manual_seed(0)
        t = ph.sample(gen, (4,), 10)
        assert t.shape == (33, 4, 10)
        assert torch.equal(t, base[:, None, None].expand(t.shape))
        assert torch.equal(ph.sample(None, (4,), 10), t)
        kw = torch.zeros((5, 2), dtype=torch.int64)
        assert torch.equal(ph.sample_keyed(kw, 10, 3),
                           base[:, None, None, None].expand(33, 3, 5, 10))
    x = torch.from_numpy(pm1(np.random.default_rng(2), (16, 128)))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tens.votes_fused_noisy(th, x, key=gen,
                                              noise=tdm.NOISELESS),
                       tens.votes_fused(th, x))
    assert torch.equal(tens.votes_faithful(th, x, key=gen),
                       tens.votes_fused(th, x))
    assert torch.equal(
        tphys.sample_search_thresholds(None, 60, tdm.SILICON, (3, 4)),
        torch.full((3, 4), 60.0))


def test_draw_structure_pass_global_and_per_row():
    """V_ref and strobe draws are shared by the rows of one search; sigma_hd
    is per row; temp drift is a deterministic offset — for the generator
    draws and for the keyed draws alike."""
    _, th = _heads()
    base = th.thresholds.to(torch.float32)[:, None, None]
    kw = tkeys.as_key_words(np.arange(16, dtype=np.uint32).reshape(8, 2))
    for name in ("sigma_vref", "sigma_tjitter", "sigma_hd",
                 "temp_drift_hd"):
        ph = tphys.SearchPhysics.for_head(th, _one_sigma(name))
        for t in (ph.sample(torch.Generator().manual_seed(1), (8,), 10),
                  ph.sample_keyed(kw, 10, 1)[:, 0]):
            spread = t.max(-1).values - t.min(-1).values
            if name == "sigma_hd":
                assert spread.min() > 0, name
            elif name == "temp_drift_hd":
                assert torch.allclose(t, (base + 3.0).expand(t.shape),
                                      rtol=1e-6), name
            else:
                assert spread.max() < 1e-5 and t.std() > 0, name


def test_threefry_matches_jax_and_keyed_normals_are_standard():
    from jax.extend.random import threefry_2x32

    rng = np.random.default_rng(5)
    k = rng.integers(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    c = rng.integers(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    want = np.stack([np.asarray(threefry_2x32(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(k, c)])
    got = tkeys.threefry2x32(*(torch.from_numpy(v.astype(np.int64))
                               for v in (k[:, 0], k[:, 1], c[:, 0], c[:, 1])))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got], 1),
                                  want.astype(np.int64))
    # keyed normals: standard, and a row's draws depend on its key alone
    kw = tkeys.as_key_words(k)
    z = tkeys.keyed_normals(kw, 4, 33, 20, tkeys.STREAM_ROW)
    assert z.shape == (33, 4, 64, 20) and z.dtype == torch.float32
    assert abs(float(z.mean())) < 5 / np.sqrt(z.numel())
    assert abs(float(z.std()) - 1.0) < 0.02
    one = tkeys.keyed_normals(kw[17:18], 4, 33, 20, tkeys.STREAM_ROW)
    assert torch.equal(one[:, :, 0], z[:, :, 17])
    assert not torch.equal(
        tkeys.keyed_normals(kw, 4, 33, 20, tkeys.STREAM_VREF), z)
    # the int32 view of the same words gives the same key
    assert torch.equal(tkeys.as_key_words(torch.from_numpy(k.view(np.int32))),
                       kw)


@pytest.mark.parametrize("name", sorted(SIGMAS))
def test_each_sigma_changes_effective_thresholds(name):
    """cam.search and cam.search_knobs: each sigma alone moves the
    effective thresholds, and the noiseless model stays exact.  (The
    reference's `test_search_knobs_each_sigma_perturbs` asks for a flipped
    match bit, which one sigma_hd draw at its knob point does not give.)"""
    rng = np.random.default_rng(3)
    cam = CAMArray.from_bits(rng.integers(0, 2, (64, 128)).astype(np.uint8))
    q = tbin.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (16, 128)).astype(np.uint8)))
    noise = _one_sigma(name)
    gen = torch.Generator().manual_seed(0)
    t = tphys.sample_search_thresholds(gen, 60, noise, (16, 64))
    assert (t != 60.0).any(), name
    clean = cam.search(q, 60)
    assert torch.equal(clean, (cam.search_hd(q) <= 60).to(torch.uint8))
    assert (cam.search(q, 60, noise=noise, key=gen) != clean).any(), name
    assert torch.equal(cam.search(q, 60, noise=ZERO, key=gen), clean)
    p = tdm.default_params()
    t0 = tdm.hd_threshold(p, 0.95, 0.525, 1.1)
    tk = tphys.sample_effective_threshold(
        torch.Generator().manual_seed(1), p, noise, 0.95, 0.525, 1.1, (64,))
    assert tk.shape == (64,) and (tk != torch.from_numpy(t0)).any(), name
    np.testing.assert_array_equal(
        cam.search_knobs(q, 0.95, 0.525, 1.1).numpy(),
        (cam.search_hd(q).numpy() <= t0).astype(np.uint8))


# ---------------------------------------------------------------------------
# noisy Algorithm 1: the same distribution as the reference
# ---------------------------------------------------------------------------
def test_fused_noisy_and_faithful_match_reference_distribution():
    """Under SILICON, 1024 draws each: the port's votes_fused_noisy and
    votes_faithful against the reference's votes_fused_noisy (mean within
    5 SE, std within 15 %); the port's two modes equal draw for draw."""
    jh, th = _heads(11)
    x = pm1(np.random.default_rng(6), (4, 128))
    n = 1024
    jp = jphys.SearchPhysics.for_head(jh, jdm.SILICON)
    keys = jax.random.split(jax.random.PRNGKey(100), n)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jens.votes_fused_noisy(
        jh, jnp.asarray(x), key=k, physics=jp)))(keys))  # [n, 4, C]
    tp = tphys.SearchPhysics.for_head(th, tdm.SILICON)
    xs = torch.from_numpy(np.tile(x, (n, 1)))  # each row its own search
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    fused = tens.votes_fused_noisy(th, xs, key=gen, physics=tp)
    gen.set_state(state)
    faithful = tens.votes_faithful(th, xs, key=gen, physics=tp)
    assert torch.equal(fused, faithful)
    _assert_same_distribution(fused.numpy().reshape(n, 4, -1), want)
    gen2 = torch.Generator().manual_seed(8)
    _assert_same_distribution(
        tens.votes_faithful(th, xs, key=gen2, noise=tdm.SILICON)
        .numpy().reshape(n, 4, -1), want)


def test_predict_and_accuracy_sweep_match_reference():
    jh, th = _heads(7)
    x = pm1(np.random.default_rng(4), (64, 128))
    labels = np.asarray(jens.votes_fused(jh, jnp.asarray(x))).argmax(-1)
    xt = torch.from_numpy(x)
    for mode in ("faithful", "fused", "kernel"):
        np.testing.assert_array_equal(
            tens.predict(th, xt, tens.EnsembleConfig(mode=mode)).numpy(),
            np.asarray(jens.predict(jh, jnp.asarray(x),
                                    jens.EnsembleConfig(mode="fused"))))
    want = jens.accuracy_sweep(jh, jnp.asarray(x), labels,
                               jens.EnsembleConfig())
    assert tens.accuracy_sweep(th, xt, labels, tens.EnsembleConfig()) == want
    noisy = tens.accuracy_sweep(
        th, xt, labels, tens.EnsembleConfig(noise=_one_sigma("sigma_hd")),
        key=torch.Generator().manual_seed(0))
    assert any(noisy[p]["top1"] != want[p]["top1"] for p in want)
