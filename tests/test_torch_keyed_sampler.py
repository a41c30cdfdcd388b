"""The keyed sampler's wrapper (`kernels/keyed_sampler.py`) on the CPU:
its plain version is the composition `SearchPhysics.sample_keyed` drew
before the kernel (three `keys.keyed_normals` streams, `combine_deltas`,
the base schedule) bit for bit, it launches nothing here, the `sampler`
span says which path drew, the operands are checked, and the noiseless
limit returns the base schedule without drawing.  The kernel itself is
held against the plain version on the card (`tests/test_torch_cuda.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import bnn, ensemble, keys, physics
from repro_torch.core.device_model import NOISELESS, SILICON, NoiseModel
from repro_torch.kernels import keyed_sampler

ZERO = NoiseModel(sigma_hd=0.0, sigma_vref=0.0, sigma_tjitter=0.0)
ONE_SIGMA = {"sigma_hd": 2.0, "sigma_vref": 0.05, "sigma_tjitter": 0.1,
             "temp_drift_hd": 3.0}
NOISES = {"silicon": SILICON,
          "silicon+drift": dataclasses.replace(SILICON, temp_drift_hd=-1.5),
          # a strobe jitter wide enough that the clamp at 0.5 bites
          "wide_jitter": dataclasses.replace(SILICON, sigma_tjitter=0.6),
          **{name: dataclasses.replace(ZERO, **{name: v})
             for name, v in ONE_SIGMA.items()}}


def _physics(noise, calibrated=False, n_classes=10, n_in=128):
    rng = np.random.default_rng(4)
    layer = bnn.FoldedLayer(
        weights_pm1=rng.choice([-1, 1], (n_classes, n_in)).astype(np.int8),
        c=rng.integers(-30, 31, n_classes))
    head = ensemble.build_head(layer,
                               ensemble.EnsembleConfig(calibrated=calibrated))
    return physics.SearchPhysics.for_head(head, noise)


def _key_words(b, seed=0):
    k = np.random.default_rng(seed).integers(0, 2 ** 32, (b, 2),
                                             dtype=np.uint64)
    return keys.as_key_words(k.astype(np.uint32))


def _composed(ph, kw, n_rows, n_samples):
    """What `sample_keyed` computed before the kernel, written out."""
    lead = (ph.n_passes, 1, 1, 1)
    z = [keys.keyed_normals(kw, n_samples, ph.n_passes, n, stream)
         for n, stream in ((1, keys.STREAM_VREF), (1, keys.STREAM_TJITTER),
                           (n_rows, keys.STREAM_ROW))]
    delta = physics.combine_deltas(ph.noise, ph.m_logical.reshape(lead),
                                   ph.dm_dvref.reshape(lead), *z)
    return ph.thresholds.reshape(lead) + delta


@pytest.mark.parametrize("noise", sorted(NOISES))
@pytest.mark.parametrize("shape", [(1, 1, 20), (17, 1, 20), (300, 4, 10),
                                   (5, 2, 33)])
def test_plain_equals_the_composition_bit_for_bit(noise, shape):
    b, s, n = shape
    ph = _physics(NOISES[noise])
    kw = _key_words(b, seed=b)
    want = _composed(ph, kw, n, s)
    before = keyed_sampler.keyed_thresholds.launches
    got = keyed_sampler.keyed_thresholds(kw, ph.thresholds, ph.m_logical,
                                         ph.dm_dvref, ph.noise, n, s)
    assert got.shape == (33, s, b, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(ph.sample_keyed(kw, n, s), want)
    assert keyed_sampler.keyed_thresholds.launches == before  # CPU: plain


@pytest.mark.parametrize("calibrated", [False, True])
def test_calibrated_head_fields_take_the_same_path(calibrated):
    """A calibrated head only changes the m_logical / dm_dvref vectors."""
    ph = _physics(SILICON, calibrated=calibrated, n_classes=20)
    kw = _key_words(40, seed=9)
    assert torch.equal(ph.sample_keyed(kw, 20, 3), _composed(ph, kw, 20, 3))


def test_each_row_depends_on_its_own_key_alone():
    ph = _physics(SILICON)
    kw = _key_words(23, seed=2)
    whole = ph.sample_keyed(kw, 10, 2)
    for i in (0, 11, 22):
        assert torch.equal(ph.sample_keyed(kw[i:i + 1], 10, 2)[:, :, 0],
                           whole[:, :, i])


def test_the_sampler_span_counts_the_plain_path():
    ph = _physics(SILICON)
    obs.take()
    obs.enable()
    try:
        ph.sample_keyed(_key_words(6), 10, 1)
        physics.SearchPhysics.for_sweep(ph.thresholds, NOISELESS) \
            .sample_keyed(_key_words(6), 10, 1)
        records, _ = obs.take()
    finally:
        obs.disable()
        obs.take()
    assert [(r.name, r.counts) for r in records] == [
        ("sampler", {"kernel": 0}), ("sampler", {})]


@pytest.mark.parametrize("case", ["float_keys", "int32_keys", "key_shape",
                                  "key_rank", "field_dtype", "field_length",
                                  "passes", "rows", "samples"])
def test_the_wrapper_checks_its_operands(case):
    ph = _physics(SILICON)
    kw, n, s = _key_words(4), 10, 1
    fields = [ph.thresholds, ph.m_logical, ph.dm_dvref]
    err = ValueError
    if case == "float_keys":
        kw, err = kw.double(), TypeError
    elif case == "int32_keys":
        kw, err = kw.to(torch.int32), TypeError
    elif case == "key_shape":
        kw = torch.zeros((4, 3), dtype=torch.int64)
    elif case == "key_rank":
        kw = torch.zeros((8,), dtype=torch.int64)
    elif case == "field_dtype":
        fields[1] = fields[1].double()
    elif case == "field_length":
        fields[2] = fields[2][:-1]
    elif case == "passes":
        fields = [torch.zeros(keys.MAX_PASSES + 1)] * 3
    elif case == "rows":
        n = keys.MAX_ROWS + 1
    else:
        s = -1
    with pytest.raises(err):
        keyed_sampler.keyed_thresholds(kw, *fields, ph.noise, n, s)


@pytest.mark.parametrize("noise", [NOISELESS, ZERO])
def test_the_noiseless_limit_returns_the_base_without_drawing(noise,
                                                              monkeypatch):
    ph = _physics(noise)

    def refuse(*args, **kw):
        raise AssertionError("a noiseless physics must not draw")

    monkeypatch.setattr(keyed_sampler, "keyed_thresholds", refuse)
    t = ph.sample_keyed(_key_words(5), 10, 3)
    base = ph.thresholds[:, None, None, None]
    assert torch.equal(t, base.expand(33, 3, 5, 10))
    assert t.stride() == (1, 0, 0, 0)  # a view of the schedule


def test_empty_batches_and_widths_draw_nothing():
    ph = _physics(SILICON)
    for b, n, s in ((0, 10, 1), (3, 0, 1), (3, 10, 0)):
        t = ph.sample_keyed(_key_words(b), n, s)
        assert t.shape == (33, s, b, n)
