"""The port's `compile_pipeline(...).run` against the JAX reference's:
votes, argmax and the noiseless cumulative staircase, bit-exact, on the
bank-configuration nets and the paper's MNIST/HG widths, at ragged batch
sizes that cross buckets; and silicon mode: every noisy spec's noiseless
limit bit-exact, batch draws replayed from the generator state and the
reference's own samples fed to the kernels' plain versions (exact),
per-request results invariant to batching (exact), per-request MC in
distribution (mean within 5 SE, std within 15 %, 1024 samples), and the
reference's key-validation messages."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (BANK_BIAS, BANK_NETS, PAPER_NETS, pm1, random_cnn,
                         random_folded)
from repro import pipeline as jpipe
from repro.core import device_model as jdm
from repro.core import ensemble as jens
from repro.spec import InferenceSpec as JSpec
from repro_torch import pipeline as tpipe
from repro_torch.core import device_model as tdm
from repro_torch.core import ensemble as tens
from repro_torch.core.device_model import NOISELESS
from repro_torch.spec import InferenceSpec

SPECS = {
    "votes": (JSpec(), InferenceSpec()),
    "argmax": (JSpec(reduction="argmax"), InferenceSpec(reduction="argmax")),
    "cumulative": (JSpec(cumulative=True), InferenceSpec(cumulative=True)),
}
NETS = {**{b: (BANK_NETS[b], BANK_BIAS[b]) for b in BANK_NETS},
        **{m: (s, 64) for m, s in PAPER_NETS.items()},
        "deep": ((120, 96, 64, 33, 7), 64), "head-only": ((128, 10), 64)}


def _pipes(name, jimpl="xla"):
    sizes, bias = NETS[name]
    jf, tf = random_folded(sizes, sum(map(ord, name)), bias)
    j = jpipe.compile_pipeline(jf, jens.EnsembleConfig(bias_cells=bias),
                               impl=jimpl, min_bucket=8, bq=16)
    t = tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                               device="cpu", min_bucket=8)
    return sizes, j, t


@pytest.mark.parametrize("name", sorted(NETS))
def test_run_matches_reference_at_ragged_batches(name):
    sizes, j, t = _pipes(name)
    rng = np.random.default_rng(len(name))
    for b in (1, 9, 23) if sizes[0] < 4096 else (5, 17):
        x = pm1(rng, (b, sizes[0]))
        for sname, (jspec, tspec) in SPECS.items():
            want = np.asarray(j.run(jnp.asarray(x), jspec))
            got = t.run(x, tspec)
            assert got.dtype == torch.int32, sname
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{sname} B={b}")


def test_run_matches_pallas_reference():
    sizes, j, t = _pipes("2048x64", jimpl="pallas")
    x = pm1(np.random.default_rng(4), (11, sizes[0]))
    want = np.asarray(j.run(jnp.asarray(x), JSpec()))
    np.testing.assert_array_equal(t.run(x, InferenceSpec()).numpy(),
                                  want)


def test_results_are_padding_invariant_and_cached():
    sizes, _, p = _pipes("1024x128")
    x = pm1(np.random.default_rng(0), (37, sizes[0]))
    full = p.run(x, InferenceSpec())
    parts = torch.cat([p.run(x[:1], InferenceSpec()),
                       p.run(x[1:20], InferenceSpec()),
                       p.run(x[20:], InferenceSpec())])
    assert torch.equal(full, parts)
    assert p.program(InferenceSpec()) is p.program(InferenceSpec())
    assert p.buckets_for(100) == (8, 16, 32, 64, 128)
    times = p.warmup(20, specs=(InferenceSpec(), InferenceSpec(
        reduction="argmax")))
    assert set(times) == {(s, b) for s in (InferenceSpec(), InferenceSpec(
        reduction="argmax")) for b in (8, 16, 32)}
    assert all(v >= 0 for v in times.values())


def test_buckets_match_reference():
    for n in (1, 7, 8, 9, 64, 65, 1000):
        for mb in (1, 8, 64):
            assert tpipe.next_bucket(n, mb) == jpipe.next_bucket(n, mb)
    assert tpipe.bucket_grid(300, 8) == jpipe.bucket_grid(300, 8)
    with pytest.raises(ValueError):
        tpipe.next_bucket(0)
    with pytest.raises(ValueError, match="max_bucket"):
        tpipe.next_bucket(100, 64, max_bucket=64)


def test_unported_options_raise():
    sizes, bias = NETS["2048x64"]
    _, tf = random_folded(sizes, 0, bias)
    cfg = tens.EnsembleConfig(bias_cells=bias)
    # silicon mode is ported: noise= compiles and carries the physics
    nl = tpipe.compile_pipeline(tf, cfg, device="cpu", noise=NOISELESS)
    assert nl.physics is not None and nl.physics.is_noiseless
    # donate= is the reference's no-op: it compiles and changes no vote
    donated = tpipe.compile_pipeline(tf, cfg, device="cpu", donate=True)
    xd = pm1(np.random.default_rng(1), (5, sizes[0]))
    assert torch.equal(
        donated.run(xd, InferenceSpec()),
        tpipe.compile_pipeline(tf, cfg, device="cpu").run(xd, InferenceSpec()))
    # the CNN slice is ported: image_side on an MLP graph is the
    # reference's ValueError
    with pytest.raises(ValueError, match="conv-only"):
        tpipe.compile_pipeline(tf, cfg, device="cpu", image_side=28)
    p = tpipe.compile_pipeline(tf, cfg, device="cpu")
    x = pm1(np.random.default_rng(0), (3, sizes[0]))
    for spec in (InferenceSpec(noise="batch"),
                 InferenceSpec(noise="per_request")):
        with pytest.raises(ValueError, match="silicon-mode"):
            p.run(x, spec)
    with pytest.raises(ValueError, match="deterministic"):
        p.run(x, InferenceSpec(), key=np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match=r"expected x"):
        p.run(x[:, :-1], InferenceSpec())


def test_to_device_round_trip():
    sizes, _, p = _pipes("2048x64")
    assert p.to("cpu") is p
    no_card = not torch.cuda.is_available()
    with (pytest.raises(RuntimeError, match="CUDA") if no_card
          else contextlib.nullcontext()):
        p.to("cuda")


# ---------------------------------------------------------------------------
# silicon mode
# ---------------------------------------------------------------------------
NOISY_SPECS = (
    InferenceSpec(noise="batch"),
    InferenceSpec(noise="batch", reduction="argmax"),
    InferenceSpec(noise="batch", mc_samples=3),
    InferenceSpec(noise="batch", mc_samples=3, reduction="sum"),
    InferenceSpec(noise="batch", cumulative=True),
    InferenceSpec(noise="per_request"),
    InferenceSpec(noise="per_request", reduction="argmax"),
    InferenceSpec(noise="per_request", mc_samples=3),
    InferenceSpec(noise="per_request", mc_samples=3, reduction="sum"),
)


def _silicon_pipes(name, noise="SILICON", min_bucket=8):
    """(reference pipeline, port pipeline, input batch maker) of an MLP in
    NETS or of the tiny CNN ("cnn"), compiled with the named NoiseModel
    (None: without noise=)."""
    jn = getattr(jdm, noise) if noise else None
    tn = getattr(tdm, noise) if noise else None
    if name == "cnn":
        jf, tf, jcfg, tcfg = random_cnn(3)
        j = jpipe.compile_pipeline(jf, jens.EnsembleConfig(), impl="xla",
                                   min_bucket=min_bucket, noise=jn,
                                   image_side=jcfg.side,
                                   image_encoding=jcfg.encoding)
        t = tpipe.compile_pipeline(tf, tens.EnsembleConfig(), device="cpu",
                                   min_bucket=min_bucket, noise=tn,
                                   image_side=tcfg.side,
                                   image_encoding=tcfg.encoding)
        return j, t, lambda rng, b: rng.random((b, tcfg.n_in)).astype(
            np.float32)
    sizes, bias = NETS[name]
    jf, tf = random_folded(sizes, sum(map(ord, name)), bias)
    j = jpipe.compile_pipeline(jf, jens.EnsembleConfig(bias_cells=bias),
                               impl="xla", min_bucket=min_bucket, noise=jn)
    t = tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                               device="cpu", min_bucket=min_bucket, noise=tn)
    return j, t, lambda rng, b: pm1(rng, (b, sizes[0]))


def _rng_args(spec, gen, keys):
    return dict(key=gen if spec.needs_key else None,
                keys=keys if spec.needs_keys else None)


@pytest.mark.parametrize("name", ["512x256", "1024x128", "2048x64", "deep",
                                  "head-only", "cnn"])
def test_noisy_specs_noiseless_limit_bit_exact(name):
    """noise=NOISELESS: every silicon spec equals the noiseless votes (and
    the reference's) bit for bit; MC draws repeat them, sums scale them,
    the batch staircase is the exact one (tests/test_pipeline.py:192)."""
    j, t, make = _silicon_pipes(name, "NOISELESS")
    x = make(np.random.default_rng(8), 19)
    want = np.asarray(j.run(jnp.asarray(x), JSpec()))
    stair = np.asarray(j.run(jnp.asarray(x), JSpec(cumulative=True)))
    gen = torch.Generator().manual_seed(0)
    keys = np.arange(38, dtype=np.uint32).reshape(19, 2)
    for spec in NOISY_SPECS:
        got = t.run(x, spec, **_rng_args(spec, gen, keys)).numpy()
        if spec.cumulative:
            expect = stair
        elif spec.reduction == "argmax":
            expect = want.argmax(-1)
        elif spec.mc_samples and spec.reduction == "sum":
            expect = spec.mc_samples * want
        elif spec.mc_samples:
            expect = np.broadcast_to(want, (spec.mc_samples,) + want.shape)
        else:
            expect = want
        np.testing.assert_array_equal(got, expect, err_msg=spec.describe())


@pytest.mark.parametrize("name", ["1024x128", "head-only", "cnn"])
def test_batch_draws_replay_and_take_injected_samples(name):
    """noise="batch" draws exactly one physics.sample(gen, (Bp,), C) on the
    padded batch (MC: one (S, Bp) draw), and the kernels' plain versions
    and the port's compare give the reference's votes when fed the
    reference's own samples."""
    j, t, make = _silicon_pipes(name)
    rng = np.random.default_rng(5)
    x = make(rng, 11)  # bucket 16: five pad rows take draws too
    xp, _ = t._bucketed(t._pack_input(torch.from_numpy(x)))
    hd = t._head_distances(xp).float()
    gen = torch.Generator().manual_seed(3)
    for spec, draw in ((InferenceSpec(noise="batch"), (16,)),
                       (InferenceSpec(noise="batch", mc_samples=4), (4, 16)),
                       (InferenceSpec(noise="batch", cumulative=True),
                        (16,))):
        state = gen.get_state()
        got = t.run(x, spec, key=gen)
        replay = torch.Generator().manual_seed(0)
        replay.set_state(state)
        s = t.physics.sample(replay, draw, t.n_classes)
        per = hd <= s
        want = (torch.cumsum(per, 0, dtype=torch.int32) if spec.cumulative
                else per.sum(0, dtype=torch.int32))
        assert torch.equal(got, t._trim(want, 11, spec.batch_axis)), \
            spec.describe()
    # the reference's samples, at batch == bucket (its draw shape)
    x = make(rng, 16)
    key = jax.random.PRNGKey(9)
    want = np.asarray(j.run(jnp.asarray(x), JSpec(noise="batch"), key=key))
    s = np.array(j.physics.sample(key, (16,), j.n_classes))
    xp = t._pack_input(torch.from_numpy(x))
    samples = torch.from_numpy(np.ascontiguousarray(np.moveaxis(s, 0, -1)))
    np.testing.assert_array_equal(t._votes(xp, thr_samples=samples).numpy(),
                                  want)
    hd = t._head_distances(xp).float()
    np.testing.assert_array_equal(
        (hd <= torch.from_numpy(s)).sum(0, dtype=torch.int32).numpy(), want)


@pytest.mark.parametrize("name", ["2048x64", "cnn"])
def test_per_request_invariant_to_batching_and_padding(name):
    """Row i's per-request result depends only on (x_i, keys_i): any split,
    single rows, and another bucket floor give the same bits
    (tests/test_serve_picbnn.py:71,333,352)."""
    _, t, make = _silicon_pipes(name)
    _, t32, _ = _silicon_pipes(name, min_bucket=32)
    x = make(np.random.default_rng(4), 21)
    keys = np.random.default_rng(5).integers(0, 2 ** 32, (21, 2),
                                             dtype=np.uint64).astype(np.uint32)
    for spec in NOISY_SPECS[5:]:
        full = t.run(x, spec, keys=keys)
        ax = spec.batch_axis
        split = torch.cat([t.run(x[:13], spec, keys=keys[:13]),
                           t.run(x[13:], spec, keys=keys[13:])], dim=ax)
        single = torch.cat([t.run(x[i:i + 1], spec, keys=keys[i:i + 1])
                            for i in range(0, 21, 5)], dim=ax)
        assert torch.equal(full, split), spec.describe()
        assert torch.equal(full.index_select(ax, torch.arange(0, 21, 5)),
                           single), spec.describe()
        assert torch.equal(t32.run(x, spec, keys=keys), full), \
            spec.describe()
    # the key words may come as numpy uint32 or as an int32/int64 tensor
    spec = InferenceSpec(noise="per_request")
    full = t.run(x, spec, keys=keys)
    for k in (torch.from_numpy(keys.view(np.int32)),
              torch.from_numpy(keys.astype(np.int64))):
        assert torch.equal(t.run(x, spec, keys=k), full)
    assert not torch.equal(t.run(x, spec, keys=keys[::-1].copy()), full)


def test_per_request_mc_matches_reference_distribution():
    """Per-request MC under SILICON, 1024 samples of each of 4 requests:
    per-class vote mean within 5 SE of the reference's, std within 15 %."""
    j, t, make = _silicon_pipes("2048x64")
    x = make(np.random.default_rng(2), 4)
    spec = InferenceSpec(noise="per_request", mc_samples=1024)
    jkeys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))
    want = np.asarray(j.run(jnp.asarray(x), JSpec(
        noise="per_request", mc_samples=1024), keys=jkeys))
    got = t.run(x, spec, keys=np.arange(8, dtype=np.uint32).reshape(4, 2))
    assert got.shape == (1024, 4, t.n_classes)
    got = got.numpy()
    n = got.shape[0]
    se = np.sqrt(got.var(0) / n + want.var(0) / n)
    assert (np.abs(got.mean(0) - want.mean(0)) <= 5 * se).all()
    sa, sb = got.std(0), want.std(0)
    assert (np.abs(sa - sb) <= 0.15 * np.maximum(sa, sb)).all()
    assert sa.max() > 0.3


def test_key_validation_matches_reference():
    """The same requests are refused with the reference's messages (the
    key-shape message names [B, 2] words instead of jax keys)."""
    j, t, make = _silicon_pipes("2048x64")
    jnl, tnl, _ = _silicon_pipes("2048x64", noise=None)
    x = make(np.random.default_rng(0), 3)
    gen = torch.Generator().manual_seed(0)
    jkey = jax.random.PRNGKey(0)
    kz = np.zeros((3, 2), np.uint32)
    cases = [
        (InferenceSpec(), JSpec(), dict(key=gen), dict(key=jkey)),
        (InferenceSpec(noise="batch"), JSpec(noise="batch"), {}, {}),
        (InferenceSpec(noise="batch"), JSpec(noise="batch"),
         dict(key=gen, keys=kz), dict(key=jkey, keys=kz)),
        (InferenceSpec(noise="per_request"), JSpec(noise="per_request"),
         {}, {}),
        (InferenceSpec(noise="per_request"), JSpec(noise="per_request"),
         dict(key=gen, keys=kz), dict(key=jkey, keys=kz)),
    ]
    for tspec, jspec, tkw, jkw in cases:
        with pytest.raises(ValueError) as te:
            t.run(x, tspec, **tkw)
        with pytest.raises(ValueError) as je:
            j.run(jnp.asarray(x), jspec, **jkw)
        assert str(te.value) == str(je.value)
    for pipe, jp in ((tnl, jnl),):
        for tspec in (InferenceSpec(noise="batch"),
                      InferenceSpec(noise="per_request")):
            with pytest.raises(ValueError) as te:
                pipe.run(x, tspec)
            with pytest.raises(ValueError) as je:
                jp.run(jnp.asarray(x), JSpec(noise=tspec.noise))
            assert str(te.value) == str(je.value)
            with pytest.raises(ValueError, match="silicon-mode"):
                pipe.warmup(8, specs=(tspec,))
    with pytest.raises(ValueError, match="keys must be"):
        t.run(x, InferenceSpec(noise="per_request"), keys=kz[:2])
    with pytest.raises(ValueError, match="keys must be"):
        t.run(x, InferenceSpec(noise="per_request"),
              keys=np.zeros((3, 3), np.uint32))
    with pytest.raises(TypeError, match="torch.Generator"):
        t.run(x, InferenceSpec(noise="batch"), key=jkey)


def test_silicon_warmup_covers_the_reference_specs():
    j, t, _ = _silicon_pipes("2048x64")
    for mc in (None, 2):
        got = t.default_warmup_specs(mc)
        want = j.default_warmup_specs(mc)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]
    times = t.warmup(16, mc_samples=2)
    assert set(times) == {(s, b) for s in t.default_warmup_specs(2)
                          for b in (8, 16)}
    assert t.to("cpu") is t and t.physics.device.type == "cpu"
