"""The port's deprecated legacy pipeline API (`votes` ... `__call__`,
`warmup(entries=)`) against the JAX reference's: every noiseless shim
bit-equal to the reference's shim on the same folded MLP and CNN, every
keyed shim bit-equal to the port's own `run(spec)` with the same
generator state / key words, one DeprecationWarning per shim, the
entries -> specs translation, and the reference's errors."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import i32, pm1, random_cnn, random_folded
from repro import pipeline as jpipe
from repro.core import ensemble as jens
from repro_torch import pipeline as tpipe
from repro_torch.core import ensemble as tens
from repro_torch.core.device_model import NOISELESS, SILICON
from repro_torch.spec import InferenceSpec, legacy_entry_spec

MLP = ((128, 48, 10), 64)


def _nets(kind, noise=None):
    """(reference pipeline, port pipeline, input maker) for kind "mlp" or
    "cnn"; `noise` compiles the port's in silicon mode."""
    if kind == "cnn":
        jf, tf, jcfg, tcfg = random_cnn(7)
        j = jpipe.compile_pipeline(jf, jens.EnsembleConfig(), impl="xla",
                                   min_bucket=8, image_side=jcfg.side,
                                   image_encoding=jcfg.encoding)
        t = tpipe.compile_pipeline(tf, tens.EnsembleConfig(), device="cpu",
                                   min_bucket=8, noise=noise,
                                   image_side=tcfg.side,
                                   image_encoding=tcfg.encoding)
        return j, t, lambda rng, b: rng.random((b, tcfg.n_in)).astype(
            np.float32)
    sizes, bias = MLP
    jf, tf = random_folded(sizes, 11, bias)
    j = jpipe.compile_pipeline(jf, jens.EnsembleConfig(bias_cells=bias),
                               impl="xla", min_bucket=8)
    t = tpipe.compile_pipeline(tf, tens.EnsembleConfig(bias_cells=bias),
                               device="cpu", min_bucket=8, noise=noise)
    return j, t, lambda rng, b: pm1(rng, (b, sizes[0]))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_noiseless_shims_equal_reference_shims(kind):
    j, t, make = _nets(kind)
    x = make(np.random.default_rng(3), 13)
    jx = jnp.asarray(x)
    for name in ("votes", "predict", "cum_votes", "__call__"):
        want = getattr(j, name)(jx)
        got = getattr(t, name)(x)
        np.testing.assert_array_equal(i32(got), i32(want), err_msg=name)
    # votes_packed on each package's own packing of the same batch
    got = t.votes_packed(t._pack_input(torch.as_tensor(x)))
    want = j.votes_packed(j._pack_input(jx))
    np.testing.assert_array_equal(i32(got), i32(want))


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


KEYED = {
    # shim: (its arguments after x, the spec it stands for)
    "votes": (lambda g, k: dict(key=g), InferenceSpec(noise="batch")),
    "predict": (lambda g, k: dict(key=g),
                InferenceSpec(noise="batch", reduction="argmax")),
    "__call__": (lambda g, k: dict(key=g),
                 InferenceSpec(noise="batch", reduction="argmax")),
    "cum_votes": (lambda g, k: dict(key=g),
                  InferenceSpec(noise="batch", cumulative=True)),
    "votes_mc": (lambda g, k: dict(key=g, n_samples=3),
                 InferenceSpec(noise="batch", mc_samples=3)),
    "votes_each": (lambda g, k: dict(keys=k),
                   InferenceSpec(noise="per_request")),
    "votes_mc_each": (lambda g, k: dict(keys=k, n_samples=3),
                      InferenceSpec(noise="per_request", mc_samples=3)),
    "votes_mc_each_sum": (lambda g, k: dict(keys=k, n_samples=3),
                          InferenceSpec(noise="per_request", mc_samples=3,
                                        reduction="sum")),
    "predict_each": (lambda g, k: dict(keys=k),
                     InferenceSpec(noise="per_request", reduction="argmax")),
}


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_keyed_shims_equal_run(kind):
    _, t, make = _nets(kind, noise=SILICON)
    rng = np.random.default_rng(4)
    x = make(rng, 11)
    keys = rng.integers(0, 2 ** 32, (11, 2), dtype=np.uint64).astype(
        np.uint32)
    for name, (args, spec) in KEYED.items():
        kw = args(_gen(), keys)
        want = t.run(x, spec, key=_gen() if spec.needs_key else None,
                     keys=keys if spec.needs_keys else None)
        got = getattr(t, name)(x, **kw)
        assert torch.equal(got, want), name
    got = t.votes_packed(t._pack_input(torch.as_tensor(x)), key=_gen())
    assert torch.equal(got, t.run(x, InferenceSpec(noise="batch"),
                                  key=_gen()))


SHIMS = ["votes", "votes_packed", "votes_mc", "votes_each", "votes_mc_each",
         "votes_mc_each_sum", "predict_each", "cum_votes", "predict",
         "__call__", "warmup(entries=)"]


@pytest.mark.parametrize("name", SHIMS)
def test_each_shim_warns_once(name, monkeypatch):
    monkeypatch.setattr(tpipe, "_LEGACY_WARNED", set())
    _, t, make = _nets("mlp", noise=SILICON)
    x = make(np.random.default_rng(0), 3)
    keys = np.arange(6, dtype=np.uint32).reshape(3, 2)
    if name == "warmup(entries=)":
        call = lambda: t.warmup(8, entries=("votes",))  # noqa: E731
    elif name == "votes_packed":
        xp = t._pack_input(torch.as_tensor(x))
        call = lambda: t.votes_packed(xp)  # noqa: E731
    elif name in KEYED:
        args, _ = KEYED[name]
        call = lambda: getattr(t, name)(x, **args(_gen(), keys))  # noqa
    # __call__ warns as the predict shim it is sugar for
    warned = "predict" if name == "__call__" else name
    with pytest.warns(DeprecationWarning, match=rf"{warned.split('(')[0]}"):
        call()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        call()  # once per process


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_warmup_entries_map_as_legacy_entry_spec():
    _, t, _ = _nets("mlp", noise=SILICON)
    entries = tpipe.CompiledPipeline.WARMUP_ENTRIES
    assert entries == jpipe.CompiledPipeline.WARMUP_ENTRIES
    times = t.warmup(16, entries=entries, mc_samples=2)
    want = {legacy_entry_spec(e, 2 if e.startswith("votes_mc") else None)
            for e in entries}
    assert set(times) == {(s, b) for s in want for b in (8, 16)}
    with pytest.raises(ValueError, match="not both"):
        t.warmup(8, specs=(InferenceSpec(),), entries=("votes",))
    with pytest.raises(ValueError, match="unknown warmup entries"):
        t.warmup(8, entries=("predict",))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_cum_votes_needs_a_key_on_a_noise_compiled_pipeline():
    _, t, make = _nets("mlp", noise=SILICON)
    x = make(np.random.default_rng(1), 5)
    with pytest.raises(ValueError, match="needs an explicit key"):
        t.cum_votes(x)
    # the NOISELESS model is not noise: the exact staircase, as without
    _, tn, _ = _nets("mlp", noise=NOISELESS)
    _, t0, _ = _nets("mlp")
    assert torch.equal(tn.cum_votes(x), t0.cum_votes(x))
