"""The port's `compile_pipeline(...).run` against the JAX reference's:
votes, argmax and the noiseless cumulative staircase, bit-exact, on the
bank-configuration nets and the paper's MNIST/HG widths, at ragged batch
sizes that cross buckets."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (BANK_BIAS, BANK_NETS, PAPER_NETS, pm1,
                         random_folded)
from repro import pipeline as jpipe
from repro.core import ensemble as jens
from repro.spec import InferenceSpec as JSpec
from repro_torch import pipeline as tpipe
from repro_torch.core import ensemble as tens
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
    for kw in (dict(noise=object()), dict(donate=True)):
        with pytest.raises(NotImplementedError):
            tpipe.compile_pipeline(tf, cfg, device="cpu", **kw)
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
