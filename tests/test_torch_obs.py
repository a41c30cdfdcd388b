"""The port's span recorder (`repro_torch.obs`): off, a span is the shared
no-op and records nothing; on, parents, call ids and threads are kept,
the full buffer drops its oldest records and counts them, and
`CompiledPipeline.run`, the Table-I fit and the first load of a CUDA
library record the span tree that `PERF.md` section 3 lists."""

import ctypes
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.binarize import InputEncoding
from repro_torch.core.bnn import FoldedLayer, parity_adjust_c
from repro_torch.core.convnet import CNNConfig, ConvSpec, random_folded_cnn
from repro_torch.core.device_model import SILICON
from repro_torch.core.ensemble import EnsembleConfig
from repro_torch.kernels import _build
from repro_torch.pipeline import compile_pipeline
from repro_torch.spec import InferenceSpec

BIAS = 32
CNN = CNNConfig(side=12, encoding=InputEncoding("thermometer", 4),
                conv=(ConvSpec(3, 32, 2),), hidden=(16,), n_classes=4,
                bias_cells=BIAS)


@pytest.fixture
def recording():
    """Spans on for the test, the buffer empty before and after."""
    obs.take()
    obs.enable()
    try:
        yield
    finally:
        obs.disable()
        obs.take()


def _mlp(noise=None):
    rng = np.random.default_rng(0)
    sizes = (64, 32, 5)
    folded = [FoldedLayer(
        weights_pm1=rng.choice([-1, 1], (o, i)).astype(np.int8),
        c=parity_adjust_c(rng.integers(-8, 9, o), i, BIAS))
        for i, o in zip(sizes[:-1], sizes[1:])]
    return compile_pipeline(folded, EnsembleConfig(bias_cells=BIAS),
                            device="cpu", noise=noise, min_bucket=8)


def _cnn(noise=None):
    return compile_pipeline(random_folded_cnn(CNN, seed=1),
                            EnsembleConfig(bias_cells=BIAS), device="cpu",
                            noise=noise, image_side=CNN.side,
                            image_encoding=CNN.encoding, min_bucket=8)


def _rows(pipe, b):
    rng = np.random.default_rng(b)
    if pipe.conv is not None:
        return torch.from_numpy(rng.random((b, pipe.n_in), np.float32))
    return torch.from_numpy(
        rng.choice([-1.0, 1.0], (b, pipe.n_in)).astype(np.float32))


def _keys(b):
    return np.stack([np.zeros(b, np.uint32), np.arange(b, dtype=np.uint32)],
                    axis=1)


def _tree(records, root):
    """(name, [children's trees]) of the record `root`, children in the
    order they began."""
    kids = sorted((r for r in records if r.parent == root.id),
                  key=lambda r: r.start_ns)
    return (root.name, [_tree(records, k) for k in kids])


def test_off_a_span_is_the_shared_noop_and_records_nothing():
    obs.take()
    assert not obs.enabled()
    assert obs.span("run") is obs.NOOP
    assert obs.span("sampler") is obs.NOOP
    with obs.span("run") as s:
        obs.count(rows=1)
        assert s is obs.NOOP
    pipe = _mlp()
    pipe.run(_rows(pipe, 3), InferenceSpec())
    assert obs.take() == ([], 0)


def test_parents_call_ids_and_threads(recording):
    def work():
        with obs.span("run"):
            obs.count(rows=2)
            with obs.span("run.program"):
                with obs.span("sampler"):
                    pass
            obs.count(bucket=8)

    work()
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    records, dropped = obs.take()
    assert dropped == 0 and len(records) == 6
    by_thread = {}
    for r in records:
        by_thread.setdefault(r.thread, []).append(r)
    assert set(by_thread) == {threading.get_native_id(), t.native_id}
    for rs in by_thread.values():
        run, prog, samp = (next(r for r in rs if r.name == n)
                           for n in ("run", "run.program", "sampler"))
        assert run.parent is None and run.call == run.id
        assert prog.parent == run.id and samp.parent == prog.id
        assert prog.call == samp.call == run.id
        assert run.counts == {"rows": 2, "bucket": 8}
        assert run.start_ns <= prog.start_ns <= samp.start_ns
        assert samp.end_ns <= prog.end_ns <= run.end_ns
    assert len({r.id for r in records}) == 6


def test_a_full_buffer_drops_the_oldest_and_counts_them(recording):
    extra = 5
    for i in range(obs.CAPACITY + extra):
        with obs.span("s"):
            obs.count(i=i)
    records, dropped = obs.take()
    assert dropped == extra and len(records) == obs.CAPACITY
    assert [r.counts["i"] for r in records[:2]] == [extra, extra + 1]
    assert records[-1].counts["i"] == obs.CAPACITY + extra - 1
    assert obs.take() == ([], 0)  # take empties the buffer and the count


OFFLINE = ("run", [("run.pack", []), ("run.bucket", []),
                   ("run.program", [])])
KEYED = ("run", [("run.pack", []), ("run.bucket", []),
                 ("run.program", [("sampler", []), ("head_distances", [])])])


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("noise", ["off", "per_request"])
def test_run_records_the_span_tree(model, noise, recording):
    make = _mlp if model == "mlp" else _cnn
    pipe = make(SILICON if noise == "per_request" else None)
    compiled, _ = obs.take()
    fit = [("physics.fit", [])] if noise == "per_request" else []
    assert [_tree(compiled, r) for r in compiled if r.parent is None] == fit
    spec = InferenceSpec(noise=noise)
    keys = _keys(5) if spec.needs_keys else None
    pipe.run(_rows(pipe, 5), spec, keys=keys)
    records, dropped = obs.take()
    assert dropped == 0
    (run,) = [r for r in records if r.parent is None]
    assert _tree(records, run) == (KEYED if spec.needs_keys else OFFLINE)
    assert run.counts == {"rows": 5, "bucket": 8}
    assert {r.call for r in records} == {run.id}
    assert {r.thread for r in records} == {threading.get_native_id()}
    assert any(r.name == "sampler" for r in records) == spec.needs_keys


def test_run_packed_and_batch_draws_open_one_run_span(recording):
    pipe = _mlp(SILICON)
    obs.take()
    x = _rows(pipe, 3)
    pipe.run_packed(pipe._pack_input(x), InferenceSpec(noise="per_request"),
                    keys=_keys(3))
    gen = torch.Generator().manual_seed(0)
    pipe.run(x, InferenceSpec(noise="batch"), key=gen)
    records, _ = obs.take()
    roots = [r for r in records if r.parent is None]
    assert [_tree(records, r) for r in roots] == [
        ("run", [("run.bucket", []),
                 ("run.program", [("sampler", []), ("head_distances", [])])]),
        ("run", [("run.pack", []), ("run.bucket", []),
                 ("run.program", [("sampler", [])])])]


def test_a_rejected_call_still_closes_its_spans(recording):
    pipe = _mlp()
    obs.take()
    with pytest.raises(ValueError, match="deterministic"):
        pipe.run(_rows(pipe, 3), InferenceSpec(), keys=_keys(3))
    records, _ = obs.take()
    assert [r.name for r in records] == ["run.pack", "run.bucket", "run"]


def test_the_first_load_of_a_library_records_kernels_load(monkeypatch,
                                                          recording):
    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", lambda: {"fused_mlp": "log"})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    lib = _build.library("fused_mlp")
    assert _build.library("fused_mlp") is lib  # a hit records nothing
    records, _ = obs.take()
    assert [(r.name, r.counts) for r in records] == [
        ("kernels.load", {"built": 1})]


def test_the_profiler_clock_is_the_wall_clock():
    import time

    off = obs.profiler_offset_ns()
    t = time.perf_counter_ns()
    assert obs.on_profiler_clock(t, off) == pytest.approx(time.time(),
                                                          abs=0.05)
