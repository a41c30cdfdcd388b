"""The readers of the program's own spans (`bench/program_trace.py`) on the
CPU: each device operation counts for the innermost program span open on
the loop's thread at its launch, idle gaps carry the loop's span and the program's,
without program spans the gaps are `trace.reduce`'s, every reader gives
None where its span is absent or the program has none, and a CPU run of
the harness never turns the program's spans on."""

import dataclasses
import sys
import time
import types

import pytest

from bench import harness, program_trace
from bench import trace as tracing

READERS = ("program.pack_device_ms", "program.sampler_device_ms",
           "program.head_distances_device_ms")
MAIN = 7

# one call: the loop's spans, the program's spans (name, start, end, id,
# parent, native thread id), device operations (name, start, end,
# correlation id) and their launch times {correlation id: t}.  The
# profiler numbers threads itself, so launches carry no thread; a span of
# another thread (id 6) is not the loop's and is left out.
HOST = [("pipeline.run", 0.05, 0.35), ("wait", 0.35, 0.5)]
SPANS = [("run", 0.05, 0.35, 1, None, MAIN),
         ("run.pack", 0.06, 0.10, 2, 1, MAIN),
         ("run.program", 0.15, 0.34, 3, 1, MAIN),
         ("sampler", 0.16, 0.20, 4, 3, MAIN),
         ("head_distances", 0.21, 0.30, 5, 3, MAIN),
         ("sampler", 0.06, 0.09, 6, None, MAIN + 1)]
OPS = [("pack_x", 0.08, 0.12, 1), ("threefry", 0.17, 0.19, 2),
       ("glue", 0.206, 0.208, 3), ("void binary_gemm_hd_tile", 0.25, 0.28, 4),
       ("void picbnn::mlp_votes_kernel", 0.41, 0.42, 5),
       ("lost", 0.42, 0.43, 9)]
LAUNCHES = {1: 0.07, 2: 0.165, 3: 0.205, 4: 0.25, 5: 0.40}


def test_operations_count_for_the_innermost_program_span():
    p = program_trace.reduce(OPS, HOST, 2, LAUNCHES, SPANS, MAIN)
    assert p.span_launches == {"run.pack": 1, "sampler": 1,
                               "run.program": 1, "head_distances": 1}
    assert p.span_s["run.pack"] == pytest.approx(0.04)
    assert p.span_s["run.program"] == pytest.approx(0.002)
    assert p.matched == 5
    assert (p.kernels, p.kernels_in_run) == (2, 1)
    assert p.device_ms("head_distances") == pytest.approx(15.0)
    assert p.device_ms("run") is None  # no operation had it innermost


def test_gaps_carry_the_loop_span_and_the_program_span():
    p = program_trace.reduce(OPS, HOST, 1, LAUNCHES, SPANS, MAIN)
    names = [n for n, _ in p.gaps]
    assert names == ["bench.pipeline.run/head_distances", "bench.wait",
                     "bench.pipeline.run/run",
                     "bench.pipeline.run/run.program",
                     "bench.pipeline.run/sampler"]
    assert [s for _, s in p.gaps] == pytest.approx(
        [0.13, 0.07, 0.05, 0.042, 0.016])


def test_without_program_spans_the_gaps_are_trace_reduces():
    p = program_trace.reduce(OPS, HOST, 1, LAUNCHES, [], MAIN)
    ref = tracing.reduce(OPS, HOST, 1, LAUNCHES)
    assert p.gaps == ref.gaps
    assert p.span_s == {} and p.kernels_in_run == 0 and p.kernels == 2


def _program(**span_s):
    return program_trace.Program(
        calls=2, span_s=span_s, span_launches={k: 1 for k in span_s},
        gaps=[], matched=0, kernels=0, kernels_in_run=0)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_where_their_span_is_absent(name, monkeypatch):
    mod = harness.load_metric(name)
    assert mod.read(types.SimpleNamespace(profile=None)) is None  # no card
    ctx = types.SimpleNamespace(profile=object())
    monkeypatch.setattr(program_trace, "profile", lambda c: _program())
    assert mod.read(ctx) is None
    spans = {"run.pack": 0.004, "sampler": 0.006, "head_distances": 0.008}
    monkeypatch.setattr(program_trace, "profile",
                        lambda c: _program(**spans))
    assert mod.read(ctx) in {1e3 * s / 2 for s in spans.values()}


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs", raising=False)

    def stretch(ctx, obs):
        raise AssertionError("traced a program with no spans")

    monkeypatch.setattr(program_trace, "_stretch", stretch)
    assert program_trace.profile(types.SimpleNamespace(profile=object())) \
        is None


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cpu_run_never_turns_the_program_spans_on(trace, monkeypatch):
    from repro_torch import obs

    def enable():
        raise AssertionError("spans turned on")

    monkeypatch.setattr(obs, "enable", enable)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    cell = harness.find_cell(harness.load_benchmark(), "hg_mlp.silicon_keyed")
    cell = dataclasses.replace(cell, traffic=dict(
        cell.traffic, batch=64, pool_batches=2, check_batches=3))
    obs.take()
    r = harness.run_cell(cell, 2**31 + 7, 0.2, bool(trace),
                         t_process=time.perf_counter(), device="cpu",
                         log=lambda m: None)
    assert r["correct"] is True
    assert not obs.enabled()
    assert obs.take() == ([], 0)
