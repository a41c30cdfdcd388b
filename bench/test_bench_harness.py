"""The harness on the CPU: control flow end to end at a tiny size, the
refusals (no card, no program beside the benchmark's files, JAX loaded),
a cell and a metric added as data alone, and the faults and controls
that `correct` has to catch.  The CPU runs write no timing and no device
metric; the measurement path refuses to run without a card."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from bench import check, harness
from bench import trace as tracing

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _tiny(name: str, root: Path = ROOT) -> harness.Cell:
    cell = harness.find_cell(harness.load_benchmark(root), name, root)
    batch = 8 if cell.cfg["model"] == "cnn" else 64
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, batch=batch, pool_batches=2, check_batches=3))


def _python(code: str, cwd: Path, env_extra=None, timeout=600):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _rehearse(root: Path, name: str, trace: int) -> dict:
    """A CPU run of a shrunk cell in a fresh process (no JAX there)."""
    code = textwrap.dedent(f"""
        import dataclasses, json, sys, time
        t0 = time.perf_counter()
        sys.path[0:0] = [{str(root)!r}, {str(SRC)!r}]
        from bench import harness
        root = harness.Path({str(root)!r})
        cell = harness.find_cell(harness.load_benchmark(root), {name!r}, root)
        batch = 8 if cell.cfg["model"] == "cnn" else 64
        cell = dataclasses.replace(cell, traffic=dict(
            cell.traffic, batch=batch, pool_batches=2, check_batches=3))
        r = harness.run_cell(cell, 2**31 + 99, 0.3, bool({trace}),
                             t_process=t0, device="cpu", root=root)
        print(json.dumps(r))
    """)
    out = _python(code, root)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cpu_rehearsal_runs_a_cell_end_to_end():
    r = _rehearse(ROOT, "hg_mlp.silicon_keyed", 1)
    assert r["correct"] is True
    assert r["device"]["platform"] == "cpu"
    assert r["metrics"] == {}  # no timing, no device metric off the card
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["calls_compared"]["value"] >= 1


def test_measurement_refuses_without_a_card():
    out = _python(
        "import runpy, sys; sys.argv = ['bench/run.py', '--workload', "
        "'hg_mlp.offline_votes', '--seed', '3', '--seconds', '1', "
        "'--trace', '0']; runpy.run_path('bench/run.py', "
        "run_name='__main__')", ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "refused" in out.stderr


def test_refuses_where_only_the_benchmark_is(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "hg_mlp.offline_votes", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path[0:0] = [{str(ROOT)!r}, {str(SRC)!r}]
        import bench.reference.bnn
        assert "repro_torch" not in sys.modules, "the reference imports the program"
        import bench
        for m in pkgutil.walk_packages(bench.__path__, "bench."):
            if not m.name.split(".")[-1].startswith("test_"):
                importlib.import_module(m.name)
        from bench import harness
        for path in sorted((harness.ROOT / "bench" / "metrics").glob("*.py")):
            harness.load_metric(path.stem).read
        import repro_torch.pipeline
        bad = harness.forbidden_modules()
        assert not bad, bad
        assert "repro_torch" in sys.modules and "repro" not in sys.modules
        print("CLEAN")
    """)
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "CLEAN" in out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "repro_torch_like" not in harness.forbidden_modules()
    assert "jaxtyping" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()


def test_a_cell_and_a_metric_are_added_as_data(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "hg_mlp.tiny_votes", "config": "hg_mlp",
        "traffic": "tiny_votes", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "loop.calls_completed", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "pipeline glue",
        "moves": "inf_per_s", "workloads": ["hg_mlp.tiny_votes"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads(
        (ROOT / "bench/workloads/hg_mlp.offline_votes.json").read_text())
    traffic.update(batch=32, pool_batches=3)
    (tmp_path / "bench/workloads/hg_mlp.tiny_votes.json").write_text(
        json.dumps(traffic))
    (tmp_path / "bench/metrics/loop.calls_completed.py").write_text(
        "def read(ctx):\n    return ctx.window.completed\n")
    r = _rehearse(tmp_path, "hg_mlp.tiny_votes", 1)
    assert r["correct"] is True
    assert r["metrics"]["loop.calls_completed"]["value"] >= 1
    for f in (ROOT / "bench").glob("*.py"):  # no code was edited
        assert (tmp_path / "bench" / f.name).read_bytes() == f.read_bytes()


def _run_on_cpu(name, substitute, monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    return harness.run_cell(_tiny(name), 7, 0.2, False,
                            t_process=time.perf_counter(), device="cpu",
                            substitute=substitute, log=lambda m: None)


def test_a_run_with_jax_loaded_reports_nothing(monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jax"])
    with pytest.raises(RuntimeError, match="jax"):
        harness.run_cell(_tiny("hg_mlp.offline_votes"), 7, 0.1, False,
                         t_process=time.perf_counter(), device="cpu",
                         log=lambda m: None)


def _answer_altered(setup):
    run = harness.program_call(setup)

    def call(rows, keys):
        votes = run(rows, keys).clone()
        votes[3, 1] += 1
        return votes
    return call


def _half_batch_left_out(setup):
    run = harness.program_call(setup)

    def call(rows, keys):
        half = rows.shape[0] // 2
        votes = torch.zeros((rows.shape[0], setup.pipe.n_classes),
                            dtype=torch.int32)
        votes[:half] = run(rows[:half], None if keys is None
                           else keys[:half])
        return votes
    return call


@pytest.mark.parametrize("name", ["hg_mlp.offline_votes",
                                  "hg_mlp.silicon_keyed"])
def test_sound_run_is_correct(name, monkeypatch):
    r = _run_on_cpu(name, None, monkeypatch)
    assert r["correct"] is True
    assert r["checks"]["vote_cells_differing"]["value"] == 0


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch_left_out])
@pytest.mark.parametrize("name", ["hg_mlp.offline_votes",
                                  "hg_mlp.silicon_keyed"])
def test_faults_make_the_run_incorrect(name, fault, monkeypatch):
    r = _run_on_cpu(name, fault, monkeypatch)
    assert r["correct"] is False
    assert r["checks"]["vote_cells_differing"]["value"] > 0


@pytest.mark.parametrize("name,control", [
    ("hg_cnn.offline_votes", "bf16_inputs"),
    ("hg_mlp.offline_votes", "half_bias_cells")])
def test_controls_make_the_run_incorrect(name, control, monkeypatch):
    r = _run_on_cpu(name, lambda s: check.control_call(s, control),
                    monkeypatch)
    assert r["correct"] is False


def test_layer_ops_count_where_the_host_launched_them():
    # device ops (name, start, end, correlation); launches {corr: host t}
    ops = [("pack_a", 1.0, 1.5, 1), ("pack_b", 1.5, 1.75, 2),
           ("k3", 2.0, 3.0, 3), ("copy", 3.0, 3.1, 4), ("lost", 3.1, 3.2, 9)]
    launches = {1: 0.10, 2: 0.12, 3: 0.30, 4: 0.40}
    host = [("pipeline.run", 0.05, 0.35), ("copy", 0.35, 0.45)]
    layers = [("pack", 0.09, 0.2)]
    p = tracing.reduce(ops, host, 1, launches, layers)
    assert p.layer("pack") == (0.75, 2)
    assert p.layer("sampler") == (0.0, 0)
    assert p.ops_matched == 4
    assert p.busy_s == pytest.approx(1.95) and p.window_s == pytest.approx(2.2)


@pytest.mark.parametrize("name", ["hg_mlp.silicon_keyed",
                                  "hg_cnn.silicon_keyed"])
def test_layer_spans_wrap_the_timed_calls_and_restore_them(name):
    cell = _tiny(name)
    setup = harness.make_setup(cell, 11, "cpu", lambda m: None)
    readers = {m["name"]: harness.load_metric(m["name"])
               for m in cell.per_layer}
    hooks = [h for mod in readers.values()
             if (h := getattr(mod, "wrap", lambda s: None)(setup))]
    assert sorted(h[0] for h in hooks) == ["pack", "sampler"]
    before = {h[0]: getattr(h[1], h[2]) for h in hooks}
    record = []
    call = harness.program_call(setup)
    with tracing.layer_spans(hooks, record):
        votes = call(setup.rows[0], setup.keys[0])
    assert [r[0] for r in record] == ["pack", "sampler"]
    assert all(s <= e for _, s, e in record)
    for span, owner, attr in hooks:  # the program's own calls again
        assert attr not in vars(owner)
        assert getattr(owner, attr) == before[span]
    assert torch.equal(votes, call(setup.rows[0], setup.keys[0]))


def test_offline_cells_wrap_no_sampler():
    cell = _tiny("hg_cnn.offline_votes")
    setup = harness.make_setup(cell, 12, "cpu", lambda m: None)
    mod = harness.load_metric("sampler.device_ms")
    assert mod.wrap(setup) is None


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cell_size(card, name):
    """On the card at the cell's own batch and load: the cell's control
    (its workload file's `control`) comes out not correct.  The window is
    long enough for the control, slower than the program, to send as
    many calls as a run checks."""
    cell = harness.find_cell(harness.load_benchmark(), name)
    out = subprocess.run(
        [sys.executable, "bench/control.py", "--workload", name,
         "--control", cell.traffic["control"], "--control-seeds",
         str(2**31 + 5), "--seconds", "14"], cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["side"] == "control" and rec["correct"] is False
