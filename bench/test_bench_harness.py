"""The harness on the CPU: control flow end to end at a tiny size, the
refusals (no card, no program beside the benchmark's files, JAX loaded),
a cell and a metric added as data alone, a model kind added as files
alone, the draws pinned to a seed, and the faults and controls that
`correct` has to catch.  The CPU runs write no timing and no device
metric; the measurement path refuses to run without a card."""

import dataclasses
import hashlib
import json
import os
import re
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


TINY_KIND = '''\
"""A throwaway kind: greedy next tokens of a bigram model in plain torch."""

import torch

from bench import roofline


def make(cfg, traffic, gen, device, log):
    v, d = cfg["vocab"], cfg["width"]
    emb = torch.randn((v, d), generator=gen, device=gen.device)
    out = torch.randn((d, v), generator=gen, device=gen.device)
    rows = torch.randint(0, v, (traffic["pool_batches"], traffic["batch"],
                                traffic["seq"]),
                         generator=gen, device=gen.device)
    return dict(net={"emb": emb.cpu(), "out": out.cpu()}, rows=rows,
                keys=None, noise=None, spec=None, pipe=(emb, out))


def call(setup):
    emb, out = setup.pipe
    return lambda tokens, keys: (emb[tokens] @ out).argmax(-1)


def output(setup):
    return tuple(setup.rows.shape[1:]), torch.int64


def units(setup):
    return setup.rows.shape[1] * setup.rows.shape[2]


def _reference(setup, tokens, dtype):
    emb, out = setup.net["emb"].to(dtype), setup.net["out"].to(dtype)
    return (emb[tokens.cpu()] @ out).argmax(-1)


def compare(setup, kept):
    differing = sum(
        int((got != _reference(setup, setup.rows[rb], torch.float32)).sum())
        for _, (rb, _), got in kept)
    return {"tokens_differing": {
        "value": differing,
        "limit": setup.traffic["limits"]["tokens_differing"], "rule": "<="}}


def control_call(setup, control):
    return lambda tokens, keys: _reference(setup, tokens, torch.bfloat16)


def step_work(setup):
    b, s = setup.rows.shape[1:]
    v, d = setup.cfg["vocab"], setup.cfg["width"]
    return roofline.Work(16 * b * s + 8 * v * d, 0, 2 * b * s * d * v)
'''


def test_a_kind_is_added_as_files(tmp_path):
    """A configuration of a new kind, its cell and a counter of its units,
    each a file of its own: the harness runs them with no file of its
    edited."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny", "source": "https://example.org/tiny",
        "file": "bench/configs/tiny.json", "reduced": [],
        "why": "a throwaway configuration"})
    bench["workloads"].append({
        "name": "tiny.greedy", "config": "tiny", "traffic": "greedy",
        "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "loop.units_completed", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "pipeline glue",
        "moves": "inf_per_s", "workloads": ["tiny.greedy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "bench/configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "model": "tiny_tokens", "vocab": 64, "width": 16}))
    (tmp_path / "bench/workloads/tiny.greedy.json").write_text(json.dumps(
        {"batch": 4, "seq": 8, "in_flight": 2, "pool_batches": 3,
         "check_batches": 2, "limits": {"tokens_differing": 0}}))
    (tmp_path / "bench/kinds/tiny_tokens.py").write_text(TINY_KIND)
    (tmp_path / "bench/metrics/loop.units_completed.py").write_text(
        "def read(ctx):\n    return ctx.window.completed * ctx.units\n")

    r = _rehearse(tmp_path, "tiny.greedy", 1)
    per_call = 64 * 8  # the rehearsal's batch of 64, 8 tokens a row
    assert r["correct"] is True
    assert r["checks"]["tokens_differing"]["value"] == 0
    assert r["checks"]["calls_compared"]["value"] >= 1
    completed = r["metrics"]["loop.units_completed"]["value"]
    assert completed >= per_call and completed % per_call == 0
    assert r["attempted"] >= completed and r["attempted"] % per_call == 0
    assert r["failed"] == r["attempted"] - completed

    cell = harness.find_cell(harness.load_benchmark(tmp_path), "tiny.greedy",
                             tmp_path)
    setup = harness.make_setup(cell, 5, "cpu", lambda m: None)
    w = setup.kind.step_work(setup)
    assert w.flops == 2 * 4 * 8 * 16 * 64
    assert w.bound_s() == max(w.nbytes / 3.35e12, w.flops / 989.5e12)
    rows = setup.rows[0]
    assert not torch.equal(harness.program_call(setup)(rows, None),
                           check.control_call(setup, "bf16")(rows, None))

    mine = sorted(p.relative_to(ROOT) for p in (ROOT / "bench").rglob("*.py")
                  if "__pycache__" not in p.parts)
    assert mine
    for rel in mine:  # no code of the benchmark was edited
        assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel


def test_the_harness_names_no_kind():
    word = re.compile(r"\b(mlp|cnn|n_classes|InferenceSpec)\b", re.I)
    for name in ("harness.py", "loop.py", "check.py", "trace.py",
                 "program_trace.py"):
        text = (ROOT / "bench" / name).read_text()
        assert not word.findall(text), name


def test_every_kind_loads_without_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path[0:0] = [{str(ROOT)!r}, {str(SRC)!r}]
        from bench import harness
        kinds = sorted((harness.ROOT / "bench" / "kinds").glob("*.py"))
        for path in kinds:
            kind = harness.load_kind(path.stem)
            for fn in ("make", "call", "output", "units", "compare",
                       "control_call", "step_work"):
                assert callable(getattr(kind, fn)), (path.stem, fn)
        bad = harness.forbidden_modules()
        assert not bad, bad
        print("KINDS", " ".join(p.stem for p in kinds))
    """)
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    kinds = out.stdout.split("KINDS", 1)[1].split()
    assert {"cnn", "mlp"} <= set(kinds)


# sha256 (first 16 hex digits) of the weights, the row pool and the key
# words that `make_setup` draws at seed 2**31 + 23, a batch of 16, 2 row
# and 3 key batches, on the CPU: recorded with the harness as it was
# before the kinds moved out of it (`make_setup` drawing through
# `bench/model.py` itself)
DRAWS = {
    "hg_mlp.offline_votes": ("5ee3ad1b11c967bf", "fa17f3f477470269", None),
    "hg_cnn.offline_votes": ("1594e9bac50079d2", "4885c0e22288d27e", None),
    "hg_mlp.silicon_keyed": ("5ee3ad1b11c967bf", "fa17f3f477470269",
                             "ff8359f004031f4e"),
    "hg_cnn.silicon_keyed": ("1594e9bac50079d2", "4885c0e22288d27e",
                             "02d419ec756d5bf3"),
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_the_draws_from_a_seed_are_pinned(name):
    """The same seed draws the same weights, rows and keys as the harness
    did before the model kinds moved out of it."""
    cell = harness.find_cell(harness.load_benchmark(), name)
    cell = dataclasses.replace(cell, traffic=dict(
        cell.traffic, batch=16, pool_batches=2, key_batches=3))
    setup = harness.make_setup(cell, 2**31 + 23, "cpu", lambda m: None)
    net = _digest(t for part in ("conv", "fc") for layer in setup.net[part]
                  for t in (layer["w"], layer["c"]))
    keys = None if setup.keys is None else _digest([setup.keys])
    assert (net, _digest([setup.rows]), keys) == DRAWS[name]
