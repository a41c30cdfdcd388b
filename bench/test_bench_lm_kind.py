"""The "lm" kind (`kinds/lm.py`) on the CPU: it loads without JAX; the
cell `lfm2_8b_a1b.prefill_2k`'s control flow end to end on a tiny copy
of its configuration (the program's `+smoke` size) in a directory of its
own, sound and with each control in the program's place; and
`lm_roofline`'s bounds at the cell's shapes pinned."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from bench import check, harness, lm_roofline

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELL = "lfm2_8b_a1b.prefill_2k"
# the `+smoke` size of repro_torch/configs/lfm2_8b_a1b.py, under the
# configuration file's keys
TINY = dict(arch="lfm2-8b-a1b+binary-ffn+smoke", hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, moe_intermediate_size=48, num_experts=8,
            vocab_size=256, num_hidden_layers=6,
            layer_types=["conv", "conv", "full_attention", "conv", "conv",
                         "full_attention"])


def _tiny_copy(root: Path) -> Path:
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    conf = root / "bench/configs/lfm2_8b_a1b.json"
    conf.write_text(json.dumps(json.loads(conf.read_text()) | TINY))
    traffic = root / f"bench/workloads/{CELL}.json"
    traffic.write_text(json.dumps(json.loads(traffic.read_text())
                                  | dict(batch=2, seq=16, pool_batches=3)))
    return root


def test_the_lm_kind_loads_without_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path[0:0] = [{str(ROOT)!r}, {str(SRC)!r}]
        from bench import harness
        kind = harness.load_kind("lm")
        cell = harness.find_cell(harness.load_benchmark(), {CELL!r})
        assert cell.kind.__name__ == kind.__name__
        import bench.reference.lfm2
        assert "repro_torch" not in sys.modules, "the reference imports it"
        import repro_torch.models.model
        bad = harness.forbidden_modules()
        assert not bad, bad
        print("CLEAN")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "CLEAN" in out.stdout


def test_the_cell_rehearses_on_a_tiny_copy(tmp_path):
    root = _tiny_copy(tmp_path)
    code = textwrap.dedent(f"""
        import json, sys, time
        t0 = time.perf_counter()
        sys.path[0:0] = [{str(root)!r}, {str(SRC)!r}]
        from bench import harness
        root = harness.Path({str(root)!r})
        cell = harness.find_cell(harness.load_benchmark(root), {CELL!r},
                                 root)
        r = harness.run_cell(cell, 2**31 + 99, 0.3, True, t_process=t0,
                             device="cpu", root=root)
        print(json.dumps(r))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    checks = r["checks"]
    assert checks["calls_compared"]["value"] >= 1
    assert checks["replay_logit_diff"]["value"] == 0
    for part in ("operator", "dense_ffn", "moe", "head"):
        assert checks[f"{part}_rel_err_max"]["value"] < 1e-4, part
    assert r["attempted"] > 0 and r["attempted"] % (2 * 16) == 0
    assert r["failed"] == 0 and r["metrics"] == {}


# the checks each control fails: a routing fault in the MoE layers
# alone, float8 activations everywhere
FAILS = {"no_expert_bias": ("moe",), "capacity_1.25": ("moe",),
         "fp8_activations": ("operator", "dense_ffn", "moe", "head")}
PARTS = ("operator", "dense_ffn", "moe", "head")


@pytest.mark.parametrize("control", sorted(FAILS))
def test_each_control_fails_the_tiny_cell(tmp_path, monkeypatch, control):
    """The tiny copy runs the program in float32, where it reads below
    1e-6 on every layer, so its limits are the CPU tests' float32
    tolerance (the cell's own, set for bfloat16 at the published widths,
    are held on the card: `test_control_fails_at_the_cell_size`).  Each
    control fails its checks by 100 times that; the routing controls
    leave every operator, the dense FFNs and the head exact."""
    root = _tiny_copy(tmp_path)
    cell = harness.find_cell(harness.load_benchmark(root), CELL, root)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    for part in PARTS:
        cell.traffic["limits"][f"{part}_rel_err_max"] = 1e-4
    r = harness.run_cell(cell, 2**31 + 5, 0.2, False,
                         t_process=time.perf_counter(), device="cpu",
                         root=root, log=lambda m: None,
                         substitute=lambda s: check.control_call(s, control))
    checks = r["checks"]
    assert r["correct"] is False
    assert checks["replay_logit_diff"]["value"] == 0
    for part in PARTS:
        value = checks[f"{part}_rel_err_max"]["value"]
        if part in FAILS[control]:
            assert value > 1e-2, part
        else:
            assert value < 1e-5, part


def test_the_cells_limits_sit_between_the_program_and_the_controls():
    """The workload's limits and control, as `PERF.md` section 4 sets
    them from the card's readings: the replay equal bit for bit, every
    layer limit above the program's bfloat16 readings and below the
    float8 activations', the MoE's below both routing controls'."""
    limits = harness.find_cell(harness.load_benchmark(), CELL).traffic
    assert limits["control"] == "no_expert_bias"
    got = limits["limits"]
    assert got["replay_logit_diff"] == 0
    # (the program's largest reading, the nearest fault's smallest: float8
    # activations, for the MoE capacity 1.25) on the card, PERF.md
    # section 4; each limit with room on both sides
    readings = {"operator": (0.0645, 0.5409), "dense_ffn": (0.0233, 0.3443),
                "moe": (0.1490, 0.5028), "head": (0.00245, 0.0358)}
    for part, (sound, fault) in readings.items():
        limit = got[f"{part}_rel_err_max"]
        assert 1.5 * sound < limit < fault / 1.5, part


# (prompts a call, tokens a prompt): bytes, bit-MACs, FLOPs of
# `lm_roofline.step`, and the grouped launches' bound in seconds
PINNED = {
    (4, 2048): (1990557952, 8658654068736, 6417620664320,
                0.005240375937910448),
    (2, 2048): (1990000896, 4329327034368, 3208810332160,
                0.0027647975546268655),
}


def test_the_bounds_at_the_cells_shapes_are_pinned():
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    assert (cell.traffic["batch"], cell.traffic["seq"]) in PINNED
    for (b, s), (nbytes, bitops, flops, grouped) in PINNED.items():
        w = lm_roofline.step(cell.cfg, b, s)
        assert (w.nbytes, w.bitops, w.flops) == (nbytes, bitops, flops)
        assert w.bound_by() == "flops"
        assert lm_roofline.grouped_bound_s(cell.cfg, b, s) == \
            pytest.approx(grouped, rel=1e-12)
        launches = lm_roofline.grouped_launches(cell.cfg, b, s)
        assert len(launches) == 44  # gate and up share one a layer
        assert {x.bound_by() for x in launches} == {"bytes"}
