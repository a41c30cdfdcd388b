"""What the port's spans (`repro_torch.obs`) cost, and how they split set-up.

    python scripts/torch_obs_cost.py --workload hg_mlp.silicon_keyed \
        --seed 2147483731 [--seconds 10] [--rounds 2]

One process, one benchmark cell (`BENCHMARK.json`) at its own size, on
`cuda:0`.  Spans are on from the process's start through the cell's
set-up (weights, `compile_pipeline`, the two warm calls, as
`bench/harness.py` makes them), so the set-up spans are read:
`kernels.load` (and how many libraries nvcc built), `physics.fit`, and
the process's first `run` less the `kernels.load` spans inside it.  Then
`--rounds` pairs of windows of the cell's closed loop (`bench/loop.py`),
spans off then on, each `--seconds` long: inf/s in each, and the spans a
call and the records dropped with spans on.  Last, ns a span off and on
(an empty `with obs.span(...)` on the host, best of five).  Prints the
card's name and power limit, then one line `OBS-COST {...}`.

A stopgap: it repeats `bench/harness.py`'s set-up and loop, and goes once
the harness reads the set-up spans itself (ROADMAP Queue 3 item 1).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def _setup_spans(records) -> dict:
    """Seconds of each set-up span, summed by name; `first_run_s`: the
    first `run` less the `kernels.load` spans inside it."""
    out: dict = {}
    for r in records:
        key = f"{r.name}_s"
        out[key] = out.get(key, 0.0) + (r.end_ns - r.start_ns) / 1e9
    out["built"] = sum(r.counts.get("built", 0) for r in records
                       if r.name == "kernels.load")
    runs = [r for r in records if r.name == "run"]
    if runs:
        first = min(runs, key=lambda r: r.start_ns)
        loads = sum(r.end_ns - r.start_ns for r in records
                    if r.name == "kernels.load" and r.call == first.id)
        out["first_run_s"] = (first.end_ns - first.start_ns - loads) / 1e9
        out["runs_s"] = [(r.end_ns - r.start_ns) / 1e9 for r in runs]
    return {k: v for k, v in out.items() if k != "run_s"}


def _ns_a_span(obs, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with obs.span("x"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
        obs.take()
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    from repro_torch import obs

    obs.enable()
    import torch

    from bench import harness, loop

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    setup = harness.make_setup(cell, args.seed, "cuda:0",
                               lambda m: print(m, file=sys.stderr))
    t = cell.traffic
    n_classes = setup.pipe.n_classes
    the_loop = loop.ClosedLoop(
        harness.program_call(setup), setup.rows, setup.keys, t["in_flight"],
        n_classes, loop.Spans(enabled=False),
        loop.Reservoir(0, 0, (setup.rows.shape[1], n_classes),
                       setup.device))
    for i in range(t["in_flight"]):
        harness.program_call(setup)(*the_loop.inputs(i))
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_PROCESS
    obs.disable()
    records, dropped = obs.take()
    result = {"workload": args.workload, "seed": args.seed,
              "setup_s": setup_s, "setup_dropped": dropped,
              "setup": _setup_spans(records), "off": [], "on": [],
              "spans_a_call": [], "dropped_on": []}
    b = setup.rows.shape[1]
    for _ in range(args.rounds):
        for side in ("off", "on"):
            if side == "on":
                obs.enable()
            stats = the_loop.run(seconds=args.seconds)
            obs.disable()
            records, dropped = obs.take()
            result[side].append(stats.in_window * b / stats.seconds)
            if side == "on":
                result["spans_a_call"].append(
                    len(records) / max(stats.completed, 1))
                result["dropped_on"].append(dropped)
    result["ns_a_span_off"] = _ns_a_span(obs, 1_000_000)
    obs.enable()
    result["ns_a_span_on"] = _ns_a_span(obs, 50_000)
    obs.disable()
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print("OBS-COST " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
