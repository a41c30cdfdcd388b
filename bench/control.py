"""Readings that set a cell's limits: the number compared on sound runs of
the program over many seeds, and on runs whose timed call is the control
(the reference with one departure, `reference.bnn.CONTROLS`), all at the
cell's own sizes and load, in one process.

    python3 bench/control.py --workload <cell> --control <name> \
        --seeds 1 2 3 ... --control-seeds 101 102 103 [--seconds 2]

Prints one JSON line per run: {"workload", "side", "seed", "checks"}.
The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

if __name__ == "__main__":
    from pathlib import Path

    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

from bench import check, harness  # noqa: E402


def readings(workload: str, control: str, seeds, control_seeds,
             seconds: float):
    """Yield one record per run: the program's on `seeds`, then the
    control's on `control_seeds`."""
    cell = harness.find_cell(harness.load_benchmark(), workload)
    runs = [("program", s, None) for s in seeds]
    runs += [("control", s, lambda setup: check.control_call(setup, control))
             for s in control_seeds]
    for side, seed, substitute in runs:
        r = harness.run_cell(cell, seed, seconds, False,
                             t_process=time.perf_counter(),
                             substitute=substitute, log=lambda m: None)
        yield {"workload": workload, "side": side, "seed": seed,
               "control": control if substitute else None,
               "correct": r["correct"], "checks": r["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for rec in readings(args.workload, args.control, args.seeds,
                        args.control_seeds, args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
