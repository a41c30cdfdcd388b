"""The port's dry-run over every (architecture x shape x mesh) cell.

    PYTHONPATH=src python scripts/torch_dryrun_sweep.py [--workers 8]
        [--out results/torch/dryrun]

Runs `python -m repro_torch.launch.dryrun --arch A --shape all
[--multi-pod] --out OUT` once for every architecture and production mesh,
each in a subprocess of its own (the fake group needs a process of its
own), `--workers` at a time, and prints each one's output as it ends,
with its wall seconds.  The Mamba scan's chunks are traced once and
charged once per trip (`models.scan.scan_chunks`), so every cell is
traced.  Prints last the count of cells by status, how many of the ok
cells of each shape fit one 80 GB card, and the longest trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIT_GIB = 80e9 / 2**30  # one H100's 80 GB (74.5 GiB)
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch.dryrun import cell_id  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "results" / "torch"
                                         / "dryrun"))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    jobs, cells = [], []
    for arch in configs.list_archs():
        for mp in (False, True):
            jobs.append([sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--shape", "all",
                         "--out", str(out)] + (["--multi-pod"] if mp else []))
            cells += [cell_id(arch, n, mp) for n in SHAPES]

    def run(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True)
        return p, time.perf_counter() - t0

    with ThreadPoolExecutor(args.workers) as pool:
        for cmd, (p, secs) in zip(jobs, pool.map(run, jobs)):
            print(f"[sweep] {' '.join(cmd[3:])}: {secs:.1f} s", flush=True)
            print(p.stdout, flush=True)
            if p.returncode:
                print(p.stderr[-2000:], flush=True)
    summarize(out, cells)


def summarize(out: Path, cells: list) -> dict:
    """Count the records of `cells` in `out` by status, the ok cells that
    fit one 80 GB card (peak_estimate_gib <= FIT_GIB) by shape, and name
    the longest trace; print it as one "SWEEP" line and return it."""
    recs = {}
    for cid in cells:
        path = out / f"{cid}.json"
        recs[cid] = json.loads(path.read_text()) if path.exists() \
            else {"status": "missing"}
    counts: dict[str, int] = {}
    fit: dict[str, list] = {}
    for r in recs.values():
        counts[r["status"]] = counts.get(r["status"], 0) + 1
        if r["status"] == "ok":
            f = fit.setdefault(r["shape"], [0, 0])
            f[0] += r["memory_analysis"]["peak_estimate_gib"] <= FIT_GIB
            f[1] += 1
    longest = max((r["compile_s"], cid) for cid, r in recs.items()
                  if r["status"] == "ok")
    summary = {"status": counts, "fit_80gb_of_ok": fit,
               "longest_trace": {"cell": longest[1], "s": longest[0]}}
    print("SWEEP " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
