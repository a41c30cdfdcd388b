"""The port's dry-run over every (architecture x shape x mesh) cell.

    PYTHONPATH=src python scripts/torch_dryrun_sweep.py [--workers 8]
        [--out results/torch/dryrun]

Runs `python -m repro_torch.launch.dryrun --arch A --shape S,...
[--multi-pod] --out OUT` once for every architecture and production mesh,
each in a subprocess of its own (the fake group needs a process of its
own), `--workers` at a time, and prints each one's output as it ends.
The prefill and train cells of the architectures with Mamba layers are
left out: the port's selective scan is a Python loop over the sequence
(one step of ~8 ops a layer and position, 16.8 M ops for
falcon-mamba-7b's prefill_32k), which takes hours on fake tensors.  Each
is written as a record with status "not traced".  Prints the count of
cells by status last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch.dryrun import cell_id  # noqa: E402


def untraced(cfg) -> list[str]:
    """The shapes of `cfg` the sweep leaves out (Mamba prefill/train)."""
    if "mamba" not in cfg.pattern().kinds:
        return []
    return [n for n, s in SHAPES.items() if s.kind in ("train", "prefill")]


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
        left = untraced(configs.get_config(arch))
        shapes = [n for n in SHAPES if n not in left]
        for mp in (False, True):
            jobs.append([sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--shape", ",".join(shapes),
                         "--out", str(out)] + (["--multi-pod"] if mp else []))
            cells += [cell_id(arch, n, mp) for n in SHAPES]
            for n in left:
                (out / f"{cell_id(arch, n, mp)}.json").write_text(json.dumps({
                    "arch": arch, "shape": n, "multi_pod": mp,
                    "status": "not traced",
                    "reason": "Mamba scan: one eager step per position",
                }, indent=2))

    def run(cmd):
        return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True)

    with ThreadPoolExecutor(args.workers) as pool:
        for p in pool.map(run, jobs):
            print(p.stdout, flush=True)
            if p.returncode:
                print(p.stderr[-2000:], flush=True)
    counts: dict[str, int] = {}
    for cid in cells:
        path = out / f"{cid}.json"
        st = json.loads(path.read_text())["status"] if path.exists() \
            else "missing"
        counts[st] = counts.get(st, 0) + 1
    print("SWEEP " + json.dumps(counts))


if __name__ == "__main__":
    main()
