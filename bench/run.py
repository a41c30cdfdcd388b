"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object; the
last lines of standard error are the numbers compared, each beside its
limit.  Without enough CUDA cards it exits 3 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
# the checkout and the program's sources, in place of bench/ itself (whose
# module names would shadow the standard library's)
sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
