"""The repo's deprecation lint (`scripts/check_deprecated.py`, a step of
`scripts/smoke.sh`) over the tree with the port in it: the port's legacy
pipeline shims route through a private body, so no legacy entry is
called outside the reference's shim module."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_deprecation_lint_passes_with_the_port():
    p = subprocess.run([sys.executable, "scripts/check_deprecated.py"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "check_deprecated OK" in p.stdout
