"""The port stands alone: importing every `repro_torch` module pulls in
neither `jax` nor any module of the JAX package, and its entry points
default to the CUDA card (raising when there is none)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import torch
    import repro_torch

    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    assert not bad, bad
    assert len(names) >= 15, names

    from repro_torch.core import bnn
    from repro_torch.pipeline import compile_pipeline
    from repro_torch.serve.picbnn import PicBnnServer
    layer = bnn.FoldedLayer(weights_pm1=torch.ones(4, 8, dtype=torch.int8)
                            .numpy(), c=torch.zeros(4, dtype=torch.int64)
                            .numpy())
    if not torch.cuda.is_available():
        for entry in (lambda: compile_pipeline([layer]),
                      lambda: PicBnnServer()):
            try:
                entry()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("entry point ran without CUDA")
    print("ISOLATED", len(names))
""")


def test_port_imports_no_jax_and_defaults_to_cuda():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
