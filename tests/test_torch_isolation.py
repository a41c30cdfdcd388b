"""The port stands alone: importing every `repro_torch` module pulls in
neither `jax` nor any module of the JAX package, and its entry points
(compiling, serving, training, the four `examples/torch_*.py`) default
to the CUDA card (raising when there is none)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

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

    from repro_torch.core import bnn, convnet, mapping
    from repro_torch.data import synthetic
    from repro_torch.pipeline import compile_pipeline
    from repro_torch.serve.picbnn import PicBnnServer
    layer = bnn.FoldedLayer(weights_pm1=torch.ones(4, 8, dtype=torch.int8)
                            .numpy(), c=torch.zeros(4, dtype=torch.int64)
                            .numpy())
    assert mapping.layer_forward and synthetic.make_dataset
    x, y = torch.ones(4, 8).numpy(), torch.zeros(4, dtype=torch.int64).numpy()
    gen = torch.Generator()
    if not torch.cuda.is_available():
        for entry in (lambda: compile_pipeline([layer]),
                      lambda: PicBnnServer(),
                      lambda: bnn.train_mlp(gen, bnn.MLPConfig((8, 2)), x, y),
                      lambda: convnet.train_cnn(gen, convnet.CNNConfig(), x,
                                                y)):
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


_LM_PROBE = textwrap.dedent("""
    import sys
    import torch
    from repro_torch import configs, ft, train
    from repro_torch.data import tokens
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import binary_lm, layers, model, ssm
    from repro_torch.serve import engine, steps

    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    assert not bad, bad
    assert len(configs.list_archs()) == 10
    cfg = configs.get_config("llama3.2-1b+smoke+cam-head")
    if not torch.cuda.is_available():
        params = model.init_params(cfg, torch.Generator(), device="cpu")
        for entry in (lambda: model.init_params(cfg, torch.Generator()),
                      lambda: model.CausalLM(cfg),
                      lambda: engine.Engine(cfg, params,
                                            engine.EngineConfig()),
                      lambda: serve.main(["--requests", "1"]),
                      lambda: train.init_train_state(cfg, train.TrainConfig(),
                                                     torch.Generator()),
                      lambda: launch_train.main(["--arch",
                                                 "llama3.2-1b+smoke",
                                                 "--steps", "1"])):
            try:
                entry()
            except RuntimeError as e:
                assert "CUDA" in str(e), e
            else:
                raise AssertionError("LM entry point ran without CUDA")
        state = train.init_train_state(cfg, train.TrainConfig(),
                                       torch.Generator(), device="cpu")
        assert state["params"].device.type == "cpu"
        assert launch_train.main(["--arch", "llama3.2-1b+smoke", "--steps",
                                  "1", "--seq", "8", "--device", "cpu"])
    print("LM ISOLATED")
""")


def test_lm_port_imports_no_jax_and_defaults_to_cuda():
    """The LM modules (configs, models, serve.engine/steps, launch.serve,
    train, ft, data.tokens, launch.train) pull in no jax/repro;
    init_params, CausalLM, Engine, init_train_state and both launchers
    default to the card and raise without one, and run on the CPU when
    asked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _LM_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LM ISOLATED" in out.stdout


def test_launcher_refuses_model_parallel():
    """The serving launcher refuses a --model-parallel below 1 before it
    starts a process group; above the world size it is capped at it, as
    the reference's make_host_mesh caps it (one CPU rank: a (1, 1) mesh
    serving the unsharded tokens), and the group it started is gone."""
    import torch.distributed as dist

    from repro_torch.launch import serve

    args = ["--device", "cpu", "--requests", "2", "--max-new", "3"]
    with pytest.raises(ValueError, match="model-parallel"):
        serve.main(args + ["--model-parallel", "0"])
    assert not dist.is_initialized()
    capped = serve.run(args + ["--model-parallel", "2"])
    assert not dist.is_initialized()
    assert tuple(capped["mesh"].mesh.shape) == (1, 1)
    assert [r.tokens for r in capped["results"]] == \
        [r.tokens for r in serve.main(args)]


def test_package_exports_equal_reference():
    """`repro_torch.serve` and `repro_torch.checkpoint` export the
    reference packages' names (the server's lazily, as there), and
    `repro_torch.kernels` its `ops` and `ref`."""
    import importlib
    import inspect

    import repro.kernels
    import repro_torch.kernels

    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not inspect.ismodule(v)}

    for pkg in ("serve", "checkpoint"):
        ref = importlib.import_module(f"repro.{pkg}")
        port = importlib.import_module(f"repro_torch.{pkg}")
        assert public(port) == public(ref), pkg
    import repro.serve
    import repro_torch.serve

    for name in ("PicBnnServer", "ClassifyResult", "GroupHandle",
                 "ServerStats", "ModelStats"):
        assert getattr(repro_torch.serve, name).__name__ == \
            getattr(repro.serve, name).__name__
    for name in ("ops", "ref"):
        assert inspect.ismodule(getattr(repro.kernels, name))
        assert getattr(repro_torch.kernels, name).__name__ == \
            f"repro_torch.kernels.{name}"


EXAMPLES = SRC.parent / "examples"
TORCH_EXAMPLES = ("torch_quickstart", "torch_picbnn_serve", "torch_lm_train",
                  "torch_ft_demo")


@pytest.mark.parametrize("name", TORCH_EXAMPLES)
def test_torch_example_imports_neither_jax_nor_repro(name):
    """Every import statement of the example, at any depth (the ones
    inside `main` too), names neither `jax` nor the JAX package."""
    import ast

    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert any(m.startswith("repro_torch") for m in mods)


_EXAMPLES_PROBE = textwrap.dedent("""
    import importlib, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    for name in sys.argv[2:]:
        mod = importlib.import_module(name)
        if not torch.cuda.is_available():
            try:
                mod.main([])
            except RuntimeError as e:
                assert "CUDA" in str(e), (name, e)
            else:
                raise AssertionError(f"{name} ran without CUDA")
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    assert not bad, bad
    print("EXAMPLES ISOLATED")
""")


def test_torch_examples_load_no_jax_and_refuse_the_cpu_unasked():
    """Importing the four examples pulls in no jax/repro, and each `main`
    without --device runs on the card: with no card it raises rather
    than falling back to the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _EXAMPLES_PROBE,
                          str(EXAMPLES), *TORCH_EXAMPLES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "EXAMPLES ISOLATED" in out.stdout
