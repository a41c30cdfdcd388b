"""Fake-tensor stand-ins for every model input: the dry-run contract
(port of `repro/launch/specs.py`).

`input_specs(cfg, shape)` returns fake tensors for the *data* inputs of
a step (the counterpart of `jax.ShapeDtypeStruct`); `params_specs`,
`state_specs` and `cache_specs` build the port's own `CausalLM`,
`init_opt_state` and `init_cache` on fake tensors, the counterpart of
`jax.eval_shape`: nothing is allocated.  Call them inside a
`FakeTensorMode` (the dry-run's), or pass one.  `_tree_with_shardings`
places each fake leaf as a DTensor on a DeviceMesh by its sanitised
spec (`sharding.rules.layout`, with no collective), as the reference
pins a NamedSharding on each struct.

The fakes are on `fake_device()`: the CUDA card's device type where this
PyTorch is built with CUDA, so a dry-run models the card's placement;
the CPU where it is not (a fake CUDA tensor there cannot be indexed:
PyTorch's Python bindings take a CUDA device guard that a CPU-only build
lacks).  The counts do not depend on it.

The port's steps take their data inputs as plain tensors, the same on
every rank (the model splits the batch at its first `shard`), so the
cell arguments keep the batch plain; `batch_pspecs` gives the
reference's specs for it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.sharding import AxisRules
from repro_torch.sharding.rules import P, layout, place
from repro_torch.train import TrainConfig
from repro_torch.train import optimizer as O


def fake_device() -> str:
    """The device type of the dry-run's fakes and mesh (see above)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _mode(mode):
    return contextlib.nullcontext() if mode is None else mode


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mode=None) -> dict:
    """Fake data inputs for one (arch x shape) cell.

    train  : {"tokens"|"embeds", "labels"}          (per Eq.-style LM loss)
    prefill: {"tokens"|"embeds"}
    decode : {"tokens"|"embeds" (len-1), "pos"}     (cache comes separately)
    """
    b, s = shape.global_batch, shape.seq_len
    dev = fake_device()
    with _mode(mode):
        def tok(ss):
            return torch.empty((b, ss), dtype=torch.int32, device=dev)

        def emb(ss):
            return torch.empty((b, ss, cfg.d_model), dtype=cfg.torch_dtype,
                               device=dev)

        data_in = emb if cfg.embeds_input else tok
        key = "embeds" if cfg.embeds_input else "tokens"
        if shape.kind == "train":
            return {key: data_in(s), "labels": tok(s)}
        if shape.kind == "prefill":
            return {key: data_in(s)}
        if shape.kind == "decode":
            return {key: data_in(1),
                    "pos": torch.empty((), dtype=torch.int32, device=dev)}
    raise ValueError(shape.kind)


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules: AxisRules):
    spec2 = rules.spec("batch", "seq")
    spec3 = rules.spec("batch", "seq", "embed")
    data = spec3 if cfg.embeds_input else spec2
    key = "embeds" if cfg.embeds_input else "tokens"
    if shape.kind == "train":
        return {key: data, "labels": spec2}
    if shape.kind == "prefill":
        return {key: data}
    return {key: data, "pos": P()}


def params_specs(cfg: ModelConfig, mode=None) -> M.CausalLM:
    """A `CausalLM` of fake parameters (values undefined, never drawn)."""
    with _mode(mode):
        return M.CausalLM(cfg, fake_device())


def state_specs(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None,
                mode=None) -> dict:
    tcfg = tcfg or TrainConfig()
    params = params_specs(cfg, mode)
    with _mode(mode):
        opt = O.init_opt_state(tcfg.opt, params)
    return {"params": params, "opt": opt}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mode=None) -> list:
    with _mode(mode):
        return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                            fake_device())


def _tree_with_shardings(tree, pspec_tree, mesh):
    """Each leaf of `tree` placed by its spec in `pspec_tree` (sanitised
    against its shape): a module's parameters and buffers replaced in
    place (its specs by state-dict name), a tensor returned as a DTensor,
    dicts and lists leaf by leaf."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, t in list(tree.state_dict(keep_vars=True).items()):
                owner, _, leaf = name.rpartition(".")
                mod = tree.get_submodule(owner) if owner else tree
                dt = _place(t.detach(), pspec_tree[name], mesh)
                if isinstance(t, nn.Parameter):
                    setattr(mod, leaf, nn.Parameter(
                        dt, requires_grad=t.requires_grad))
                else:
                    mod.register_buffer(leaf, dt)
        return tree
    if isinstance(tree, dict):
        return {k: _tree_with_shardings(v, pspec_tree[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_with_shardings(v, s, mesh)
                          for v, s in zip(tree, pspec_tree))
    return _place(tree, pspec_tree, mesh)


def _place(t: torch.Tensor, spec, mesh):
    return place(t, mesh, layout(spec, t.shape, mesh))


def train_cell_args(
    cfg: ModelConfig, shape: ShapeConfig, mesh, rules: AxisRules,
    tcfg: Optional[TrainConfig] = None,
    param_rules: Optional[AxisRules] = None, mode=None,
):
    """(state, batch) for train_step: the state's leaves DTensors, the
    batch plain.

    param_rules: optional separate rule set for the WORKING parameters
    (ZeRO-1: replicated bf16 params + data-sharded optimizer state)."""
    state = state_specs(cfg, tcfg, mode)
    p_ps = M.param_pspecs(cfg, rules)
    work_ps = (
        M.param_pspecs(cfg, param_rules) if param_rules is not None else p_ps
    )
    opt_leaf_ps = {"m": p_ps, "v": p_ps, "step": P()}
    if "master" in state["opt"]:
        opt_leaf_ps["master"] = p_ps
    state_ps = {"params": work_ps, "opt": opt_leaf_ps}
    with _mode(mode):
        return (_tree_with_shardings(state, state_ps, mesh),
                input_specs(cfg, shape))


def prefill_cell_args(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      rules: AxisRules, mode=None):
    params = params_specs(cfg, mode)
    with _mode(mode):
        return (_tree_with_shardings(params, M.param_pspecs(cfg, rules),
                                     mesh),
                input_specs(cfg, shape))


def decode_cell_args(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     rules: AxisRules, mode=None):
    """(params, cache, tokens, pos): the cache placed by `cache_pspecs`
    (the port's decode writes it in place, as the reference's donates
    it)."""
    params = params_specs(cfg, mode)
    cache = cache_specs(cfg, shape, mode)
    with _mode(mode):
        batch = input_specs(cfg, shape)
        data_key = "embeds" if cfg.embeds_input else "tokens"
        return (
            _tree_with_shardings(params, M.param_pspecs(cfg, rules), mesh),
            _tree_with_shardings(cache, M.cache_pspecs(cfg, rules), mesh),
            batch[data_key],
            batch["pos"],
        )
