"""Elastic scaling: reshard a training state onto another device set
(port of `repro/ft/elastic.py`).

Scenario: a host is lost mid-run; the scheduler hands back a smaller (or
later, larger) device set.  The supervisor rebuilds the mesh, recomputes
the placements from the SAME logical rules (`state_shardings`), and
either restores the latest checkpoint against them (cold path, always
works) or reshards the live state (warm path, same process).  On one
card a state's placement can also be just its device.

Batch elasticity: the global batch is kept constant by rescaling the
gradient-accumulation factor (microbatches) to the new data-parallel
width, so the training math is unchanged across rescales.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.sharding import AxisRules
from repro_torch.sharding.rules import MeshPlacement, layout
from repro_torch.train.optimizer import named_params


def state_shardings(cfg: ModelConfig, mesh, rules: AxisRules,
                    state_template) -> dict:
    """`MeshPlacement`s for a {"params", "opt"} train state on a
    DeviceMesh: each parameter by `param_pspecs` (sanitised against the
    template's shape), its moments and master like it, `step`
    replicated."""
    rules = rules.resolve(mesh)
    specs = M.param_pspecs(cfg, rules)
    params = named_params(state_template["params"])

    def named(tree):
        return {k: MeshPlacement(mesh, layout(specs[k], t.shape, mesh))
                for k, t in tree.items()}

    opt = {}
    for k, v in state_template["opt"].items():
        if k == "step":
            opt[k] = MeshPlacement(mesh, layout((), v.shape, mesh))
        else:
            opt[k] = named(v)
    return {"params": named(params), "opt": opt}


def reshard_state(state, target):
    """Warm path.  `target` a device: every leaf moved there (a module in
    place, by `.to`).  `target` a `state_shardings` tree: every leaf put
    by its `MeshPlacement` (a module's parameters replaced in place).
    Returns the moved state."""
    if isinstance(target, dict):
        return _put_tree(state, target)
    device = torch.device(target)
    if isinstance(state, nn.Module):
        return state.to(device)
    if isinstance(state, dict):
        return {k: reshard_state(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(reshard_state(v, device) for v in state)
    if isinstance(state, torch.Tensor):
        return state.to(device)
    return state


def _put_tree(state, target):
    if isinstance(state, nn.Module):
        with torch.no_grad():
            for name, p in list(state.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                mod = state.get_submodule(owner) if owner else state
                setattr(mod, leaf, nn.Parameter(
                    target[name].put(p), requires_grad=p.requires_grad))
        return state
    if isinstance(state, dict):
        return {k: _put_tree(v, target[k]) for k, v in state.items()}
    return target.put(state)


def rescale_microbatches(
    global_batch: int, old_dp: int, new_dp: int, old_microbatches: int
) -> int:
    """Keep global batch + per-device microbatch memory constant."""
    per_dev = global_batch // (old_dp * old_microbatches)
    new_mb = max(1, global_batch // (new_dp * per_dev))
    return new_mb
