"""AdamW (decoupled weight decay) with float32 master weights, written
by hand on tensors (port of `repro/train/optimizer.py`).

State layout (dicts keyed by parameter name, as `named_parameters()`
and `convert.lm_params_from_jax` name them):
  m, v        -- float32 first/second moments
  master      -- float32 master copy of the parameters (optional; bf16
                 training without masters stalls once |update| < bf16 ulp)
  step        -- int32 scalar tensor

`torch.optim.AdamW` is not the reference's update: it keeps no float32
master for bf16 parameters, clips separately, evaluates the schedule at
the step before the increment, and does not decay through the master.
The reference's rule is kept here: the step is incremented first (so
the first update uses warmup (1 + 1) / warmup_steps of the rate), every
parameter is decayed, norms and embeddings included, and
`delta = m_hat / (sqrt(v_hat) + eps) + weight_decay * master`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.sharding.rules import replicated_plain

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_weights: bool = True
    warmup_steps: int = 100
    # cosine decay horizon; 0 disables the schedule (constant lr)
    decay_steps: int = 0


def named_params(params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a dict of tensors as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """float32 learning rate at `step` (an int tensor): linear warmup
    over (step + 1) / warmup_steps, then cosine decay to 0 at
    decay_steps."""
    s = step.to(F32)
    lr = torch.full_like(s, cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((s + 1.0) / cfg.warmup_steps, max=1.0)
    if cfg.decay_steps > 0:
        frac = torch.clamp(
            (s - cfg.warmup_steps)
            / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return lr


def init_opt_state(cfg: OptimizerConfig, params) -> dict[str, Any]:
    """Zero moments, step 0 and (with master_weights) a float32 master of
    every parameter, each on its parameter's device."""
    named = named_params(params)
    first = next(iter(named.values()))
    # (zeros_like keeps a DTensor parameter's placements)
    zeros = lambda p: torch.zeros_like(p.detach(), dtype=F32)
    state = {
        "m": {k: zeros(p) for k, p in named.items()},
        "v": {k: zeros(p) for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if cfg.master_weights:
        # a clone: `p.float()` of a float32 parameter returns the
        # parameter itself, and the master would then alias it
        state["master"] = {k: p.detach().to(F32).clone()
                           for k, p in named.items()}
    return state


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree.values()))


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step, in place: `params` (a module or a dict of tensors)
    take `master.to(p.dtype)`, the state its new moments, masters and
    step.  grads: a dict by parameter name.  Returns (params, state,
    {"grad_norm", "lr"}).  DTensor parameters, moments and masters are
    updated shard by shard (the norm is summed over every shard)."""
    named = named_params(params)
    with replicated_plain(named.values()):
        return _apply_updates(cfg, named, params, grads, state)


def _apply_updates(cfg, named, params, grads, state):
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.where(gnorm > cfg.grad_clip,
                        cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        torch.ones_like(gnorm))
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    masters = state.get("master")
    for k, p in named.items():
        g32 = grads[k].to(F32) * scale
        m, v = state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g32 * g32)
        mst = masters[k] if masters is not None else p.to(F32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * mst
        new = mst - lr * delta
        if masters is not None:
            mst.copy_(new)
        p.copy_(new.to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
