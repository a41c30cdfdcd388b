"""The training step: loss -> grads -> (compressed) -> AdamW update
(port of `repro/train/train_step.py`).

Microbatching: the global batch can be split into `microbatches`
gradient-accumulation steps; activation memory scales with the
microbatch.  Each microbatch's gradients are taken with
`torch.autograd.grad` in the parameters' dtype and summed into float32
buffers, as the reference casts each microbatch's gradients to float32
before its sum (accumulating into bf16 `.grad` would round every partial
sum).  The update is in place: `train_step` returns the state it was
given, its tensors updated.

Gradient compression (train/grad_compress.py): optional 1-bit
scaled-sign on the gradients before the update.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.pipeline import resolve_device
from repro_torch.sharding.rules import replicated_plain
from repro_torch.train import optimizer as O
from repro_torch.train.grad_compress import (CompressionConfig,
                                             maybe_compress_grads)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptimizerConfig = O.OptimizerConfig()
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    compression: CompressionConfig = CompressionConfig()


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator, device=None) -> dict:
    """{"params": a CausalLM drawn from `generator` (on the target
    device), "opt": its optimizer state}.  `device` None means the CUDA
    card, raising when there is none."""
    params = M.init_params(cfg, generator, device=resolve_device(device))
    return {"params": params, "opt": O.init_opt_state(tcfg.opt, params)}


def _to_device(batch: dict, device) -> dict:
    """numpy (or tensor) batch leaves -> tensors on `device`."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
        v, np.ndarray) else v).to(device) for k, v in batch.items()}


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    assert b % n == 0, f"batch {b} not divisible by {n} microbatches"
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch):
    """(loss, grads by parameter name, metrics).  One pass, or gradient
    accumulation over microbatches: the mean loss, the mean of the
    float32-summed gradients, and the last microbatch's metrics."""
    batch = _to_device(batch, params.device)
    named = O.named_params(params)
    names, leaves = list(named), list(named.values())

    def grad_fn(b):
        loss, metrics = M.loss_fn(params, cfg, b,
                                  aux_weight=tcfg.moe_aux_weight)
        # a parameter off the loss (a CAM head's rows) gets zeros
        with replicated_plain(leaves):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), dict(zip(names, grads)), \
            {k: v.detach() for k, v in metrics.items()}

    if tcfg.microbatches <= 1:
        return grad_fn(batch)
    # float32 buffers laid out as the parameters are (DTensors on a mesh)
    acc = {k: torch.zeros_like(p, dtype=F32) for k, p in named.items()}
    loss_sum = None
    for mb in _split_microbatches(batch, tcfg.microbatches):
        loss, grads, metrics = grad_fn(mb)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        for k, g in grads.items():
            acc[k].add_(g.to(F32))
        del grads
    inv = 1.0 / tcfg.microbatches
    return loss_sum * inv, {k: a.mul_(inv) for k, a in acc.items()}, metrics


def train_step(cfg: ModelConfig, tcfg: TrainConfig, state: dict, batch):
    """state: {"params", "opt"}; batch: {"tokens"/"embeds", "labels"}
    (numpy or tensors).  Updates the state in place and returns (state,
    metrics)."""
    params = state["params"]
    loss, grads, metrics = loss_and_grads(cfg, tcfg, params, batch)
    grads, comp_metrics = maybe_compress_grads(tcfg.compression, grads)
    _, opt, opt_metrics = O.apply_updates(tcfg.opt, params, grads,
                                          state["opt"])
    state["opt"] = opt
    return state, {"loss": loss, **metrics, **opt_metrics, **comp_metrics}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    donate: bool = True):
    """`train_step` bound to (cfg, tcfg).  `donate` is accepted and has
    no effect (the step updates the state in place; the reference's jit
    donates it)."""
    return functools.partial(train_step, cfg, tcfg)
