"""Serving steps: prefill and single-token decode (port of
`repro/serve/steps.py`), the building blocks of `serve/engine.py`.

Plain callables: there is no jit to build, so `make_*_step` bind the
config and accept `donate` as the reference's no-op (a decode step
updates its cache in place, as a donated cache would be).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def prefill_step(cfg: ModelConfig, params, batch: dict,
                 max_len: Optional[int] = None):
    """batch: {"tokens" [B,S]} or {"embeds" [B,S,D]} ->
    (last-token logits [B,V], cache sized max_len or S+64)."""
    if cfg.embeds_input:
        return M.prefill(params, cfg, embeds=batch["embeds"], max_len=max_len)
    return M.prefill(params, cfg, tokens=batch["tokens"], max_len=max_len)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One token for every sequence in the batch.

    tokens: [B, 1] int (or [B, 1, D] embeds); pos: int.
    Returns (logits [B, V], cache)."""
    return M.decode(params, cfg, cache, tokens, pos)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab (the first index among equal maxima)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """A draw from softmax(logits / T) per row (greedy at T <= 0); agrees
    with the reference's `jax.random.categorical` in distribution."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)


def make_prefill_step(cfg: ModelConfig, donate: bool = False,
                      max_len: Optional[int] = None):
    return functools.partial(prefill_step, cfg, max_len=max_len)


def make_decode_step(cfg: ModelConfig, donate: bool = True):
    return functools.partial(decode_step, cfg)
