"""Elastic scaling: move a training state onto another device set (port
of `repro/ft/elastic.py`, one card).

Scenario: a host is lost mid-run; the scheduler hands back a different
device.  The supervisor either restores the latest checkpoint onto it
(cold path, always works) or moves the live state (warm path, same
process).  The reference's `state_shardings` (NamedShardings from the
logical axis rules over a mesh) waits for the port's sharding layer;
with one card a state's placement is its device.

Batch elasticity: the global batch is kept constant by rescaling the
gradient-accumulation factor (microbatches) to the new data-parallel
width, so the training math is unchanged across rescales.
"""

from __future__ import annotations

import torch
from torch import nn


def reshard_state(state, device):
    """Warm path: every leaf of the state moved to `device` (a module in
    place, by `.to`); returns the moved state."""
    device = torch.device(device)
    if isinstance(state, nn.Module):
        return state.to(device)
    if isinstance(state, dict):
        return {k: reshard_state(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(reshard_state(v, device) for v in state)
    if isinstance(state, torch.Tensor):
        return state.to(device)
    return state


def rescale_microbatches(
    global_batch: int, old_dp: int, new_dp: int, old_microbatches: int
) -> int:
    """Keep global batch + per-device microbatch memory constant."""
    per_dev = global_batch // (old_dp * old_microbatches)
    new_mb = max(1, global_batch // (new_dp * per_dev))
    return new_mb
