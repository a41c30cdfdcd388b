"""Weights and settings carried across from the JAX package.

The reference's deployment data is numpy already (`FoldedLayer` holds
numpy arrays) or converts to numpy losslessly (`np.asarray` of a jax
array), and its noise settings are plain dataclasses of floats, so the
conversions here duck-type their inputs and import nothing of the JAX
package.  Packed words become the port's int32 view of the reference's
uint32 bit patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.binarize import InputEncoding, words_to_torch
from repro_torch.core.bnn import FoldedLayer, Params
from repro_torch.core.convnet import FoldedConvLayer, is_conv_layer
from repro_torch.core.device_model import AnalogParams, NoiseModel


def folded_from_jax(layers: Sequence[Any]) -> list:
    """The reference's folded layers -> the port's.

    A layer with [out, in] ±1 rows and `.c` [out] becomes a `FoldedLayer`;
    a conv layer ([c_out, k, k, c_in] filters, `.c`, `.stride`) becomes a
    `FoldedConvLayer` with its stride.
    """
    out = []
    for l in layers:
        w = np.asarray(l.weights_pm1).astype(np.int8)
        c = np.asarray(l.c).astype(np.int64)
        if is_conv_layer(l):
            out.append(FoldedConvLayer(weights_pm1=w, c=c,
                                       stride=int(l.stride)))
        else:
            out.append(FoldedLayer(weights_pm1=w, c=c))
    return out


def encoding_from_jax(encoding: Any) -> InputEncoding:
    """The reference's `binarize.InputEncoding` -> the port's."""
    return InputEncoding(kind=str(encoding.kind), width=int(encoding.width))


def params_from_jax(tree: Params) -> Params:
    """Trained parameters (leaves jax or numpy arrays) -> the same tree of
    numpy arrays, ready for `bnn.fold` or `convnet.fold_cnn`.

    The MLP's {"layers": [{"w", "gamma", "beta", "mean", "var"}, ...]} and
    the CNN's {"conv": [...], "fc": [...]} alike: every top-level entry
    is a list of per-layer dictionaries.
    """
    return {key: [{k: np.asarray(v) for k, v in layer.items()}
                  for layer in layers]
            for key, layers in tree.items()}


def rows_from_jax(words, device=None) -> torch.Tensor:
    """uint32 packed words (jax or numpy) -> the port's int32 tensor."""
    return words_to_torch(np.asarray(words), device)


def noise_from_jax(noise: Any) -> NoiseModel:
    """The reference's `device_model.NoiseModel` -> the port's, field by
    field."""
    return NoiseModel(**{f.name: float(getattr(noise, f.name))
                         for f in dataclasses.fields(NoiseModel)})


def analog_params_from_jax(params: Any) -> AnalogParams:
    """The reference's `device_model.AnalogParams` -> the port's, field by
    field."""
    return AnalogParams(**{f.name: float(getattr(params, f.name))
                           for f in dataclasses.fields(AnalogParams)})


def _leaf_to_torch(a) -> torch.Tensor:
    """A jax/numpy leaf -> a CPU tensor of the same dtype (bfloat16 by its
    bit pattern: numpy has no bfloat16, torch reads its uint16 view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str = ""):
    """Nested dicts -> [(dotted name, leaf)] in key order."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def lm_params_from_jax(tree, cfg) -> dict:
    """The reference's LM parameter tree (`models.model.init_params`:
    blocks stacked on a leading [blocks, ...] axis under `sub{i}` keys) ->
    the port's `CausalLM` state dict: each block unstacked to
    `blocks.{b}.sub{i}....`, every other leaf under its dotted path.
    Load it with `CausalLM(cfg, device).load_state_dict(...)`.
    """
    state = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "blocks"}):
        state[name] = _leaf_to_torch(leaf)
    for name, leaf in _flatten(tree["blocks"]):
        stacked = _leaf_to_torch(leaf)
        if stacked.shape[0] != cfg.blocks:
            raise ValueError(f"blocks.{name}: leading axis {stacked.shape[0]}"
                             f" != {cfg.blocks} blocks")
        for b in range(cfg.blocks):
            state[f"blocks.{b}.{name}"] = stacked[b].clone()
    return state


def lm_cache_from_jax(cache, cfg, device=None) -> list:
    """The reference's stacked decode cache ({sub{i}: {k, v, pos} or
    {conv, h}}, each leaf [blocks, ...]) -> the port's list over blocks."""
    out = [{} for _ in range(cfg.blocks)]
    for sub, leaves in cache.items():
        for k, leaf in leaves.items():
            stacked = _leaf_to_torch(leaf)
            for b in range(cfg.blocks):
                out[b].setdefault(sub, {})[k] = stacked[b].to(device)
    return out
