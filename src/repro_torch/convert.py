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
