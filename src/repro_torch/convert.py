"""Weights carried across from the JAX package.

The reference's deployment data is numpy already (`FoldedLayer` holds
numpy arrays) or converts to numpy losslessly (`np.asarray` of a jax
array), so the conversions here duck-type their inputs and import nothing
of the JAX package.  Packed words become the port's int32 view of the
reference's uint32 bit patterns.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.binarize import words_to_torch
from repro_torch.core.bnn import FoldedLayer, Params


def folded_from_jax(layers: Sequence[Any]) -> list[FoldedLayer]:
    """The reference's folded layers (anything with `.weights_pm1` [out, in]
    ±1 and `.c` [out]) -> the port's `FoldedLayer`s."""
    return [
        FoldedLayer(
            weights_pm1=np.asarray(l.weights_pm1).astype(np.int8),
            c=np.asarray(l.c).astype(np.int64),
        )
        for l in layers
    ]


def params_from_jax(tree: Params) -> Params:
    """Trained `bnn` params ({"layers": [{"w", "gamma", "beta", "mean",
    "var"}, ...]}, leaves jax or numpy arrays) -> the same tree of numpy
    arrays, ready for `bnn.fold`."""
    return {"layers": [{k: np.asarray(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def rows_from_jax(words, device=None) -> torch.Tensor:
    """uint32 packed words (jax or numpy) -> the port's int32 tensor."""
    return words_to_torch(np.asarray(words), device)
