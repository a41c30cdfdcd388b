"""Binary MLP, deployment half (port of `repro/core/bnn.py`): the folded
Eq. (3) layers, the parity rule for the BN constants, `fold`, and the
digital oracle `folded_forward_exact`.

Folding collapses each batch norm into an integer constant C_j:

    BN(y) >= 0  <=>  sign(gamma) * y >= sign(gamma) * (mu - beta*sigma/gamma)
    flip rows where gamma < 0, then X^{l+1} = sign(y' + C_j),
    C_j = round(beta*sigma/|gamma| - mu')

Training (`init_params`, `forward`, `train_mlp`) waits for the training
slice; `fold` takes the trained parameters as a tree of numpy arrays
(`convert.params_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Binary MLP hyperparameters (paper Sec. V-A models by default)."""

    layer_sizes: Sequence[int] = (784, 128, 10)  # MNIST: 784 -> 128 -> 10
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9
    # number of CAM bias cells appended per row at deployment; bounds |C_j|
    bias_cells: int = 64

    @property
    def n_layers(self) -> int:
        """Number of weight layers (FC transitions)."""
        return len(self.layer_sizes) - 1


@dataclasses.dataclass(frozen=True)
class FoldedLayer:
    """Deployment form of one binary layer: Eq. (3) data.

    weights_pm1 : [out, in] ±1 int8 rows (row per neuron)
    c           : [out] integer BN constants C_j
    """

    weights_pm1: np.ndarray
    c: np.ndarray

    @property
    def n_out(self) -> int:
        """Output neurons (CAM rows)."""
        return self.weights_pm1.shape[0]

    @property
    def n_in(self) -> int:
        """Input bits per row (the XNOR-popcount dot width)."""
        return self.weights_pm1.shape[1]


def parity_adjust_c(c: np.ndarray, n_in: int, bias_cells: int) -> np.ndarray:
    """Clip C_j to the bias-cell budget with dead-zone-free parity.

    y = <W_j, x> has the parity of n_in, so sign(y + C) has a dead zone
    (y + C == 0) unless C has the opposite parity.  Nudging C up by one is
    decision-preserving on the even grid; clipping can land back on the
    dead-zone parity only at the bounds, where we step one inward.
    """
    c = np.asarray(c, np.int64)
    c = np.where((c + n_in) % 2 == 0, c + 1, c)
    c = np.clip(c, -bias_cells, bias_cells)
    return np.where((c + n_in) % 2 == 0, c - np.sign(c).astype(c.dtype), c)


def fold(params: Params, cfg: MLPConfig) -> list[FoldedLayer]:
    """Collapse trained BN into integer C_j per neuron (Eq. 3). Numpy-side.

    params: {"layers": [{"w", "gamma", "beta", "mean", "var"}, ...]} of
    numpy arrays, `w` as [in, out] latent weights.
    """
    folded = []
    for layer in params["layers"]:
        w = np.sign(np.asarray(layer["w"]))
        w = np.where(w == 0, 1.0, w).T  # [out, in], sign(0) -> +1
        gamma = np.asarray(layer["gamma"], np.float64)
        beta = np.asarray(layer["beta"], np.float64)
        mu = np.asarray(layer["mean"], np.float64)
        sigma = np.sqrt(np.asarray(layer["var"], np.float64) + cfg.bn_eps)
        flip = gamma < 0
        w = np.where(flip[:, None], -w, w)
        thresh = mu - beta * sigma / np.where(gamma == 0, 1e-12, gamma)
        thresh = np.where(flip, -thresh, thresh)
        c = np.round(-thresh).astype(np.int64)
        c = parity_adjust_c(c, w.shape[1], cfg.bias_cells)
        folded.append(FoldedLayer(weights_pm1=w.astype(np.int8), c=c))
    return folded


def folded_forward_exact(folded: Sequence[FoldedLayer],
                         x_pm1: torch.Tensor) -> torch.Tensor:
    """Eq. (3) reference semantics of the deployed net (digital oracle).

    Runs every layer as sign(W x + C) in float32; returns the integer
    pre-sign of the final layer (W_L h + C_L) as float32 [..., n_out].
    """
    h = torch.as_tensor(x_pm1).to(torch.float32)
    y = h
    for i, layer in enumerate(folded):
        w = torch.as_tensor(layer.weights_pm1, dtype=torch.float32,
                            device=h.device)
        c = torch.as_tensor(layer.c, dtype=torch.float32, device=h.device)
        y = h @ w.T + c
        if i < len(folded) - 1:
            h = torch.where(y >= 0, 1.0, -1.0)
    return y
