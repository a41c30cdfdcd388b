"""End-to-end-binary CNN, deployment half (port of `repro/core/convnet.py`).

The INPUT layer is binary too: raw [0,1] pixels pass through a
`binarize.InputEncoding` (thermometer by default) into `width` binary
channels before the first conv.  `fold_cnn` collapses each conv batch
norm into an integer constant C_o (Eq. 3 per output channel) and emits
`FoldedConvLayer` rows for the packed-domain kernel
(`kernels/fused_conv.py`), followed by folded FC layers: one flat list
that `pipeline.compile_pipeline` compiles end to end.

Spatial semantics: VALID convolutions with integer stride (downsampling
is stride-2 convs, no pooling).

What waits for later slices: `init_cnn_params`, `cnn_forward`,
`cnn_loss` and `train_cnn` come with the training slice (`fold_cnn`
takes the trained parameters as a tree of numpy arrays,
`convert.params_from_jax`); `cnn_inference_cost` comes with the
cost-model slice, which brings `core/mapping.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.binarize import InputEncoding
from repro_torch.core.bnn import FoldedLayer, Params, fold_bn, parity_adjust_c


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One binary conv layer: k x k window, c_out filters, VALID, stride."""

    k: int
    c_out: int
    stride: int = 1

    def __post_init__(self):
        if self.k < 1 or self.c_out < 1 or self.stride < 1:
            raise ValueError(f"bad ConvSpec {self}")

    def out_side(self, side: int) -> int:
        """VALID output side for a square `side` input."""
        if side < self.k:
            raise ValueError(f"input side {side} < kernel {self.k}")
        return (side - self.k) // self.stride + 1


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """End-to-end-binary CNN hyperparameters.

    side      : square input image side (n_in = side * side raw pixels)
    encoding  : binary input layer ([0,1] pixel -> `encoding.width`
                binary channels)
    conv      : conv stack (VALID, strided)
    hidden    : FC widths between the flatten and the output layer
    n_classes : output classes (the CAM ensemble head rows)
    """

    side: int = 28
    encoding: InputEncoding = InputEncoding("thermometer", 8)
    conv: Sequence[ConvSpec] = (ConvSpec(3, 32, 2), ConvSpec(3, 32, 2))
    hidden: Sequence[int] = (128,)
    n_classes: int = 10
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9
    bias_cells: int = 64

    @property
    def n_in(self) -> int:
        """Raw pixel count the pipeline/serving layer sees."""
        return self.side * self.side

    def feature_sides(self) -> list[int]:
        """Feature-map side after the input and after each conv layer."""
        sides = [self.side]
        for spec in self.conv:
            sides.append(spec.out_side(sides[-1]))
        return sides

    def feature_channels(self) -> list[int]:
        """Channel count entering each conv layer (+ the final one)."""
        return [self.encoding.width] + [s.c_out for s in self.conv]

    @property
    def flat_features(self) -> int:
        """Logical bits entering the MLP stage (final side^2 * c_out)."""
        return self.feature_sides()[-1] ** 2 * self.feature_channels()[-1]

    @property
    def fc_sizes(self) -> tuple[int, ...]:
        """(flat, *hidden, n_classes) — the MLP-stage layer sizes."""
        return (self.flat_features, *self.hidden, self.n_classes)


@dataclasses.dataclass(frozen=True)
class FoldedConvLayer:
    """Deployment form of one binary conv layer (Eq. 3 per channel).

    weights_pm1 : [c_out, k, k, c_in] ±1 filters (one CAM row per output
                  channel, bits ordered tap-major (dy, dx, c))
    c           : [c_out] integer BN constants, parity-adjusted so
                  sign(dot + C) has no dead zone (bnn.parity_adjust_c)
    stride      : spatial stride (VALID padding always)
    """

    weights_pm1: np.ndarray
    c: np.ndarray
    stride: int = 1

    @property
    def c_out(self) -> int:
        """Output channels (CAM rows / bits produced per position)."""
        return self.weights_pm1.shape[0]

    @property
    def k(self) -> int:
        """Square kernel side."""
        return self.weights_pm1.shape[1]

    @property
    def c_in(self) -> int:
        """Input channels per tap."""
        return self.weights_pm1.shape[3]

    @property
    def n_bits(self) -> int:
        """Logical dot width: k * k * c_in bits per patch."""
        return self.k * self.k * self.c_in


def is_conv_layer(layer) -> bool:
    """True for a folded conv layer (4-D [c_out, k, k, c_in] filters)."""
    return np.ndim(layer.weights_pm1) == 4


def fold_cnn(params: Params, cfg: CNNConfig) -> list:
    """Collapse trained BN into integer constants per channel/neuron.

    params: {"conv": [{"w", "gamma", "beta", "mean", "var"}, ...],
    "fc": [...]} of numpy arrays, conv `w` as [k, k, c_in, c_out] and FC
    `w` as [in, out] latent weights.  Returns [FoldedConvLayer, ...,
    FoldedLayer, ...]: the conv stack followed by the MLP stage.
    """
    folded: list = []
    for layer, spec in zip(params["conv"], cfg.conv):
        w = np.sign(np.asarray(layer["w"]))
        w = np.where(w == 0, 1.0, w)  # sign(0) -> +1, the '1' coding
        w = np.transpose(w, (3, 0, 1, 2))  # -> rows [c_out, k, k, c_in]
        n_bits = spec.k * spec.k * w.shape[3]
        w, c = fold_bn(w, layer, cfg.bn_eps, n_bits, cfg.bias_cells)
        folded.append(FoldedConvLayer(weights_pm1=w, c=c,
                                      stride=spec.stride))
    for layer in params["fc"]:
        w = np.sign(np.asarray(layer["w"]))
        w = np.where(w == 0, 1.0, w).T  # [out, in]
        w, c = fold_bn(w, layer, cfg.bn_eps, w.shape[1], cfg.bias_cells)
        folded.append(FoldedLayer(weights_pm1=w, c=c))
    return folded


def random_folded_cnn(cfg: CNNConfig, seed: int = 0, cmax: int = 24) -> list:
    """An untrained deployed CNN with fold-style parity-adjusted C.

    Random ±1 filters/weights with valid dead-zone-free constants, drawn
    from numpy's generator in the reference's order, so a seed gives the
    reference's arrays.
    """
    rng = np.random.default_rng(seed)
    folded: list = []
    c_in = cfg.encoding.width
    for spec in cfg.conv:
        n_bits = spec.k * spec.k * c_in
        c = parity_adjust_c(
            rng.integers(-cmax, cmax + 1, spec.c_out), n_bits,
            cfg.bias_cells,
        )
        folded.append(FoldedConvLayer(
            weights_pm1=rng.choice(
                [-1, 1], (spec.c_out, spec.k, spec.k, c_in)
            ).astype(np.int8),
            c=c,
            stride=spec.stride,
        ))
        c_in = spec.c_out
    sizes = cfg.fc_sizes
    for i in range(len(sizes) - 1):
        c = parity_adjust_c(
            rng.integers(-cmax, cmax + 1, sizes[i + 1]), sizes[i],
            cfg.bias_cells,
        )
        folded.append(FoldedLayer(
            weights_pm1=rng.choice(
                [-1, 1], (sizes[i + 1], sizes[i])
            ).astype(np.int8),
            c=c,
        ))
    return folded
