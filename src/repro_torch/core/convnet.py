"""End-to-end-binary CNN: training (sign-STE conv + batch norm), folding
for the packed-domain conv pipeline, and the Table-II cost of one
inference on the macro (port of `repro/core/convnet.py`).

The INPUT layer is binary too: raw [0,1] pixels pass through a
`binarize.InputEncoding` (thermometer by default) into `width` binary
channels before the first conv.  `fold_cnn` collapses each conv batch
norm into an integer constant C_o (Eq. 3 per output channel) and emits
`FoldedConvLayer` rows for the packed-domain kernel
(`kernels/fused_conv.py`), followed by folded FC layers: one flat list
that `pipeline.compile_pipeline` compiles end to end.

Spatial semantics: VALID convolutions with integer stride (downsampling
is stride-2 convs, no pooling).

Layouts are the reference's: activations NHWC, filters HWIO
[k, k, c_in, c_out], so `fold_cnn` and `convert.params_from_jax` take
either package's trees.  `cnn_forward` permutes to PyTorch's NCHW/OIHW
only around `F.conv2d` and flattens channels-last, in (y, x, channel)
order, which the first FC layer's rows assume.  The forward operands are
±1, so the products are exact in float32 and in TF32 alike; the
backward's are not, and cuDNN runs float32 convolutions in TF32 by
default on the card (`torch.backends.cudnn.allow_tf32`): this module
sets no global flag, so a caller that compares gradients sets it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bnn, mapping
from repro_torch.core.binarize import InputEncoding, sign_ste
from repro_torch.core.bnn import (FoldedLayer, Params, batch_norm, fold_bn,
                                  parity_adjust_c, to_host)


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
    "fc": [...]} of numpy arrays or tensors on any device, conv `w` as
    [k, k, c_in, c_out] and FC `w` as [in, out] latent weights.  Returns
    [FoldedConvLayer, ..., FoldedLayer, ...]: the conv stack followed by
    the MLP stage.
    """
    folded: list = []
    for layer, spec in zip(params["conv"], cfg.conv):
        w = np.sign(to_host(layer["w"]))
        w = np.where(w == 0, 1.0, w)  # sign(0) -> +1, the '1' coding
        w = np.transpose(w, (3, 0, 1, 2))  # -> rows [c_out, k, k, c_in]
        n_bits = spec.k * spec.k * w.shape[3]
        w, c = fold_bn(w, layer, cfg.bn_eps, n_bits, cfg.bias_cells)
        folded.append(FoldedConvLayer(weights_pm1=w, c=c,
                                      stride=spec.stride))
    for layer in params["fc"]:
        w = np.sign(to_host(layer["w"]))
        w = np.where(w == 0, 1.0, w).T  # [out, in]
        w, c = fold_bn(w, layer, cfg.bn_eps, w.shape[1], cfg.bias_cells)
        folded.append(FoldedLayer(weights_pm1=w, c=c))
    return folded


def init_cnn_params(generator: torch.Generator, cfg: CNNConfig,
                    dtype=torch.float32) -> Params:
    """Glorot latent conv filters + FC weights, identity batch norm, drawn
    from `generator` on its device."""
    params: Params = {"conv": [], "fc": []}
    c_in = cfg.encoding.width
    for spec in cfg.conv:
        w = bnn.glorot(generator, (spec.k, spec.k, c_in, spec.c_out),
                       spec.k * spec.k * c_in, spec.k * spec.k * spec.c_out,
                       dtype)
        params["conv"].append(bnn.bn_layer(w, spec.c_out))
        c_in = spec.c_out
    sizes = cfg.fc_sizes
    for a, b in zip(sizes[:-1], sizes[1:]):
        params["fc"].append(bnn.bn_layer(bnn.glorot(generator, (a, b), a, b,
                                                    dtype), b))
    return params


def cnn_forward(params: Params, x01, cfg: CNNConfig, *,
                train: bool = False):
    """Forward pass on raw [0,1] pixels [B, side*side] (moved to the
    params' device).

    The input layer is binary: pixels pass through `cfg.encoding` into ±1
    channels before the first conv.  Returns (logits, new_params) like
    `bnn.forward`.
    """
    w0 = params["fc"][0]["w"]
    x = torch.as_tensor(x01).to(w0.device, w0.dtype)
    b = x.shape[0]
    h = cfg.encoding.encode_pm1(x.reshape(b, cfg.side, cfg.side))  # NHWC
    new_conv = []
    for layer, spec in zip(params["conv"], cfg.conv):
        wb = sign_ste(layer["w"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(h.permute(0, 3, 1, 2), wb, stride=spec.stride)
        # batch norm per channel over (N, H, W), channels last
        y, stats = batch_norm(y.permute(0, 2, 3, 1), layer, cfg.bn_eps,
                              cfg.bn_momentum, train, dims=(0, 1, 2))
        new_conv.append({**layer, **stats})
        h = sign_ste(y)  # NHWC
    h = h.reshape(b, -1)  # NHWC flatten: logical (y, x, channel) order
    new_fc = []
    n_fc = len(params["fc"])
    for i, layer in enumerate(params["fc"]):
        y = h @ sign_ste(layer["w"])
        y, stats = batch_norm(y, layer, cfg.bn_eps, cfg.bn_momentum, train,
                              dims=(0,))
        new_fc.append({**layer, **stats})
        if i < n_fc - 1:
            h = sign_ste(y)
    return y, {"conv": new_conv, "fc": new_fc}


def cnn_loss(params: Params, x01, labels, cfg: CNNConfig):
    """Cross-entropy on the (training-only) full-precision logits.
    Returns (loss, params with updated BN running stats)."""
    logits, new_params = cnn_forward(params, x01, cfg, train=True)
    labels = torch.as_tensor(labels).to(logits.device, torch.int64)
    return F.cross_entropy(logits, labels), new_params


def train_cnn(generator: torch.Generator, cfg: CNNConfig, train_x,
              train_y, *, epochs: int = 6, batch: int = 128,
              lr: float = 1e-3, verbose: bool = False,
              on_epoch=None, device=None) -> Params:
    """Train a binary CNN on raw [0,1] pixels [N, side*side] (the binary
    input encoding runs inside the forward pass).

    Same recipe, batch order and options as `bnn.train_mlp` (verbose
    reports on 1,024 samples); only the latent weights are clipped, never
    the BN statistics.  `generator` draws the initial params on its
    device; they then move to `device` (None: the CUDA card, raising
    without CUDA).
    """
    from repro_torch.pipeline import resolve_device  # deferred: no cycle

    dev = resolve_device(device)
    return bnn.fit(init_cnn_params(generator, cfg),
                   lambda p, x, y: cnn_loss(p, x, y, cfg), train_x, train_y,
                   epochs=epochs, batch=batch, lr=lr, device=dev,
                   after_epoch=bnn.epoch_hook(
                       verbose, on_epoch, epochs,
                       lambda p: eval_cnn_accuracy(p, cfg, train_x[:1024],
                                                   train_y[:1024])))


def eval_cnn_accuracy(params: Params, cfg: CNNConfig, x01, y,
                      topk=(1,)) -> dict:
    """Top-k accuracy of the full-precision-logit software path, on the
    params' device."""
    with torch.no_grad():
        logits, _ = cnn_forward(params, np.asarray(x01), cfg)
    return bnn.topk_accuracy(logits, y, topk)


def cnn_inference_cost(cfg: CNNConfig, n_output_passes: int = 33
                       ) -> mapping.InferenceCost:
    """Table-II-style silicon cost of one CNN inference on the macro.

    Each conv layer maps its filters onto a CAM tile plan
    (`mapping.plan_layer` with row width k*k*c_in + bias cells) and is
    searched once per output position; FC layers query once; the output
    layer sweeps `n_output_passes` thresholds.  What the server reports
    as a CNN's silicon-equivalent rate
    (`PicBnnServer.register(silicon_cost=...)`).
    """
    sides = cfg.feature_sides()
    chans = cfg.feature_channels()
    plans, queries = [], []
    for spec, c_in, s_out in zip(cfg.conv, chans[:-1], sides[1:]):
        plans.append(mapping.plan_layer(
            spec.c_out, spec.k * spec.k * c_in, cfg.bias_cells))
        queries.append(s_out * s_out)
    sizes = cfg.fc_sizes
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        plans.append(mapping.plan_layer(n_out, n_in, cfg.bias_cells))
        queries.append(1)
    return mapping.model_inference_cost(plans, n_output_passes,
                                        layer_queries=queries)


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
