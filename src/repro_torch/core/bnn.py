"""Binary MLP (port of `repro/core/bnn.py`): training with latent
weights, sign-STE and batch norm, then deployment by folding each batch
norm into an integer CAM bias constant (paper Eqs. (1)-(4)).

Training follows BinaryConnect/XNOR-Net practice, as the reference does:
latent real-valued weights binarized by `binarize.sign_ste` on the
forward pass (clipped straight-through estimator on the backward pass),
activations binarized the same way between layers, batch norm after
every binary dot product, cross-entropy on the full-precision logits of
the output layer, Adam on the latent weights, which are clipped to
[-1, 1] after each step.  Parameters keep the reference's tree,
{"layers": [{"w" [n_in, n_out], "gamma", "beta", "mean", "var"}]}, as
torch tensors; `fold` takes it with tensor leaves on any device or with
numpy leaves (`convert.params_from_jax`).

Batch norm normalises with the biased batch variance and updates the
running statistics as mean <- 0.9 mean + 0.1 mu (and the same for var),
by hand: `torch.nn.functional.batch_norm` would store the unbiased
variance.  The products are ±1 float32 matmuls (`torch.matmul`), which
the reference also leaves outside its kernels.

Folding collapses each batch norm into an integer constant C_j:

    BN(y) >= 0  <=>  sign(gamma) * y >= sign(gamma) * (mu - beta*sigma/gamma)
    flip rows where gamma < 0, then X^{l+1} = sign(y' + C_j),
    C_j = round(beta*sigma/|gamma| - mu')
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.binarize import sign_ste

Params = dict[str, Any]

#: the leaves Adam updates; "mean"/"var" come back from the forward
TRAINED = ("w", "gamma", "beta")


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


def bn_layer(w: torch.Tensor, n_out: int) -> dict:
    """One layer's tree: latent `w`, identity batch norm, running stats at
    (0, 1) on `w`'s device and dtype."""
    like = dict(dtype=w.dtype, device=w.device)
    return {"w": w, "gamma": torch.ones(n_out, **like),
            "beta": torch.zeros(n_out, **like),
            "mean": torch.zeros(n_out, **like),
            "var": torch.ones(n_out, **like)}


def glorot(generator: torch.Generator, shape, fan_in: int, fan_out: int,
           dtype=torch.float32) -> torch.Tensor:
    """Glorot-uniform draw in [-lim, lim), lim = sqrt(6 / (fan_in +
    fan_out)), on the generator's device."""
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=dtype, device=generator.device).uniform_(
        -lim, lim, generator=generator)


def init_params(generator: torch.Generator, cfg: MLPConfig,
                dtype=torch.float32) -> Params:
    """Glorot-uniform latent weights + identity BN, running stats at (0,1),
    drawn from `generator` on its device."""
    sizes = cfg.layer_sizes
    return {"layers": [
        bn_layer(glorot(generator, (a, b), a, b, dtype), b)
        for a, b in zip(sizes[:-1], sizes[1:])]}


def batch_norm(y: torch.Tensor, layer: dict, eps: float, momentum: float,
               train: bool, dims) -> tuple[torch.Tensor, dict]:
    """Batch norm over `dims` (channels last): batch statistics with the
    biased variance when training, which also returns the updated running
    statistics (detached); the running statistics otherwise."""
    if train:
        mu = y.mean(dim=dims)
        var = torch.var(y, dim=dims, correction=0)
        stats = {
            "mean": momentum * layer["mean"] + (1 - momentum) * mu.detach(),
            "var": momentum * layer["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mu, var, stats = layer["mean"], layer["var"], {}
    y_hat = (y - mu) / torch.sqrt(var + eps)
    return layer["gamma"] * y_hat + layer["beta"], stats


def forward(params: Params, x_pm1, cfg: MLPConfig, *,
            train: bool = False):
    """Forward pass on ±1 inputs [B, n_in] (moved to the params' device).

    Returns (logits, new_params): full-precision post-BN logits of the
    last layer (training/eval criterion only) and the params with updated
    BN running stats when `train=True` (unchanged otherwise).
    """
    w0 = params["layers"][0]["w"]
    h = torch.as_tensor(x_pm1).to(w0.device, w0.dtype)
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        y = h @ sign_ste(layer["w"])  # the ±1 dot product
        y, stats = batch_norm(y, layer, cfg.bn_eps, cfg.bn_momentum, train,
                              dims=(0,))
        new_layers.append({**layer, **stats})
        if i < cfg.n_layers - 1:
            h = sign_ste(y)  # binary activation between layers
    return y, {**params, "layers": new_layers}


def loss_fn(params: Params, x_pm1, labels, cfg: MLPConfig):
    """Cross-entropy on the (training-only) full-precision logits.
    Returns (loss, params with updated BN running stats)."""
    logits, new_params = forward(params, x_pm1, cfg, train=True)
    labels = torch.as_tensor(labels).to(logits.device, torch.int64)
    return F.cross_entropy(logits, labels), new_params


def to_host(x) -> np.ndarray:
    """A parameter leaf (numpy, or a tensor on any device) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fit(params: Params, loss: Callable, train_x, train_y, *, epochs: int,
        batch: int, lr: float, device,
        after_epoch: Callable[[Params, int], None] | None = None) -> Params:
    """Adam on the latent weights and BN affine terms with [-1, 1]
    clipping of the latent weights only (BinaryConnect); the shared loop
    of `train_mlp` and `convnet.train_cnn`.

    params : a tree {group: [layer dict, ...]}, moved to `device`.
    loss   : loss(params, x, y) -> (scalar, params with new BN stats).
    Batches: `max(n // batch, 1)` steps an epoch (the remainder is
    dropped) over `np.random.default_rng(0)` permutations, the reference's
    order.  Adam is the reference's: bias-corrected, eps outside the
    square root.  `after_epoch(params, epoch)` runs after each epoch.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    x_all = torch.as_tensor(np.asarray(train_x)).to(device)
    y_all = torch.as_tensor(np.asarray(train_y)).to(device)
    params = {g: [{k: v.detach().to(device, copy=True)
                   .requires_grad_(k in TRAINED) for k, v in layer.items()}
                  for layer in ls] for g, ls in params.items()}
    layers = [layer for group in params.values() for layer in group]
    leaves = [layer[k] for layer in layers for k in TRAINED]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    n = x_all.shape[0]
    steps = max(n // batch, 1)
    t = 0
    rng = np.random.default_rng(0)
    for epoch in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        for s in range(steps):
            idx = perm[s * batch:(s + 1) * batch]
            value, new_params = loss(params, x_all[idx], y_all[idx])
            grads = torch.autograd.grad(value, leaves)
            # BN running stats come back through the loss' second output
            params = new_params
            t += 1
            with torch.no_grad():
                for x, mi, vi, g in zip(leaves, m, v, grads):
                    mi.mul_(b1).add_((1 - b1) * g)
                    vi.mul_(b2).add_((1 - b2) * g * g)
                    mh = mi / (1 - b1 ** t)
                    vh = vi / (1 - b2 ** t)
                    x.sub_(lr * mh / (torch.sqrt(vh) + eps))
                for layer in layers:
                    layer["w"].clamp_(-1.0, 1.0)
        if after_epoch is not None:
            after_epoch(params, epoch)
    return {g: [{k: v.detach() for k, v in layer.items()} for layer in ls]
            for g, ls in params.items()}


def train_mlp(generator: torch.Generator, cfg: MLPConfig, train_x,
              train_y, *, epochs: int = 10, batch: int = 128,
              lr: float = 1e-3, verbose: bool = False,
              on_epoch: Callable[[Params, int], None] | None = None,
              device=None) -> Params:
    """Train a binary MLP on ±1 inputs [N, n_in] with labels [N].

    generator : draws the initial params (`init_params`) on its device;
        they then move to `device`.
    verbose : print the training accuracy on 2,048 samples each epoch.
    on_epoch : called with (live params, epoch) after each epoch, e.g. a
        checkpoint's `save_async`.
    device : None -> the CUDA card (raises without CUDA); "cpu" trains on
        the CPU.
    Returns the trained params (tensors on `device`).
    """
    from repro_torch.pipeline import resolve_device  # deferred: no cycle

    dev = resolve_device(device)
    return fit(init_params(generator, cfg),
               lambda p, x, y: loss_fn(p, x, y, cfg), train_x, train_y,
               epochs=epochs, batch=batch, lr=lr, device=dev,
               after_epoch=epoch_hook(
                   verbose, on_epoch, epochs,
                   lambda p: eval_accuracy(p, cfg, train_x[:2048],
                                           train_y[:2048])))


def epoch_hook(verbose: bool, on_epoch, epochs: int, accuracy: Callable):
    """The `after_epoch` of `fit` for the training entry points: the
    verbose report, then the caller's `on_epoch`."""
    def after(params, epoch):
        if verbose:
            print(f"  epoch {epoch + 1}/{epochs}: "
                  f"train-acc(sample)={accuracy(params)['top1']:.4f}")
        if on_epoch is not None:
            on_epoch(params, epoch)
    return after



def topk_accuracy(logits: torch.Tensor, y, topk) -> dict:
    """Top-k accuracy of logits [N, C] against labels [N]; ties break by
    the lower class index, as the reference's stable `jnp.argsort`."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    yt = torch.as_tensor(np.asarray(y)).to(logits.device)[:, None]
    return {f"top{k}": float((order[:, :k] == yt).any(-1).float().mean())
            for k in topk}


def eval_accuracy(params: Params, cfg: MLPConfig, x, y,
                  topk=(1,)) -> dict:
    """Top-k accuracy of the full-precision-logit software path, on the
    params' device."""
    with torch.no_grad():
        logits, _ = forward(params, np.asarray(x), cfg)
    return topk_accuracy(logits, y, topk)


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
    numpy arrays or tensors on any device, `w` as [in, out] latent
    weights.
    """
    folded = []
    for layer in params["layers"]:
        w = np.sign(to_host(layer["w"]))
        w = np.where(w == 0, 1.0, w).T  # [out, in], sign(0) -> +1
        w, c = fold_bn(w, layer, cfg.bn_eps, w.shape[1], cfg.bias_cells)
        folded.append(FoldedLayer(weights_pm1=w, c=c))
    return folded


def fold_bn(w_rows: np.ndarray, layer: Params, eps: float, n_bits: int,
            bias_cells: int) -> tuple[np.ndarray, np.ndarray]:
    """The Eq.-3 BN collapse shared by `fold` and `convnet.fold_cnn`:
    ±1 rows [out, ...] + BN stats -> (int8 rows, parity-adjusted C).

    Rows flip where gamma < 0; C = round(beta*sigma/|gamma| - mu'),
    parity-adjusted against the dot width `n_bits`.
    """
    gamma, beta, mu, var = (to_host(layer[k]).astype(np.float64)
                            for k in ("gamma", "beta", "mean", "var"))
    sigma = np.sqrt(var + eps)
    flip = gamma < 0
    w_rows = np.where(flip.reshape((-1,) + (1,) * (w_rows.ndim - 1)),
                      -w_rows, w_rows)
    thresh = mu - beta * sigma / np.where(gamma == 0, 1e-12, gamma)
    thresh = np.where(flip, -thresh, thresh)
    c = parity_adjust_c(np.round(-thresh).astype(np.int64), n_bits,
                        bias_cells)
    return w_rows.astype(np.int8), c


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
