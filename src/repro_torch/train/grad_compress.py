"""1-bit gradient compression: error-feedback signSGD (EF-signSGD) (port
of `repro/train/grad_compress.py`).

Thematic tie to the paper: PiC-BNN binarizes weights and activations;
EF-signSGD binarizes the *gradient exchange*: each tensor is reduced to
sign bits plus one float32 scale, with the quantization error fed back
into the next step's gradient (Karimireddy et al. 2019).

  * `compress_with_feedback` takes and returns the residual (a dict by
    parameter name, like the gradients);
  * `maybe_compress_grads` is the train step's hook: the identity when
    off, residual-free scaled-sign when on.  Values are quantized
    exactly as the wire format would carry them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train.optimizer import named_params

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    # per-tensor scale: "mean_abs" (signSGD-SI) or "l2" (scaled-sign)
    scale: str = "mean_abs"


def sign_compress(x: torch.Tensor, scale: str = "mean_abs"):
    """x -> (sign as ±1 float32, x >= 0 -> +1; float32 scalar scale)."""
    xf = x.to(F32)
    if scale == "mean_abs":
        s = xf.abs().mean()
    else:
        s = torch.linalg.vector_norm(xf) / math.sqrt(max(xf.numel(), 1))
    return torch.where(xf >= 0, 1.0, -1.0), s


def sign_decompress(bits: torch.Tensor, s: torch.Tensor, dtype=F32):
    return (bits * s).to(dtype)


def compress_with_feedback(grads: dict, residual: dict,
                           scale: str = "mean_abs"):
    """EF-signSGD: quantize (grad + residual); return (g_hat,
    new_residual), both dicts by name."""
    g_hat, new_res = {}, {}
    for k, g in grads.items():
        gf = g.to(F32) + residual[k]
        bits, s = sign_compress(gf, scale)
        g_hat[k] = sign_decompress(bits, s)
        new_res[k] = gf - g_hat[k]
    return g_hat, new_res


def init_residual(params) -> dict:
    """float32 zeros shaped like every parameter (a module or a dict)."""
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in named_params(params).items()}


def maybe_compress_grads(cfg: CompressionConfig, grads: dict):
    """The train step's hook (residual-free scaled-sign).

    The residual-carrying variant (`compress_with_feedback`) is for a
    loop that owns the residual state; inside the plain train step
    scaled-sign without feedback is applied when enabled."""
    if not cfg.enabled:
        return grads, {}
    g_hat = {k: sign_decompress(*sign_compress(g, cfg.scale))
             for k, g in grads.items()}
    first = next(iter(grads.values()))
    return g_hat, {"compressed": torch.ones((), dtype=F32,
                                            device=first.device)}


def compression_ratio(params) -> float:
    """Wire-format ratio vs float32: 1 bit/element + 4 bytes/tensor."""
    leaves = list(named_params(params).values())
    raw = sum(x.numel() * 4 for x in leaves)
    packed = sum(-(-x.numel() // 8) + 4 for x in leaves)
    return raw / packed
