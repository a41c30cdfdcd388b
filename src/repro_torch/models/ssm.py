"""Mamba-1 (selective state space) block (port of `repro/models/ssm.py`):
the attention-free substrate of falcon-mamba-7b and the mamba sublayers
of jamba.

Layout per block (Gu & Dao 2023, mamba_simple):
    x  --in_proj--> [x1 | z]           (d_model -> 2 * d_inner)
    x1 --causal depthwise conv(k=4)--> silu
    x1 --x_proj--> [dt_lowrank | B | C]
    dt = softplus(dt_lowrank @ dt_proj + dt_bias)          [*, d_inner]
    h_t = exp(dt*A) * h_{t-1} + dt * B_t * x_t             (selective scan)
    y   = C_t . h_t + D * x1
    out = (y * silu(z)) @ out_proj

The selective scan is a plain loop over time with the [B, d_inner, N]
state in float32: the reference's chunked, rematerialised scan computes
the same recurrence and exists to bound training memory.  Decode is
O(1): one state update per token and a conv buffer of k-1 taps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _matmul, _normal_, _param
from repro_torch.sharding import shard

F32 = torch.float32


class Mamba(nn.Module):
    """in_proj [d, 2*din], conv_w [kc, din], conv_b [din], x_proj
    [din, r + 2N], dt_proj [r, din], dt_bias [din], A_log [din, N] and D
    [din] (both float32), out_proj [din, d]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        r, kc = cfg.dt_rank, cfg.ssm_conv
        self.in_proj = _param((d, 2 * din), cfg, device)
        self.conv_w = _param((kc, din), cfg, device)
        self.conv_b = _param((din,), cfg, device)
        self.x_proj = _param((din, r + 2 * n), cfg, device)
        self.dt_proj = _param((r, din), cfg, device)
        self.dt_bias = _param((din,), cfg, device)
        self.A_log = _param((din, n), cfg, device, F32)
        self.D = _param((din,), cfg, device, F32)
        self.out_proj = _param((din, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        """The reference's distributions: projections normal x
        fan_in^-0.5, conv_b 0, dt_bias -4.6 (softplus^-1(0.01)), A_log =
        log(1..N) over d_inner (S4D-real), D = 1."""
        for w in (self.in_proj, self.conv_w, self.x_proj, self.dt_proj,
                  self.out_proj):
            _normal_((w,), w.shape[0] ** -0.5, generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.fill_(-4.6)
            n = self.A_log.shape[1]
            self.A_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=F32, device=self.A_log.device)))
            self.D.fill_(1.0)


def mamba_param_axes(cfg: ModelConfig) -> dict:
    return {
        "in_proj": ("p_ssm_d", "p_ssm_inner"),
        "conv_w": (None, "p_ssm_inner"),
        "conv_b": ("p_ssm_inner",),
        "x_proj": ("p_ssm_inner", None),
        "dt_proj": (None, "p_ssm_inner"),
        "dt_bias": ("p_ssm_inner",),
        "A_log": ("p_ssm_inner", None),
        "D": ("p_ssm_inner",),
        "out_proj": ("p_ssm_inner", "p_ssm_d"),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None,
                     device=None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype or cfg.torch_dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=F32,
                         device=device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv along S. x: [B, S, din], w: [kc, din].

    conv_state: [B, kc-1, din], the trailing inputs of the previous
    segment (zeros when None).  Returns (y [B, S, din], new_state).
    """
    bsz, s, din = x.shape
    kc = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((bsz, kc - 1, din), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    # y[t] = sum_j w[j] * xp[t + j], as shifted adds in float32
    y = torch.zeros((bsz, s, din), dtype=F32, device=x.device)
    for j in range(kc):
        y = y + xp[:, j:j + s, :].to(F32) * w[j].to(F32)
    y = y + b.to(F32)
    new_state = xp[:, -(kc - 1):, :] if kc > 1 else conv_state
    return y.to(x.dtype), new_state


def mamba_block(p: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[dict] = None):
    """x: [B, S, D] -> ([B, S, D], new_cache or None)."""
    bsz, s, _ = x.shape
    din, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank

    xz = _matmul(x, p.in_proj).to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)
    x1 = shard(x1, "batch", "seq", "mlp")

    conv_state = cache["conv"] if cache is not None else None
    x1, new_conv = _causal_conv(x1, p.conv_w, p.conv_b, conv_state)
    x1 = F.silu(x1.to(F32)).to(x.dtype)

    xdbc = _matmul(x1.to(F32), p.x_proj.to(F32))
    dt_low, bmat, cmat = torch.split(xdbc, [r, n, n], dim=-1)
    dt = F.softplus(_matmul(dt_low, p.dt_proj.to(F32))
                    + p.dt_bias.to(F32))  # [B, S, din] f32
    a = -torch.exp(p.A_log)  # [din, N] f32

    h = cache["h"] if cache is not None else torch.zeros(
        (bsz, din, n), dtype=F32, device=x.device)
    xs = x1.to(F32)
    ys = []
    for i in range(s):
        dt_t = dt[:, i]  # [B, din]
        h = torch.exp(dt_t[:, :, None] * a) * h \
            + dt_t[:, :, None] * bmat[:, i][:, None, :] * xs[:, i][:, :, None]
        ys.append((h * cmat[:, i][:, None, :]).sum(-1))  # [B, din]
    y = torch.stack(ys, dim=1)

    y = y + p.D.to(F32) * xs
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    y = shard(y, "batch", "seq", "mlp")
    out = shard(_matmul(y, p.out_proj).to(x.dtype), "batch", "seq", "embed")

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "h": h}
    return out, new_cache
