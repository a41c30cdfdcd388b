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

The selective scan runs the reference's two levels: the time axis in
chunks of `_SCAN_CHUNK` steps, each chunk a loop over its steps with the
[B, d_inner, N] state in float32, the chunks rematerialised
(`models.scan.scan_chunks`): the forward keeps only the state at
each chunk boundary and the backward recomputes one chunk at a time, so
training memory holds S / chunk states, not S.  The tail is padded with
dt = 0, which leaves the state unchanged, so the last state is exact and
every chunk does the same work.  Decode is O(1): one state update per
token and a conv buffer of k-1 taps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _matmul, _normal_, _param
from repro_torch.models.scan import scan_chunks, trip_counter, trips
from repro_torch.sharding import shard
from repro_torch.sharding.rules import as_dtensor, is_dtensor, local

F32 = torch.float32

# time-axis chunk of the two-level selective scan (memory/recompute knob)
_SCAN_CHUNK = 256


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


def mamba_cache_leaves(cfg: ModelConfig, batch: int, dtype=None) -> dict:
    """{leaf: (shape, dtype, fill)} of a mamba sublayer's cache."""
    return {"conv": ((batch, cfg.ssm_conv - 1, cfg.d_inner),
                     dtype or cfg.torch_dtype, 0),
            "h": ((batch, cfg.d_inner, cfg.ssm_state), F32, 0)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None,
                     device=None) -> dict:
    return {k: torch.full(shape, fill, dtype=dt, device=device)
            for k, (shape, dt, fill) in
            mamba_cache_leaves(cfg, batch, dtype).items()}


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv along S. x: [B, S, din], w: [kc, din], b:
    [din] or None (no bias).

    conv_state: [B, kc-1, din], the trailing inputs of the previous
    segment (zeros when None).  Returns (y [B, S, din], new_state).
    """
    s = x.shape[1]
    kc = w.shape[0]
    xp = F.pad(x, (0, 0, kc - 1, 0)) if conv_state is None else \
        torch.cat([conv_state.to(x.dtype), x], dim=1)
    # y[t] = sum_j w[j] * xp[t + j], as shifted adds in float32 (the
    # reference's from 0; 0 + t is t)
    xf, wf = xp.to(F32), w.to(F32)
    y = xf[:, :s, :] * wf[0]
    for j in range(1, kc):
        y = y + xf[:, j:j + s, :] * wf[j]
    if b is not None:
        y = y + b.to(F32)
    new_state = xp[:, s:, :]  # the last kc - 1 inputs
    return y.to(x.dtype), new_state


def _scan_steps(carry, seq, consts):
    """The selective scan over the steps of seq = (dt [B, T, din], B and C
    [B, T, N], x [B, T, din]) from the state carry = (h [B, din, N],),
    a = consts[0] [din, N]: ((h after the last step,), y [B, T, din]).
    The reference's step, h = exp(dt*A) * h + dt * B * x and
    y = (h * C).sum(-1), with the terms that do not depend on h formed
    for all T steps at once; the recurrence itself is `_Recurrence`."""
    (h,), (dt, bmat, cmat, xs), (a,) = carry, seq, consts
    da = torch.exp(dt[..., None] * a)  # [B, T, din, N]
    dbx = dt[..., None] * bmat[:, :, None, :] * xs[..., None]
    hs = _Recurrence.apply(h, da, dbx, trip_counter(dt))
    y = (hs * cmat[:, :, None, :]).sum(-1)
    return (hs[:, -1].clone(),), y


class _Recurrence(torch.autograd.Function):
    """hs[:, t] = da[:, t] * h + dbx[:, t], h the previous state (h0 before
    the first): one multiply-add a step forward, and backward the reverse
    loop g += dL/dhs[:, t]; dL/dda[:, t] = g * h_prev; dL/ddbx[:, t] = g;
    g *= da[:, t], so every step does the same work.  `counter` set
    (`models.scan.trip_counter`: a dry-run's fakes): one step runs,
    charged T times (`trips`)."""

    @staticmethod
    def forward(ctx, h0, da, dbx, counter):
        n = da.shape[1]
        runs = 1 if counter is not None else n
        h, hs = h0, []
        with trips(counter, n):
            for t in range(runs):
                h = da[:, t] * h + dbx[:, t]
                hs.append(h)
        out = torch.stack(hs * (n // runs), dim=1)
        ctx.save_for_backward(h0, da, out)
        ctx.counter = counter
        return out

    @staticmethod
    def backward(ctx, g_hs):
        h0, da, hs = ctx.saved_tensors
        n = da.shape[1]
        runs = 1 if ctx.counter is not None else n
        g = torch.zeros_like(h0)
        g_da, g_dbx = [], []
        with trips(ctx.counter, n):
            for t in reversed(range(n - runs, n)):
                g = g + g_hs[:, t]
                g_da.append(g * (hs[:, t - 1] if t else h0))
                g_dbx.append(g)
                g = g * da[:, t]
        reps = n // runs
        return (g, torch.stack(g_da[::-1] * reps, dim=1),
                torch.stack(g_dbx[::-1] * reps, dim=1), None)


def _selective_scan(dt, bmat, cmat, xs, a, h):
    """The scan over S = dt.shape[1] steps from the state h: decode (S ==
    1) one update, else chunks of `_SCAN_CHUNK` through `scan_chunks`,
    the tail padded with dt = 0 (the state passes through unchanged).
    Returns (y [B, S, din], the last h)."""
    s = dt.shape[1]
    if s == 1:
        (h,), y = _scan_steps((h,), (dt, bmat, cmat, xs), (a,))
        return y, h
    chunk = min(_SCAN_CHUNK, s)
    pad = (-s) % chunk
    seq = (dt, bmat, cmat, xs)
    if pad:
        seq = tuple(F.pad(t, (0, 0, 0, pad)) for t in seq)
    (h,), y = scan_chunks(_scan_steps, (h,), seq, (a,), chunk)
    return y[:, :s], h


# each operand's (batch, d_inner) dims for `_on_shards`, None where it has
# none: [B, S, din], [B, S, N], [B, din, N], [din, N], [kc, din], [din]
_BSD, _BSN, _BDN, _DN, _KD, _D = (0, 2), (0, None), (0, 1), (None, 0), \
    (None, 1), (None, 0)


def _on_shards(fn, dims, outs, *ts):
    """fn(*ts), run on the local shards when ts[0] ([B, S, din]) is a
    DTensor: the conv and the scan are independent across the batch and
    across d_inner, so each rank runs its own part.  Per mesh dim, ts[0]
    split along its batch or d_inner dim splits every operand along its
    own (dims: each one's (batch, d_inner) dims, None where it has none;
    an operand whole there gets a partial-sum gradient), any other
    placement is gathered whole; the outputs come back as DTensors laid
    out by `outs`.  Plain tensors: fn(*ts) as it is."""
    if not is_dtensor(ts[0]):
        return fn(*ts)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = ts[0].device_mesh
    kinds = [0 if q.is_shard(0) else 1 if q.is_shard(2) else None
             for q in ts[0].placements]

    def layout(d):
        at = [None if k is None else d[k] for k in kinds]
        return ([Replicate() if i is None else Shard(i) for i in at],
                [Shard(i) if i is not None else
                 Replicate() if k is None else Partial()
                 for i, k in zip(at, kinds)])

    res = fn(*(None if t is None else local(as_dtensor(t, mesh), *layout(d))
               for t, d in zip(ts, dims)))
    return tuple(DTensor.from_local(r, mesh, layout(d)[0], run_check=False)
                 for r, d in zip(res, outs))


def mamba_block(p: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[dict] = None):
    """x: [B, S, D] -> ([B, S, D], new_cache or None)."""
    bsz, s, _ = x.shape
    din, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank

    xz = _matmul(x, p.in_proj).to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)
    x1 = shard(x1, "batch", "seq", "mlp")

    conv_state = cache["conv"] if cache is not None else None
    x1, new_conv = _on_shards(_causal_conv, (_BSD, _KD, _D, _BSD),
                              (_BSD, _BSD), x1, p.conv_w, p.conv_b,
                              conv_state)
    x1 = F.silu(x1.to(F32)).to(x.dtype)

    xdbc = _matmul(x1.to(F32), p.x_proj.to(F32))
    dt_low, bmat, cmat = torch.split(xdbc, [r, n, n], dim=-1)
    dt = F.softplus(_matmul(dt_low, p.dt_proj.to(F32))
                    + p.dt_bias.to(F32))  # [B, S, din] f32
    a = -torch.exp(p.A_log)  # [din, N] f32

    h = cache["h"] if cache is not None else torch.zeros(
        (bsz, din, n), dtype=F32, device=x.device)
    xs = x1.to(F32)
    y, h = _on_shards(_selective_scan, (_BSD, _BSN, _BSN, _BSD, _DN, _BDN),
                      (_BSD, _BDN), dt, bmat, cmat, xs, a, h)

    y = y + p.D.to(F32) * xs
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    y = shard(y, "batch", "seq", "mlp")
    out = shard(_matmul(y, p.out_proj).to(x.dtype), "batch", "seq", "embed")

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "h": h}
    return out, new_cache


# ---------------------------------------------------------------------------
# Gated short convolution (LFM2's "conv" sublayer)
# ---------------------------------------------------------------------------
class ShortConv(nn.Module):
    """in_proj [d, 3d], conv_w [kc, d] (kc = `cfg.conv_cache`), out_proj
    [d, d]; no biases."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.in_proj = _param((d, 3 * d), cfg, device)
        self.conv_w = _param((cfg.conv_cache, d), cfg, device)
        self.out_proj = _param((d, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        """Every weight normal x fan_in^-0.5 (the conv's fan-in its
        taps)."""
        for w in (self.in_proj, self.conv_w, self.out_proj):
            _normal_((w,), w.shape[0] ** -0.5, generator)


def short_conv_param_axes(cfg: ModelConfig) -> dict:
    return {"in_proj": ("p_ssm_d", None), "conv_w": (None, None),
            "out_proj": (None, "p_ssm_d")}


def short_conv_cache_leaves(cfg: ModelConfig, batch: int) -> dict:
    """{leaf: (shape, dtype, fill)}: the conv's last kc - 1 inputs."""
    return {"conv": ((batch, cfg.conv_cache - 1, cfg.d_model),
                     cfg.torch_dtype, 0)}


def short_conv(p: ShortConv, cfg: ModelConfig, x: torch.Tensor, *,
               cache: Optional[dict] = None):
    """transformers' `Lfm2ShortConv`: B, C, x = chunk(x @ in_proj, 3);
    y = (C * causal_depthwise_conv(B * x)) @ out_proj, the conv through
    `_causal_conv` with the cache's last inputs before x.  x: [B, S, D]
    -> ([B, S, D], new_cache or None)."""
    bcx = _matmul(x, p.in_proj).to(x.dtype)
    gate_b, gate_c, xx = torch.chunk(bcx, 3, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    y, new_conv = _causal_conv(gate_b * xx, p.conv_w, None, conv_state)
    out = _matmul(gate_c * y, p.out_proj).to(x.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype)}
    return out, new_cache
