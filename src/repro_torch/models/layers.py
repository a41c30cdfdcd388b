"""Transformer substrate: norms, RoPE, GQA attention, MLP, MoE (port of
`repro/models/layers.py`).

Each layer is an `nn.Module` holding the reference's parameters under
the reference's names (so `convert.lm_params_from_jax` maps every leaf
one to one), a function of the reference's name computing it, and
`*_param_axes` giving each parameter's logical axes.  Activations are
annotated with `sharding.shard` at the reference's sites: the identity
on plain tensors, a redistribution on DTensors under
`sharding.use_rules(rules, mesh)`.

Numerics: parameters live in `cfg.torch_dtype` (bf16 for the full
configs).  A projection runs in the operands' dtype: the library's bf16
product accumulates in float32 and rounds once, which is the
reference's `preferred_element_type=F32` followed by its cast back.
Where the reference keeps a float32 sum of a large projection (q and k
before QK-norm, the logits), the port has that sum rounded to the
operand dtype; the two agree exactly in float32 configs.  Products the
reference takes in float32 on small operands (attention scores and
values, the router, the Mamba x/dt projections) are float32 here too.
Softmax and norms run in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import shard
from repro_torch.sharding.rules import (is_dtensor, logical_axis_size,
                                        sharded_matmul)

F32 = torch.float32
NEG = -1e30  # the reference's masked score


def _param(shape, cfg: ModelConfig, device, dtype=None) -> nn.Parameter:
    """An uninitialised parameter (each module's `draw` fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or cfg.torch_dtype,
                                    device=device))


def _normal_(ws, std: float, generator: torch.Generator) -> None:
    """Fill each parameter with normal draws x std, in its own dtype."""
    with torch.no_grad():
        for w in ws:
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                                dtype=w.dtype) * std)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] in the operands' dtype (float32 accumulation);
    a DTensor weight takes the product of the local shards
    (`sharding.rules.sharded_matmul`)."""
    if is_dtensor(w):
        return sharded_matmul(x, w)
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    """`scale` (and `bias` for layernorm) over d_model."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.scale = _param((cfg.d_model,), cfg, device)
        if cfg.norm == "layernorm":
            self.bias = _param((cfg.d_model,), cfg, device)

    def draw(self, generator=None) -> None:
        """scale 1, bias 0 (no draws)."""
        with torch.no_grad():
            self.scale.fill_(1.0)
            if hasattr(self, "bias"):
                self.bias.zero_()


def apply_norm(p: Norm, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """rmsnorm (eps 1e-6) or layernorm (eps 1e-5, biased variance), in
    float32, cast back to x's dtype."""
    xf = x.to(F32)
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        return (y * p.scale.to(F32)).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * p.scale.to(F32) + p.bias.to(F32)).to(x.dtype)


def _head_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm (chameleon QK-norm), no learned scale."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(cfg: ModelConfig, device=None) -> torch.Tensor:
    half = cfg.head_dim // 2
    exps = -torch.arange(0, half, dtype=F32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=F32, device=device),
                     exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] (or [S]) int.  Split-half
    rotation: the first and second halves of dh are the pair."""
    angles = positions[..., None].to(F32) * inv_freq  # [B, S, half]
    cos = torch.cos(angles)[..., None, :]  # [B, S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal + sliding window, rolling decode cache)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """wq [d, hq, dh], wk / wv [d, hkv, dh], wo [hq, dh, d]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.wq = _param((d, hq, hd), cfg, device)
        self.wk = _param((d, hkv, hd), cfg, device)
        self.wv = _param((d, hkv, hd), cfg, device)
        self.wo = _param((hq, hd, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        """Every projection normal x d_model^-0.5."""
        _normal_((self.wq, self.wk, self.wv, self.wo),
                 self.wq.shape[0] ** -0.5, generator)


def attention_param_axes(cfg: ModelConfig) -> dict:
    return {
        "wq": ("p_attn_d", "p_attn_heads", None),
        "wk": ("p_attn_d", "p_attn_heads", None),
        "wv": ("p_attn_d", "p_attn_heads", None),
        "wo": ("p_attn_heads", None, "p_attn_d"),
    }


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") in the operands' dtype."""
    b, s, _ = h.shape
    return _matmul(h, w.flatten(1)).view(b, s, w.shape[1], w.shape[2])


def _masked_softmax_attention(q, k, v, q_pos, k_pos, window):
    """Causal + window masked softmax attention in float32.

    q: [B, G, R, Sq, dh]; k, v: [B, G, Sk, dh]; q_pos [B, Sq], k_pos
    [B, Sk] absolute positions (-1 = invalid key); attend iff
    0 <= qp - kp < window.  The reference's chunked online softmax
    (`_flash_attention`) computes the same function.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bgrqd,bgcd->bgrqc", q.to(F32) * scale, k.to(F32))
    delta = q_pos[:, None, None, :, None] - k_pos[:, None, None, None, :]
    valid = (delta >= 0) & (delta < window) & (
        k_pos[:, None, None, None, :] >= 0)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrqc,bgcd->bgrqd", p, v.to(F32)).to(q.dtype)


def attention(p: Attention, cfg: ModelConfig, h, positions, inv_freq, *,
              window: int, cache: Optional[dict] = None, cache_index=None):
    """GQA attention sublayer (post-norm input h: [B, S, D]).

    Training / prefill: every in-context key; a given cache is filled
    (the last cache_len positions, rolled so position p sits at slot
    p % cache_len, when the window is shorter than S).  Decode (S == 1
    with a cache): the new k/v/pos are written at slot
    cache_index % cache_len, in place, then the query attends over the
    cache in its stored [B, L, G, dh] layout.

    Returns (out [B, S, D], the cache or None).
    """
    b, s, _ = h.shape
    g, r = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim

    q = _proj_heads(h, p.wq)
    k = _proj_heads(h, p.wk)
    v = _proj_heads(h, p.wv).to(h.dtype)
    if cfg.qk_norm:
        q, k = _head_norm(q.to(F32)), _head_norm(k.to(F32))
    q = apply_rope(q.to(h.dtype), positions, inv_freq)
    k = apply_rope(k.to(h.dtype), positions, inv_freq)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    qg = q.reshape(b, s, g, r, hd).permute(0, 2, 3, 1, 4)  # [B,G,R,S,dh]
    pos = positions.to(torch.int32).expand(b, s)

    if cache is not None and s == 1:
        # ---- decode: write the new kv into the (rolling) cache ----
        slot = int(cache_index) % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = pos[:, 0]
        k_c, v_c, pos_c = cache["k"], cache["v"], cache["pos"]
        # the query scaled and rounded to the model dtype, scores and
        # values as float32 sums of the dtype's products (the reference's
        # bf16 einsums with preferred_element_type=F32)
        scale = hd ** -0.5
        qf = (qg.to(F32) * scale).to(qg.dtype)  # [B, G, R, 1, dh]
        scores = torch.einsum("bgrqd,blgd->bgrql", qf.to(F32), k_c.to(F32))
        delta = pos[:, 0][:, None, None, None, None] \
            - pos_c[:, None, None, None, :]
        valid = (delta >= 0) & (delta < window) & (
            pos_c[:, None, None, None, :] >= 0)
        scores = torch.where(valid, scores, torch.full_like(scores, NEG))
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        out = torch.einsum("bgrql,blgd->bgrqd", probs.to(F32),
                           v_c.to(F32)).to(h.dtype)
    else:
        # ---- train / prefill over the in-context keys ----
        if cache is not None:
            cache_len = cache["k"].shape[1]
            if cache_len >= s:
                cache["k"][:, :s] = k.to(cache["k"].dtype)
                cache["v"][:, :s] = v.to(cache["v"].dtype)
                cache["pos"][:, :s] = pos
            else:  # keep the last cache_len positions (rolling window)
                shift = (s - cache_len) % cache_len
                cache["k"].copy_(torch.roll(k[:, -cache_len:], shift, 1))
                cache["v"].copy_(torch.roll(v[:, -cache_len:], shift, 1))
                cache["pos"].copy_(torch.roll(pos[:, -cache_len:], shift, 1))
        out = _masked_softmax_attention(
            qg, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), pos, pos,
            window)

    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, g * r, hd)
    out = shard(out, "batch", "seq", "heads", None)
    y = _matmul(out.flatten(2), p.wo.flatten(0, 1)).to(h.dtype)
    return shard(y, "batch", "seq", "embed"), cache


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """swiglu: w_gate / w_up [d, f], w_down [f, d]; gelu: w_in, w_out."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp_act == "swiglu":
            self.w_gate = _param((d, f), cfg, device)
            self.w_up = _param((d, f), cfg, device)
            self.w_down = _param((f, d), cfg, device)
        else:
            self.w_in = _param((d, f), cfg, device)
            self.w_out = _param((f, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        _draw_ffn(self, generator)


def mlp_param_axes(cfg: ModelConfig) -> dict:
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": ("p_mlp_d", "p_mlp_f"),
            "w_up": ("p_mlp_d", "p_mlp_f"),
            "w_down": ("p_mlp_f", "p_mlp_d"),
        }
    return {"w_in": ("p_mlp_d", "p_mlp_f"), "w_out": ("p_mlp_f", "p_mlp_d")}


def _draw_ffn(p: nn.Module, generator: torch.Generator) -> None:
    """An MLP's or MoE's projections: those out of d_model (and the
    router) normal x d^-0.5, those into it x d_ff^-0.5."""
    ins = [w for n, w in p.named_parameters() if n in
           ("router", "w_gate", "w_up", "w_in")]
    outs = [w for n, w in p.named_parameters() if n in ("w_down", "w_out")]
    _normal_(ins, ins[0].shape[-2] ** -0.5, generator)
    _normal_(outs, outs[0].shape[-2] ** -0.5, generator)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p: MLP, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.binary_ffn:
        from repro_torch.models.binary_lm import bitlinear_mlp

        return bitlinear_mlp(p, cfg, h)
    if cfg.mlp_act == "swiglu":
        gate = _matmul(h, p.w_gate)
        up = _matmul(h, p.w_up)
        act = shard(F.silu(gate) * up, "batch", "seq", "mlp")
        return shard(_matmul(act, p.w_down).to(h.dtype), "batch", "seq",
                     "embed")
    act = shard(_gelu(_matmul(h, p.w_in)), "batch", "seq", "mlp")
    return shard(_matmul(act, p.w_out).to(h.dtype), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """router [d, E]; experts' w_gate / w_up [E, d, f], w_down [E, f, d]
    (gelu: w_in, w_out)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((d, e), cfg, device)
        if cfg.mlp_act == "swiglu":
            self.w_gate = _param((e, d, f), cfg, device)
            self.w_up = _param((e, d, f), cfg, device)
            self.w_down = _param((e, f, d), cfg, device)
        else:
            self.w_in = _param((e, d, f), cfg, device)
            self.w_out = _param((e, f, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        _draw_ffn(self, generator)


def moe_param_axes(cfg: ModelConfig) -> dict:
    if cfg.mlp_act == "swiglu":
        return {
            "router": (None, None),
            "w_gate": ("p_expert", "p_mlp_d", "p_mlp_f"),
            "w_up": ("p_expert", "p_mlp_d", "p_mlp_f"),
            "w_down": ("p_expert", "p_mlp_f", "p_mlp_d"),
        }
    return {
        "router": (None, None),
        "w_in": ("p_expert", "p_mlp_d", "p_mlp_f"),
        "w_out": ("p_expert", "p_mlp_f", "p_mlp_d"),
    }


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.moe_top_k / cfg.n_experts)
    return max(c, cfg.moe_top_k)


def moe(p: MoE, cfg: ModelConfig, h: torch.Tensor, *,
        aux: Optional[dict] = None) -> torch.Tensor:
    """Capacity-bounded top-k MoE over h: [B, S, D] -> [B, S, D].

    Shard-local dispatch, as the reference's: the T = B*S tokens are cut
    into G groups ([G, T/G, D], G = the data-parallel width
    `logical_axis_size("batch")`, 1 when it does not divide T), and each
    group has its own capacity C = max(int(cf * (T/G) * k / E), k):
    earlier tokens of a group win its slots, overflow is dropped (its
    output 0).  Without a mesh G = 1, one global capacity.  On DTensors
    each rank runs its own groups on local tensors, with the router and
    the experts gathered whole (weight-gathered experts), and the aux
    loss's means taken over every group.  Routing ties: `torch.topk` and
    `jax.lax.top_k` may order equal router probabilities differently,
    but random float router logits make a tie a measure-zero event, so
    the tests never meet one.
    """
    b, s, d = h.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    g = logical_axis_size("batch")
    if t % g != 0:
        g = 1
    tl = t // g  # tokens per group
    cap = max(int(cfg.capacity_factor * tl * k / e), k)
    x = shard(h.reshape(g, tl, d), "batch", None, "embed")
    names = ("router",) + (("w_gate", "w_up", "w_down")
                           if cfg.mlp_act == "swiglu" else ("w_in", "w_out"))
    ws = {n: getattr(p, n) for n in names}
    if not is_dtensor(x):
        y, probs, idx = _moe_groups(x, ws, cfg, cap)
        if aux is not None:
            me = probs.mean((0, 1))  # [E]
            ce = F.one_hot(idx[..., 0], e).to(F32).mean((0, 1))
            aux["moe_aux"] = aux.get("moe_aux", 0.0) + e * (me * ce).sum()
        return y.reshape(b, s, d)

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, pl = x.device_mesh, x.placements
    # where the groups are split, each rank's expert gradients are its
    # groups' part of the sum
    part = [Partial() if isinstance(q, Shard) else Replicate() for q in pl]
    y, probs, idx = _moe_groups(
        x.to_local(), {n: w.full_tensor(grad_placements=part)
                       if is_dtensor(w) else w for n, w in ws.items()},
        cfg, cap)
    if aux is not None:
        # means over every group: local sums, summed over the ranks
        # holding other groups, over the group count
        def total(v):
            return DTensor.from_local(v, mesh, part).full_tensor()

        n = g * tl
        me = total(probs.sum((0, 1))) / n
        ce = total(F.one_hot(idx[..., 0], e).to(F32).sum((0, 1))) / n
        aux["moe_aux"] = aux.get("moe_aux", 0.0) + e * (me * ce).sum()
    # back to [B, S, D]: the groups' split becomes a batch split when it
    # cuts between sequences, else the groups are gathered first
    n = g // y.shape[0]
    if n > 1 and b % n:
        y = DTensor.from_local(y, mesh, pl).full_tensor()
        n, pl = 1, [Replicate()] * mesh.ndim
    y = DTensor.from_local(y.reshape(b // n, s, d), mesh, pl)
    return shard(y, "batch", "seq", "embed")


def _moe_groups(x: torch.Tensor, ws: dict, cfg: ModelConfig, cap: int):
    """Dispatch, experts and combine over plain groups x [G, Tl, D] with
    per-group capacity `cap`.  Returns (y [G, Tl, D], router probs
    [G, Tl, E], top-k indices [G, Tl, k])."""
    g, tl, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.matmul(x.to(F32), ws["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)  # [G, Tl, k], descending
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat = F.one_hot(idx, e).reshape(g, tl * k, e)  # [G, Tl*k, E]
    # priority order within the group: earlier tokens win capacity slots
    slot = ((torch.cumsum(flat, 1) - flat) * flat).sum(-1)  # [G, Tl*k]
    e_sel = idx.reshape(g, tl * k)
    keep = slot < cap
    gi = torch.arange(g, device=x.device)[:, None].expand(g, tl * k)
    sel = (gi[keep], e_sel[keep], slot[keep])

    xrep = x[:, :, None, :].expand(g, tl, k, d).reshape(g, tl * k, d)
    buf = torch.zeros((g, e, cap, d), dtype=x.dtype, device=x.device)
    buf[sel] = xrep[keep]
    # the experts' products over every group's slots at once: [E, G*C, D]
    be = buf.transpose(0, 1).reshape(e, g * cap, d)

    if cfg.mlp_act == "swiglu":
        g_ = torch.bmm(be, ws["w_gate"]).to(F32)
        u_ = torch.bmm(be, ws["w_up"]).to(F32)
        a_ = (F.silu(g_) * u_).to(x.dtype)
        o_ = torch.bmm(a_, ws["w_down"]).to(x.dtype)
    else:
        a_ = _gelu(torch.bmm(be, ws["w_in"]).to(F32)).to(x.dtype)
        o_ = torch.bmm(a_, ws["w_out"]).to(x.dtype)
    o_ = o_.view(e, g, cap, d).transpose(0, 1)

    y_slots = torch.zeros((g, tl * k, d), dtype=x.dtype, device=x.device)
    y_slots[keep] = o_[sel]
    y_slots = (y_slots.to(F32) * gate.reshape(g, tl * k, 1)).to(x.dtype)
    return y_slots.reshape(g, tl, k, d).sum(2), probs, idx
