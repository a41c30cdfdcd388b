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

import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import expert_ffn
from repro_torch.kernels import rows as row_ops
from repro_torch.models.scan import scan_chunks
from repro_torch.sharding import shard
from repro_torch.sharding.rules import (as_dtensor, cut, is_dtensor, keep,
                                        local, logical_axis_size, shard_range,
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
    """rmsnorm (eps `cfg.norm_eps`, 1e-6 but for the port-only
    architectures; `kernels.rows.rms_norm`: one launch on the card's bf16
    rows at inference, the same formula in float32 elsewhere) or layernorm
    (eps 1e-5, biased variance), in float32, cast back to x's dtype."""
    if cfg.norm == "rmsnorm":
        return row_ops.rms_norm(x, p.scale, cfg.norm_eps)
    xf = x.to(F32)
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
    # theta filled on the device: a copy from the host would wait for
    # the work queued on the stream, and a CUDA graph's capture refuses it
    return torch.pow(torch.full((), cfg.rope_theta, dtype=F32, device=device),
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
# Attention (GQA, chunked online softmax, causal + sliding window, rolling
# decode cache)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """wq [d, hq, dh], wk / wv [d, hkv, dh], wo [hq, dh, d]; with
    `cfg.qk_norm_scale` the QK-norm scales q_norm / k_norm [dh]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.wq = _param((d, hq, hd), cfg, device)
        self.wk = _param((d, hkv, hd), cfg, device)
        self.wv = _param((d, hkv, hd), cfg, device)
        self.wo = _param((hq, hd, d), cfg, device)
        if cfg.qk_norm_scale:
            self.q_norm = _param((hd,), cfg, device)
            self.k_norm = _param((hd,), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        """Every projection normal x d_model^-0.5; QK-norm scales 1."""
        _normal_((self.wq, self.wk, self.wv, self.wo),
                 self.wq.shape[0] ** -0.5, generator)
        if hasattr(self, "q_norm"):
            with torch.no_grad():
                self.q_norm.fill_(1.0)
                self.k_norm.fill_(1.0)


def attention_param_axes(cfg: ModelConfig) -> dict:
    axes = {
        "wq": ("p_attn_d", "p_attn_heads", None),
        "wk": ("p_attn_d", "p_attn_heads", None),
        "wv": ("p_attn_d", "p_attn_heads", None),
        "wo": ("p_attn_heads", None, "p_attn_d"),
    }
    if cfg.qk_norm_scale:
        axes.update(q_norm=(None,), k_norm=(None,))
    return axes


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") in the operands' dtype."""
    b, s, _ = h.shape
    return _matmul(h, w.flatten(1)).view(b, s, w.shape[1], w.shape[2])


class _ChunkScope(threading.local):
    depth = 0


_CHUNK_SCOPE = _ChunkScope()


def in_chunk_body() -> bool:
    """Whether an attention chunk's body is running on this thread (remat
    "dots" saves no product made there: `models.model._save_dots`)."""
    return _CHUNK_SCOPE.depth > 0


def _attention_chunk(m, l, acc, qf, k_i, v_i, q_pos, kp_i, window: int,
                     in_place: bool = False):
    """One key chunk of the online softmax: scores of qf [B, G, R, Sq, dh]
    (float32, scaled) against k_i [B, C, G, dh] in float32, masked to
    0 <= qp - kp < window with kp >= 0, folded into the running max m,
    sum l [B, G, R, Sq] and acc [B, G, R, Sq, dh] with the exp(m - m_new)
    correction.  v_i [B, C, G, dh]; kp_i [B, C] int32.  `in_place` (the
    loop without autograd or remat) masks, shifts and exponentiates the
    scores in place: one score tensor live, not four.  Grad mode cannot
    tell: `scan_chunks` runs its forward without grad, and under remat
    "dots" a selective checkpoint refuses tensors changed in place."""
    _CHUNK_SCOPE.depth += 1
    try:
        s = torch.einsum("bgrqd,bcgd->bgrqc", qf, k_i.to(F32))
        delta = q_pos[:, None, None, :, None] - kp_i[:, None, None, None, :]
        valid = (delta >= 0) & (delta < window) & (
            kp_i[:, None, None, None, :] >= 0)
        if in_place:
            s.masked_fill_(valid.logical_not(), NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = s.sub_(m_new[..., None]).exp_()
        else:
            s = torch.where(valid, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l_new = l * correction + p.sum(-1)
        acc_new = acc * correction[..., None] + torch.einsum(
            "bgrqc,bcgd->bgrqd", p, v_i.to(F32))
        return m_new, l_new, acc_new
    finally:
        _CHUNK_SCOPE.depth -= 1


def _attention_scan_body(window: int, carry, xs, consts):
    """`_attention_chunk` as a `scan_chunks` body: carry (m, l, acc), xs
    one chunk of (k, v, k_pos), consts (qf, q_pos); no per-chunk output."""
    (m, l, acc), (k_i, v_i, kp_i), (qf, q_pos) = carry, xs, consts
    return _attention_chunk(m, l, acc, qf, k_i, v_i, q_pos, kp_i,
                            window), None


def _whole(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """A DTensor x with none of `dims` split (each mesh dim splitting one
    replicated); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    pl = keep(x.placements, lambda q: not (q.is_shard() and q.dim in dims))
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _chunked_attention(qf, k, v, q_pos, k_pos, window: int, chunk: int,
                       dtype):
    """Chunked online-softmax attention with causal + window masking (the
    reference's `_flash_attention`).

    qf: [B, G, R, Sq, dh] float32, already scaled by dh^-0.5; k, v:
    [B, Sk, G, dh] in their stored layout (a decode cache as it is);
    q_pos [B, Sq], k_pos [B, Sk] int32 absolute positions (-1 = invalid
    key); attend iff 0 <= qp - kp < window.  The keys are read in chunks
    of `chunk` positions, the last one padded with position -1, so the
    only float32 temporaries are one chunk's [B, G, R, Sq, chunk] scores
    and its slice of k and v.  Without autograd each chunk is a view (a
    decode cache is read as it is stored).  Under autograd the chunks
    run rematerialised through `models.scan.scan_chunks`, as the
    reference's body runs under `jax.checkpoint`: the backward recomputes
    a chunk's scores from its (m, l, acc) carries, which are all that is
    kept.  Returns [B, G, R, Sq, dh] in `dtype`.
    """
    # DTensors here (the ranks cannot attend on their own shards, as over
    # a split kv sequence): the chunk's einsums fold (b, g) into one batch
    # dim, through which DTensor cannot carry a split of g (a strided
    # shard), so the head dims are made whole first; a split key sequence
    # is gathered once here, not once a chunk by the chunks' slices
    qf = _whole(qf, (1, 2))
    k, v, k_pos = _whole(k, (1, 2)), _whole(v, (1, 2)), _whole(k_pos, (1,))
    b, g, r, sq, dh = qf.shape
    sk = k.shape[1]
    n = -(-sk // chunk)
    m = torch.full((b, g, r, sq), NEG, dtype=F32, device=qf.device)
    l = torch.zeros((b, g, r, sq), dtype=F32, device=qf.device)
    acc = torch.zeros((b, g, r, sq, dh), dtype=F32, device=qf.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qf, k, v)):
        pad = n * chunk - sk
        if pad:  # padded keys sit at position -1, masked
            k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
            k_pos = F.pad(k_pos, (0, pad), value=-1)
        (m, l, acc), _ = scan_chunks(
            functools.partial(_attention_scan_body, window), (m, l, acc),
            (k, v, k_pos), (qf, q_pos), chunk)
    else:
        for i in range(n):
            k_i = k[:, i * chunk:(i + 1) * chunk]
            v_i = v[:, i * chunk:(i + 1) * chunk]
            kp_i = k_pos[:, i * chunk:(i + 1) * chunk]
            pad = chunk - k_i.shape[1]
            if pad:  # the tail
                k_i = F.pad(k_i, (0, 0, 0, 0, 0, pad))
                v_i = F.pad(v_i, (0, 0, 0, 0, 0, pad))
                kp_i = F.pad(kp_i, (0, pad), value=-1)
            m, l, acc = _attention_chunk(m, l, acc, qf, k_i, v_i, q_pos,
                                         kp_i, window, in_place=True)
    return (acc / l.clamp_min(1e-30)[..., None]).to(dtype)


def _local_attention_plan(q, k, v, cache):
    """(mesh, q's placements, the batch rows' placements) when q, k, v
    and the cache are DTensors split only along the batch or along whole
    kv-head groups, each the same way (each rank then attends with its
    own shards); else None (plain tensors, a split kv sequence)."""
    if not is_dtensor(q):
        return None
    ts = [q, k, v] + ([] if cache is None else [cache["k"], cache["v"]])
    if not all(is_dtensor(t) and t.device_mesh == q.device_mesh for t in ts):
        return None
    rows = keep(q.placements, lambda qp: qp.is_shard(0))
    for i, qp in enumerate(q.placements):
        if any(t.placements[i] != qp for t in ts) or not (
                qp.is_replicate() or qp.is_shard(0) or qp.is_shard(2)):
            return None
        if cache is not None and cache["pos"].placements[i] != rows[i]:
            return None
    return q.device_mesh, q.placements, rows


def _cache_write(t: torch.Tensor, start: int, x: torch.Tensor) -> None:
    """t[:, start:start + x.shape[1]] = x, in place, in t's dtype.  On a
    DTensor t each rank writes the positions of that slice it holds into
    its local shard (x laid out as t with its dim 1 whole; a plain x is
    the same on every rank), so a cache split along its sequence keeps
    what is written."""
    n = x.shape[1]
    if not is_dtensor(t):
        t[:, start:start + n] = x.to(t.dtype)
        return
    mesh = t.device_mesh
    xl = cut(x, mesh, keep(t.placements, lambda q: not q.is_shard(1)))
    lo, size = shard_range(t, 1)
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        t.to_local()[:, a - lo:b - lo] = xl[:, a - start:b - start].to(
            t.dtype)


def _attend(q, k, v, pos, cache, cache_index, window, chunk, dtype):
    """The attention core of `attention`: q [B, S, H, dh] over k, v
    [B, S, G, dh] at positions pos [B, S], filling or reading the cache,
    keys in chunks of `chunk` (`_chunked_attention`) -> out
    [B, S, H, dh] in `dtype`."""
    b, s, hq, hd = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, hq // g, hd).permute(0, 2, 3, 1, 4)  # [B,G,R,S,dh]

    if cache is not None and s == 1:
        # ---- decode: write the new kv into the (rolling) cache ----
        slot = int(cache_index) % cache["k"].shape[1]
        for name, t in (("k", k), ("v", v), ("pos", pos)):
            _cache_write(cache[name], slot, t)
        # the query scaled and rounded to the model dtype (the
        # reference's decode); the cache is read in its stored layout a
        # chunk at a time, each slice's scores and values float32 sums
        # of the dtype's products, never a float32 copy of the whole cache
        qf = (qg.to(F32) * hd ** -0.5).to(qg.dtype).to(F32)
        out = _chunked_attention(qf, cache["k"], cache["v"], pos,
                                 cache["pos"], window,
                                 min(chunk, cache["k"].shape[1]), dtype)
    else:
        # ---- train / prefill over the in-context keys ----
        if cache is not None:
            cache_len = cache["k"].shape[1]
            for name, t in (("k", k), ("v", v), ("pos", pos)):
                if cache_len < s:  # keep the last cache_len (rolling window)
                    t = torch.roll(t[:, -cache_len:],
                                   (s - cache_len) % cache_len, 1)
                _cache_write(cache[name], 0, t)
        out = _chunked_attention(qg.to(F32) * hd ** -0.5, k, v, pos, pos,
                                 window, min(chunk, s), q.dtype)

    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)


def attention(p: Attention, cfg: ModelConfig, h, positions, inv_freq, *,
              window: int, cache: Optional[dict] = None, cache_index=None):
    """GQA attention sublayer (post-norm input h: [B, S, D]).

    Training / prefill: every in-context key, `cfg.attn_chunk` keys at a
    time (`_chunked_attention`); a given cache is filled (the last
    cache_len positions, rolled so position p sits at slot
    p % cache_len, when the window is shorter than S).  Decode (S == 1
    with a cache): the new k/v/pos are written at slot
    cache_index % cache_len, in place, then the query attends over the
    cache in its stored [B, L, G, dh] layout, a chunk at a time.

    Returns (out [B, S, D], the cache or None).
    """
    b, s, _ = h.shape
    g = cfg.n_kv_heads

    q = _proj_heads(h, p.wq)
    k = _proj_heads(h, p.wk)
    v = _proj_heads(h, p.wv).to(h.dtype)
    if cfg.qk_norm_scale:  # LFM2's: RMS norms of learned scale a head
        q = row_ops.rms_norm(q.to(h.dtype), p.q_norm, cfg.norm_eps)
        k = row_ops.rms_norm(k.to(h.dtype), p.k_norm, cfg.norm_eps)
    elif cfg.qk_norm:
        q, k = _head_norm(q.to(F32)), _head_norm(k.to(F32))
    q = apply_rope(q.to(h.dtype), positions, inv_freq)
    k = apply_rope(k.to(h.dtype), positions, inv_freq)
    q = shard(q, "batch", "seq", "heads", None)
    if g % logical_axis_size("heads"):
        # a heads split that the [G, R] view cannot carry (fewer kv heads
        # than the axis splits): the query whole, as the kv heads are
        q = shard(q, "batch", "seq", None, None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    pos = positions.to(torch.int32).expand(b, s)
    plan = _local_attention_plan(q, k, v, cache)
    if plan is None:
        out = _attend(q, k, v, pos, cache, cache_index, window,
                      cfg.attn_chunk, h.dtype)
    else:
        # every split is of the batch or of whole kv-head groups: each
        # rank attends with its own shards
        from torch.distributed.tensor import DTensor

        mesh, pl, rows = plan
        out = _attend(q.to_local(), k.to_local(), v.to_local(),
                      local(as_dtensor(pos, mesh), rows),
                      None if cache is None else {n: t.to_local()
                                                  for n, t in cache.items()},
                      cache_index, window, cfg.attn_chunk, h.dtype)
        out = DTensor.from_local(out, mesh, pl, run_check=False)

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
    (gelu: w_in, w_out), f the experts' width (`cfg.expert_d_ff`, else
    d_ff); with the "sigmoid_bias" router the float32 buffer expert_bias
    [E], which steers the selection and never the gates."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.expert_d_ff or cfg.d_ff, cfg.n_experts
        self.router = _param((d, e), cfg, device)
        if cfg.moe_router == "sigmoid_bias":
            self.register_buffer("expert_bias", torch.empty(
                (e,), dtype=F32, device=device))
        if cfg.mlp_act == "swiglu":
            self.w_gate = _param((e, d, f), cfg, device)
            self.w_up = _param((e, d, f), cfg, device)
            self.w_down = _param((e, f, d), cfg, device)
        else:
            self.w_in = _param((e, d, f), cfg, device)
            self.w_out = _param((e, f, d), cfg, device)

    def draw(self, generator: torch.Generator) -> None:
        """The projections as `_draw_ffn`; expert_bias 0 (the published
        initial value)."""
        _draw_ffn(self, generator)
        if hasattr(self, "expert_bias"):
            self.expert_bias.zero_()


def moe_param_axes(cfg: ModelConfig) -> dict:
    bias = ({"expert_bias": (None,)} if cfg.moe_router == "sigmoid_bias"
            else {})
    if cfg.mlp_act == "swiglu":
        return {
            "router": (None, None),
            "w_gate": ("p_expert", "p_mlp_d", "p_mlp_f"),
            "w_up": ("p_expert", "p_mlp_d", "p_mlp_f"),
            "w_down": ("p_expert", "p_mlp_f", "p_mlp_d"),
        } | bias
    return {
        "router": (None, None),
        "w_in": ("p_expert", "p_mlp_d", "p_mlp_f"),
        "w_out": ("p_expert", "p_mlp_f", "p_mlp_d"),
    } | bias


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """`F.one_hot(idx, n)` (int64) as a compare against arange(n): the
    same ops on real tensors and on a dry-run's fakes (`F.one_hot` takes
    another path on fake ones, so their counts would differ)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


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

    With `cfg.moe_dropless` (port-only architectures), autograd off and
    plain tensors, every routed slot is computed instead
    (`_moe_dropless`); the capacity path serves training, with float
    experts only (binary experts, `cfg.binary_experts`, raise there).
    """
    b, s, d = h.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    names = ("router",) + (("w_gate", "w_up", "w_down")
                           if cfg.mlp_act == "swiglu" else ("w_in", "w_out"))
    if cfg.moe_router == "sigmoid_bias":
        names += ("expert_bias",)
    ws = {n: getattr(p, n) for n in names}
    if cfg.moe_dropless and not torch.is_grad_enabled() \
            and not is_dtensor(h):
        return _moe_dropless(p, ws, cfg, h)
    if cfg.binary_ffn and cfg.binary_experts:
        raise NotImplementedError(
            "binary experts run on the dropless path only: autograd off, "
            "plain tensors")
    g = logical_axis_size("batch")
    if t % g != 0:
        g = 1
    tl = t // g  # tokens per group
    cap = max(int(cfg.capacity_factor * tl * k / e), k)
    x = shard(h.reshape(g, tl, d), "batch", None, "embed")
    if not is_dtensor(x):
        y, probs, idx = _moe_groups(x, ws, cfg, cap)
        if aux is not None:
            me = probs.mean((0, 1))  # [E]
            ce = one_hot(idx[..., 0], e).to(F32).mean((0, 1))
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
        ce = total(one_hot(idx[..., 0], e).to(F32).sum((0, 1))) / n
        aux["moe_aux"] = aux.get("moe_aux", 0.0) + e * (me * ce).sum()
    # back to [B, S, D]: the groups' split becomes a batch split when it
    # cuts between sequences, else the groups are gathered first
    n = g // y.shape[0]
    if n > 1 and b % n:
        y = DTensor.from_local(y, mesh, pl).full_tensor()
        n, pl = 1, [Replicate()] * mesh.ndim
    y = DTensor.from_local(y.reshape(b // n, s, d), mesh, pl)
    return shard(y, "batch", "seq", "embed")


def _route(x: torch.Tensor, ws: dict, cfg: ModelConfig):
    """The router on x [..., D], in float32: (scores [..., E], gates
    [..., k], chosen experts [..., k]).  "softmax": the top-k of the
    softmax, gates renormalised over them.  "sigmoid_bias" (LFM2):
    s = sigmoid(x @ router), the top-k of s + expert_bias chosen, the
    gates the chosen s (without the bias) over their sum + 1e-6."""
    k = cfg.moe_top_k
    logits = torch.matmul(x.to(F32), ws["router"].to(F32))
    if cfg.moe_router == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        idx = torch.topk(scores + ws["expert_bias"].to(F32), k,
                         dim=-1).indices
        gate = scores.gather(-1, idx)
        return scores, gate / (gate.sum(-1, keepdim=True) + 1e-6), idx
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)  # [..., k], descending
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _moe_groups(x: torch.Tensor, ws: dict, cfg: ModelConfig, cap: int):
    """Dispatch, experts and combine over plain groups x [G, Tl, D] with
    per-group capacity `cap`.  Returns (y [G, Tl, D], router probs
    [G, Tl, E], top-k indices [G, Tl, k])."""
    g, tl, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    probs, gate, idx = _route(x, ws, cfg)

    flat = one_hot(idx, e).reshape(g, tl * k, e)  # [G, Tl*k, E]
    # priority order within the group: earlier tokens win capacity slots
    slot = ((torch.cumsum(flat, 1) - flat) * flat).sum(-1)  # [G, Tl*k]
    e_sel = idx.reshape(g, tl * k)
    # overflow goes to a spare slot `cap`, written and read as zeros and
    # never computed: every index has a static shape (no boolean mask)
    slot = slot.masked_fill(slot >= cap, cap)
    gi = torch.arange(g, device=x.device)[:, None].expand(g, tl * k)
    sel = (gi, e_sel, slot)

    xrep = x[:, :, None, :].expand(g, tl, k, d).reshape(g, tl * k, d)
    buf = torch.zeros((g, e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[sel] = xrep
    # the experts' products over every group's slots at once: [E, G*C, D]
    be = buf[:, :, :cap].transpose(0, 1).reshape(e, g * cap, d)

    if cfg.mlp_act == "swiglu":
        g_ = torch.bmm(be, ws["w_gate"]).to(F32)
        u_ = torch.bmm(be, ws["w_up"]).to(F32)
        a_ = (F.silu(g_) * u_).to(x.dtype)
        o_ = torch.bmm(a_, ws["w_down"]).to(x.dtype)
    else:
        a_ = _gelu(torch.bmm(be, ws["w_in"]).to(F32)).to(x.dtype)
        o_ = torch.bmm(a_, ws["w_out"]).to(x.dtype)
    o_ = F.pad(o_.view(e, g, cap, d).transpose(0, 1), (0, 0, 0, 1))

    y_slots = o_[sel]  # [G, Tl*k, D]; the spare slot's zeros where dropped
    y_slots = (y_slots.to(F32) * gate.reshape(g, tl * k, 1)).to(x.dtype)
    return y_slots.reshape(g, tl, k, d).sum(2), probs, idx


def _moe_dropless(p: MoE, ws: dict, cfg: ModelConfig,
                  h: torch.Tensor) -> torch.Tensor:
    """The MoE at inference with no capacity: all T * k routed slots,
    sorted by expert (token order within an expert), offsets [E + 1]
    marking each expert's run.  Under `+binary-ffn` with
    `cfg.binary_experts` the experts are kernel 1's grouped entry, one
    launch for gate and up and one for down over every expert
    (`binary_lm.grouped_bitlinear_ffn`); else float experts, one product
    each.  Each token's output is the gate-weighted sum of its k slots',
    in float32, cast to h's dtype (`kernels.expert_ffn`).
    h: [B, S, D] -> [B, S, D]."""
    b, s, d = h.shape
    t, e, k = b * s, cfg.n_experts, cfg.moe_top_k
    x = h.reshape(t, d)
    with obs.span("moe.route"):
        _, gate, idx = _route(x, ws, cfg)
        chosen = idx.reshape(t * k)
        order = torch.argsort(chosen, stable=True)  # sorted slot -> slot
        expert = chosen[order]  # each sorted slot's expert
        # each expert's first slot, found on the card (a bincount would
        # read the largest id back to the host)
        offsets = torch.searchsorted(
            expert, torch.arange(e + 1, device=x.device)).to(torch.int32)
        tok = order // k  # each sorted slot's token
        if obs.enabled():  # (reading the loads waits for the card)
            loads = offsets.diff()
            lo, hi, hit = (int(v) for v in torch.stack(
                [loads.min(), loads.max(), (loads > 0).sum()]).tolist())
            obs.count(tokens=t, max_load=hi, min_load=lo, experts_hit=hit)
    binary = cfg.binary_ffn and cfg.binary_experts
    with obs.span("moe.experts"):
        if binary:
            from repro_torch.models.binary_lm import grouped_bitlinear_ffn

            down = grouped_bitlinear_ffn(p, x, tok, expert, offsets)
        else:
            y_sorted = x.new_empty((t * k, d))
            bounds = offsets.tolist()
            for j in range(e):
                lo, hi = bounds[j], bounds[j + 1]
                if hi > lo:
                    y_sorted[lo:hi] = _expert_ffn(x[tok[lo:hi]], ws, cfg, j)
    with obs.span("moe.combine"):
        back = torch.empty_like(order)
        back[order] = torch.arange(t * k, device=x.device)
        if binary:
            hd, alpha, beta, f = down
            y = expert_ffn.combine(hd, alpha, beta, expert, back, gate, f)
        else:
            y = expert_ffn.combine_values(y_sorted, back, gate)
        return y.view(b, s, d)


def _expert_ffn(x: torch.Tensor, ws: dict, cfg: ModelConfig,
                j: int) -> torch.Tensor:
    """Float expert j on its rows x [n, D], as `_moe_groups` computes
    each slot."""
    if cfg.mlp_act == "swiglu":
        g_ = torch.matmul(x, ws["w_gate"][j]).to(F32)
        u_ = torch.matmul(x, ws["w_up"][j]).to(F32)
        a_ = (F.silu(g_) * u_).to(x.dtype)
        return torch.matmul(a_, ws["w_down"][j]).to(x.dtype)
    a_ = _gelu(torch.matmul(x, ws["w_in"][j]).to(F32)).to(x.dtype)
    return torch.matmul(a_, ws["w_out"][j]).to(x.dtype)
