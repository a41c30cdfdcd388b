"""Plain reference for LFM2-8B-A1B (`model_type` "lfm2_moe"): the forward
pass of transformers' `Lfm2MoeForCausalLM` in plain PyTorch, float32,
every layer computed as the equations state it, with no kernel, cache or
batching trick.  It imports nothing of the program.

Departures from the published model, each deliberate:

- the FFNs are binarised (the program's `+binary-ffn`, the paper's
  technique): every projection of the dense FFNs and of the experts is
  BitLinear, the float ±1 product sign(x) @ sign(w) * alpha * beta with
  alpha = E|w| a column, beta = E|x| a row, and sign(0) = +1;
- the expert bias, zero at the published initialisation, is drawn from
  the run's seed, so that it changes which experts are chosen;
- the embeddings are tied (config.json does not give
  `tie_word_embeddings`; the class's default is tied).

Each layer: h = x + op(operator_norm(x)), out = h + ffn(ffn_norm(h)),
op the gated short conv (B, C, x = chunk(x @ in_proj, 3); y = (C *
causal_depthwise_conv_L(B * x)) @ out_proj) or GQA attention with RMS
norms of learned scale on each head's q and k before RoPE (split-half
rotation, theta from the config); ffn a SwiGLU (silu(x @ w_gate) *
(x @ w_up)) @ w_down, dense on the first `num_dense_layers` layers,
else the mixture: s = sigmoid(x @ router), the top-k of s + expert_bias
chosen, gates the chosen s (without the bias) over their sum + 1e-6,
times `routed_scaling_factor`, each token's chosen experts all computed
(dropless).  A final RMS norm, then the tied head.

The weights are a flat {name: tensor} dict, named as the program's state
dict names them (`embed`, `final_norm.scale`, and layer i's under
`blocks.0.sub{i}.`: `norm1.scale`, `norm2.scale`; `conv.in_proj`
[D, 3D], `conv.conv_w` [L, D], `conv.out_proj` [D, D]; `attn.wq`
[D, H, dh], `attn.wk` / `attn.wv` [D, G, dh], `attn.wo` [H, dh, D],
`attn.q_norm` / `attn.k_norm` [dh]; `ffn.w_gate` / `ffn.w_up` [D, F],
`ffn.w_down` [F, D], or with experts [E, D, F] / [E, F, D], `ffn.router`
[D, E] and `ffn.expert_bias` [E]).  Each layer's weights are cast to
float32 only while that layer runs, so the reference fits beside the
bfloat16 weights on one card.  TF32 is off.  `forward` is made of
`layer_weights`, `operator`, `ffn` and `head`, so that a check can run
each layer on an input of its own (the program's residual stream, layer
by layer) as well as the whole model on the tokens.

Controls (`CONTROLS`), each one departure: `no_expert_bias` chooses
the experts by s alone; `capacity_1.25` drops, as the training path
does, every slot past an expert's capacity int(1.25 * T * k / E) (T the
call's tokens; earlier tokens first); `bf16_activations` and
`fp8_activations` round the activations (the residual stream after the
embedding and after every sublayer, and each sublayer's and the head's
normed input) to bfloat16, the configuration's precision, or to float8
e4m3 (saturated at ±448), the nearest below it.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
CONTROLS = ("no_expert_bias", "capacity_1.25", "bf16_activations",
            "fp8_activations")
_ROUNDED = {"bf16_activations": torch.bfloat16,
            "fp8_activations": torch.float8_e4m3fn}


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0)


def _bitlinear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(x) @ sign(w) * alpha * beta; x [..., K], w [K, N]."""
    alpha = w.abs().mean(0)
    beta = x.abs().mean(-1, keepdim=True)
    return (_sign(x) @ _sign(w)) * alpha * beta


def _swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    act = torch.nn.functional.silu(_bitlinear(x, w_gate)) * _bitlinear(
        x, w_up)
    return _bitlinear(act, w_down)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x [B, S, H, dh]; the first and second halves of dh are the pair."""
    half = x.shape[-1] // 2
    inv = torch.pow(torch.tensor(theta, dtype=F32, device=x.device),
                    -torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions[:, None].to(F32) * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps, theta = cfg["norm_eps"], float(cfg["rope_theta"])
    dh = d // h
    pos = torch.arange(s, device=x.device)
    q = (x @ w["attn.wq"].flatten(1)).view(b, s, h, dh)
    k = (x @ w["attn.wk"].flatten(1)).view(b, s, g, dh)
    v = (x @ w["attn.wv"].flatten(1)).view(b, s, g, dh)
    q = _rope(_rms(q, w["attn.q_norm"], eps), pos, theta)
    k = _rope(_rms(k, w["attn.k_norm"], eps), pos, theta)
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h * dh)
    return o @ w["attn.wo"].flatten(0, 1)


def _short_conv(w: dict, x: torch.Tensor) -> torch.Tensor:
    gate_b, gate_c, xx = (x @ w["conv.in_proj"]).chunk(3, dim=-1)
    bx = gate_b * xx
    taps = w["conv.conv_w"]  # [L, D]: y[t] = sum_j taps[j] * bx[t + j - L + 1]
    n, s = taps.shape[0], x.shape[1]
    padded = torch.nn.functional.pad(bx, (0, 0, n - 1, 0))
    conv = sum(padded[:, j:j + s] * taps[j] for j in range(n))
    return (gate_c * conv) @ w["conv.out_proj"]


def _moe(w: dict, cfg: dict, x: torch.Tensor, control) -> torch.Tensor:
    b, s, d = x.shape
    t, e, k = b * s, cfg["num_experts"], cfg["num_experts_per_tok"]
    x = x.reshape(t, d)
    scores = torch.sigmoid(x @ w["ffn.router"])  # [T, E]
    bias = 0.0 if control == "no_expert_bias" else w["ffn.expert_bias"]
    chosen = torch.topk(scores + bias, k, dim=-1).indices  # [T, k]
    gates = scores.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-6)
    gates = gates * cfg["routed_scaling_factor"]
    cap = max(int(1.25 * t * k / e), k)
    y = torch.zeros_like(x)
    for j in range(e):
        hit = chosen == j  # [T, k]; a token chooses an expert at most once
        rows = hit.any(-1).nonzero()[:, 0]  # in token order
        if control == "capacity_1.25":
            rows = rows[:cap]
        if rows.numel():
            out = _swiglu(x[rows], w["ffn.w_gate"][j], w["ffn.w_up"][j],
                          w["ffn.w_down"][j])
            y[rows] += (gates * hit)[rows].sum(-1, keepdim=True) * out
    return y.view(b, s, d)


def _rounding(control):
    """The activations' rounding under `control` (none, but for the
    `*_activations` controls)."""
    dtype = _ROUNDED.get(control)

    def act(t: torch.Tensor) -> torch.Tensor:
        if dtype is None:
            return t
        if dtype == torch.float8_e4m3fn:
            t = t.clamp(-448.0, 448.0)
        return t.to(dtype).to(F32)

    return act


def layer_weights(weights: dict, i: int) -> dict:
    """Layer i's weights, cast to float32, under their names within the
    layer (`norm1.scale`, `conv.in_proj`, `ffn.router`, ...)."""
    prefix = f"blocks.0.sub{i}."
    return {n[len(prefix):]: t.to(F32) for n, t in weights.items()
            if n.startswith(prefix)}


def operator(w: dict, cfg: dict, i: int, h: torch.Tensor, *,
             control: str | None = None) -> torch.Tensor:
    """Layer i's operator on the residual stream h [B, S, D] float32:
    op(operator_norm(h)), what the layer adds to h before its FFN; w its
    `layer_weights`."""
    act = _rounding(control)
    x = act(_rms(h, w["norm1.scale"], cfg["norm_eps"]))
    if cfg["layer_types"][i] == "full_attention":
        return _attention(w, cfg, x)
    return _short_conv(w, x)


def ffn(w: dict, cfg: dict, i: int, h: torch.Tensor, *,
        control: str | None = None) -> torch.Tensor:
    """Layer i's FFN on the residual stream h [B, S, D] float32 (after
    the operator): ffn(ffn_norm(h)), dense on the first
    `num_dense_layers` layers, else the mixture."""
    act = _rounding(control)
    x = act(_rms(h, w["norm2.scale"], cfg["norm_eps"]))
    if i < cfg["num_dense_layers"]:
        return _swiglu(x, w["ffn.w_gate"], w["ffn.w_up"], w["ffn.w_down"])
    return _moe(w, cfg, x, control)


def head(weights: dict, cfg: dict, h: torch.Tensor, *,
         control: str | None = None) -> torch.Tensor:
    """The logits of the last layer's output h [..., D] float32: the
    final RMS norm, then the tied head."""
    x = _rounding(control)(_rms(h, weights["final_norm.scale"].to(F32),
                                cfg["norm_eps"]))
    return x @ weights["embed"].to(F32).t()


def forward(weights: dict, cfg: dict, tokens: torch.Tensor, *,
            control: str | None = None, all_positions: bool = False,
            taps: list | None = None) -> torch.Tensor:
    """Logits of `tokens` [B, S]: float32 [B, V] at the last position, or
    [B, S, V] at every position with `all_positions`.  `taps`, a list,
    receives the residual stream [B, S, D] float32: each layer's input
    and its state after the operator, in order, then the last layer's
    output."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    _no_tf32()
    act = _rounding(control)
    tap = (lambda t: None) if taps is None else taps.append
    h = act(weights["embed"][tokens].to(F32))
    for i in range(len(cfg["layer_types"])):
        w = layer_weights(weights, i)
        tap(h)
        h = act(h + operator(w, cfg, i, h, control=control))
        tap(h)
        h = act(h + ffn(w, cfg, i, h, control=control))
        del w
    tap(h)
    return head(weights, cfg, h if all_positions else h[:, -1],
                control=control)
