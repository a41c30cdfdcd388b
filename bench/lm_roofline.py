"""The work of a language model's prefill call, counted from the
configuration file's shapes alone (Hugging Face keys; never the
program's objects), for the "lm" kind (`kinds/lm.py`), in
`roofline.Work`'s terms and at its peaks.

A BitLinear projection (the FFNs under `+binary-ffn`) costs one bit-MAC
per weight bit per row and reads its weights as packed sign bits with a
bfloat16 alpha a column; every other weight is bfloat16, read once a
call.  Floating-point operations count a multiply-add as two.
"""

from __future__ import annotations

from bench.roofline import WORD_BYTES, Work, packed

BF16 = 2  # bytes


def shapes(cfg: dict) -> dict:
    """The sizes the counts need, from the configuration's keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kinds = cfg["layer_types"]
    dense = cfg["num_dense_layers"]
    return dict(
        d=d, h=h, g=cfg["num_key_value_heads"], dh=d // h,
        f=cfg["intermediate_size"], fe=cfg["moe_intermediate_size"],
        e=cfg["num_experts"], k=cfg["num_experts_per_tok"],
        v=cfg["vocab_size"], taps=cfg["conv_L_cache"],
        attn=sum(t == "full_attention" for t in kinds),
        conv=sum(t != "full_attention" for t in kinds),
        dense=dense, moe=len(kinds) - dense)


def bitlinear(rows: int, k_bits: int, n: int, groups: int = 1) -> Work:
    """One BitLinear projection of `rows` rows: `groups` weights of n
    packed rows of k_bits bits with their alphas read, n * k_bits
    bit-MACs a row."""
    return Work(groups * (packed(n, k_bits) + BF16 * n), rows * n * k_bits)


def grouped_launch(slots: int, k_bits: int, n: int, experts: int) -> Work:
    """One launch of kernel 1's grouped entry: `slots` packed rows of
    k_bits bits in, every expert's n packed rows read once, the [slots, n]
    int32 distances written."""
    return Work(packed(slots + experts * n, k_bits)
                + WORD_BYTES * slots * n, slots * n * k_bits)


def grouped_launches(cfg: dict, b: int, s: int) -> list:
    """The grouped work of a call: in each MoE layer gate and up (each
    slot's packed input read once, 2 x the expert width of rows), then
    down, every routed slot (b * s * top-k) a row."""
    z = shapes(cfg)
    slots = b * s * z["k"]
    one = [grouped_launch(slots, z["d"], 2 * z["fe"], z["e"]),
           grouped_launch(slots, z["fe"], z["d"], z["e"])]
    return one * z["moe"]


def grouped_bound_s(cfg: dict, b: int, s: int) -> float:
    """Least seconds of a call's grouped launches, each at its own
    bound."""
    return sum(w.bound_s() for w in grouped_launches(cfg, b, s))


def step(cfg: dict, b: int, s: int) -> Work:
    """The model's work for one prefill call of b prompts of s tokens,
    whatever implements it: the token ids in and the last position's
    float32 logits out; every weight once (the tied embedding once);
    the conv and attention projections, the conv taps, causal attention
    (s (s + 1) / 2 query-key pairs a head), the router and the
    last-position head in bfloat16 FLOPs; the dense FFNs' and every
    routed slot's BitLinear bit-MACs."""
    z = shapes(cfg)
    d, t = z["d"], b * s
    qkvo = d * z["dh"] * (z["h"] + 2 * z["g"]) + z["h"] * z["dh"] * d
    conv = 3 * d * d + d * d
    w = Work(8 * t + WORD_BYTES * b * z["v"] + BF16 * z["v"] * d, 0,
             2 * b * d * z["v"])
    w = w + Work(BF16 * ((2 * len(cfg["layer_types"]) + 1) * d), 0)  # norms
    pairs = b * z["h"] * s * (s + 1) // 2
    w = w + Work(z["attn"] * BF16 * (qkvo + 2 * z["dh"]), 0,
                 z["attn"] * (2 * t * qkvo + 4 * pairs * z["dh"]))
    w = w + Work(z["conv"] * BF16 * (conv + z["taps"] * d), 0,
                 z["conv"] * 2 * t * (conv + z["taps"] * d))
    for _ in range(z["dense"]):
        w = (w + bitlinear(t, d, z["f"]) + bitlinear(t, d, z["f"])
             + bitlinear(t, z["f"], d))
    slots = t * z["k"]
    for _ in range(z["moe"]):
        w = w + Work(BF16 * d * z["e"] + WORD_BYTES * z["e"], 0,
                     2 * t * d * z["e"])
        w = (w + bitlinear(slots, d, z["fe"], z["e"])
             + bitlinear(slots, d, z["fe"], z["e"])
             + bitlinear(slots, z["fe"], d, z["e"]))
    return w
