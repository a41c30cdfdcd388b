"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]

GELU MLP + LayerNorm (bigcode family).  The assignment classifies this
arch as pure full attention (long_500k skipped) — we follow that reading
and do not model the optional 4k sliding window of the release."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_act="gelu",
    norm="layernorm",
    rope_theta=100000.0,
)
