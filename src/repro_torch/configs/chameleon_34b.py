"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens.  [arXiv:2405.09818; unverified]

Backbone only: the VQ-GAN image tokenizer is a frontend STUB —
input_specs() provides precomputed patch/token embeddings [B, S, D].
QK-norm enabled (chameleon's training-stability fix)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    mlp_act="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=10000.0,
    embeds_input=True,
)
