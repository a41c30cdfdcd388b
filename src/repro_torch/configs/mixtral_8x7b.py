"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2 — 8 experts top-2, SWA.  [arXiv:2401.04088; hf]

Sliding-window attention (4096) on every layer => long_500k runs with a
rolling window cache."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    moe_top_k=2,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    sliding_window=4096,
)
