"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

HF layout: attn_layer_period=8, attn_layer_offset=4 (one attention layer
per 8, at index 4); expert_layer_period=2, expert_layer_offset=1 (MoE on
odd layers).  Expressed as a scanned 8-sublayer superblock x 4."""

from repro_torch.configs.base import LayerPattern, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    moe_top_k=2,
    mlp_act="swiglu",
    norm="rmsnorm",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    layer_pattern=LayerPattern(
        kinds=(
            "mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba",
        ),
        moe_mask=(False, True, False, True, False, True, False, True),
    ),
)
