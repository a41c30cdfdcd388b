"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Modeled per the llama4 family layout:
  * 3 local (chunked, 8192-token window) : 1 global attention interleave
    (iRoPE), expressed as a 4-sublayer scan pattern;
  * MoE every other layer (interleave_moe_layer_step=2), dense otherwise;
  * the shared expert is folded into the routed experts (DESIGN.md
    §Arch-fidelity).
The mostly-local pattern makes long_500k runnable: local layers keep an
8k rolling cache; the 12 global layers hold sequence-sharded full caches."""

from repro_torch.configs.base import LayerPattern, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    moe_top_k=1,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    layer_pattern=LayerPattern(
        kinds=("attn", "attn", "attn", "attn"),
        moe_mask=(False, True, False, True),
        windows=(8192, 8192, 8192, None),
    ),
)
