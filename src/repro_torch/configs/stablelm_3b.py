"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32 = MHA) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b; unverified]

Family notes: StableLM-2 uses LayerNorm and partial-RoPE (25%); we apply
full RoPE (recorded as an adaptation in DESIGN.md §Arch-fidelity).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    mlp_act="swiglu",
    norm="layernorm",
    rope_theta=10000.0,
)
