"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24 = MHA)
d_ff=6144 vocab=2048 — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

Backbone only: the EnCodec tokenizer is a frontend STUB — input_specs()
provides precomputed frame embeddings.  The 2048-entry codebook is the
natural CAM-head demonstrator: 2048 classes = one 2048x64 PiC-BNN bank
configuration (see configs/musicgen_cam.py for the technique-enabled
variant used in §Perf)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_act="gelu",
    norm="layernorm",
    rope_theta=10000.0,
    embeds_input=True,
)
