"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab.  [arXiv:2407.21783; unverified]

The largest model of the dry-run sweep: 405B params => FSDP+TP is
mandatory; single-pod v5e training memory is analysed in EXPERIMENTS.md."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
)
