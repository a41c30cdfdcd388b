"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 arch.  [arXiv:2410.05355; unverified]

d_inner = 2 * 4096 = 8192; conv kernel 4; dt_rank = ceil(4096/16) = 256.
Decode is O(1) in context length => long_500k is the showcase shape.
The paper's technique applies to in/out projections + head only; the
selective-scan recurrence is not a matching operation (DESIGN.md
§Arch-applicability)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attn-free); kept for schema uniformity
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    norm="rmsnorm",
)
