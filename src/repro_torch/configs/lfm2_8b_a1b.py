"""lfm2-8b-a1b [hybrid, port-only] — 24L d_model=2048 32H (GQA kv=8,
head_dim 64) vocab=65536; 18 gated short-conv layers and 6 attention
layers; a dense SwiGLU FFN (7168) on layers 0-1, then MoE: 32 experts of
1792, top-4, sigmoid router with an expert bias.
[https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json;
transformers `Lfm2MoeForCausalLM`]

Port-only: the JAX package has no such architecture, so it stays out of
the mirrored `REGISTRY`, `ALIASES` and `list_archs()`;
`configs.get_config("lfm2-8b-a1b[+binary-ffn][+smoke]")` resolves it.
Its settings that the shared `ModelConfig` lacks are fields of the
subclass `Lfm2Config` (defaults as class attributes on the base, off):

- `layer_pattern`: the published `layer_types`, one 24-sublayer block
  ("conv" or "attn"), MoE from layer `num_dense_layers` = 2 on;
- `expert_d_ff` 1792 beside the dense `d_ff` 7168;
- `moe_router` "sigmoid_bias": s = sigmoid(x @ W_r), the top-4 of
  s + expert_bias chosen, gates the chosen s over their sum (+1e-6),
  `routed_scaling_factor` 1;
- `moe_dropless`: at inference every routed slot is computed (slots
  sorted by expert), as the published model drops none;
- `binary_experts`: under `+binary-ffn` the experts are BitLinear on
  kernel 1's grouped entry too;
- `qk_norm_scale`: RMS-normed q and k heads with learned scales;
- `norm_eps` 1e-5; `conv_cache` (`conv_L_cache`) 3, no bias;
- embeddings tied (`tie_word_embeddings` is absent from config.json and
  the class defaults to tied);
- `attn_chunk` 2048, the port's own knob: a 2,048-token prefill attends
  its keys as one chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import LayerPattern, ModelConfig

ATTENTION_LAYERS = (2, 6, 10, 14, 18, 21)
DENSE_LAYERS = 2


@dataclasses.dataclass(frozen=True)
class Lfm2Config(ModelConfig):
    """`ModelConfig` with the port-only settings as fields."""

    norm_eps: float = 1e-5
    qk_norm_scale: bool = True
    expert_d_ff: Optional[int] = None
    moe_router: str = "sigmoid_bias"
    moe_dropless: bool = True
    binary_experts: bool = True
    conv_cache: int = 3

    def param_count(self) -> int:
        """Embedding (tied) + every sublayer + the final norm."""
        d, v, pat = self.d_model, self.vocab_size, self.pattern()
        hd, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        f, fe, e = self.d_ff, self.expert_d_ff or self.d_ff, self.n_experts
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d + 2 * hd
        conv = d * 3 * d + self.conv_cache * d + d * d
        dense = 3 * d * f
        moe = e * 3 * d * fe + d * e + e  # experts, router, expert_bias
        total = v * d * (1 if self.tie_embeddings else 2) + d
        for _ in range(self.blocks):
            for kind, use_moe in zip(pat.kinds, pat.moe_mask):
                total += 2 * d + (attn if kind == "attn" else conv)
                total += moe if use_moe else dense
        return total

    def active_param_count(self) -> int:
        """Params touched per token: top_k of the experts."""
        fe = self.expert_d_ff or self.d_ff
        idle = (self.n_experts - self.moe_top_k) * 3 * self.d_model * fe
        return self.param_count() - idle * self.blocks * sum(
            self.pattern().moe_mask)


def _pattern(n_layers: int, attn: tuple, dense: int) -> LayerPattern:
    return LayerPattern(
        kinds=tuple("attn" if i in attn else "conv" for i in range(n_layers)),
        moe_mask=tuple(i >= dense for i in range(n_layers)))


CONFIG = Lfm2Config(
    name="lfm2-8b-a1b",
    family="hybrid",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=7168,
    expert_d_ff=1792,
    vocab_size=65536,
    n_experts=32,
    moe_top_k=4,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    qk_norm=True,
    tie_embeddings=True,
    layer_pattern=_pattern(24, ATTENTION_LAYERS, DENSE_LAYERS),
    attn_chunk=2048,
)


def smoke(cfg: Lfm2Config) -> Lfm2Config:
    """The CPU tests' size, every mechanism kept: conv and attention
    sublayers, two dense layers then MoE (8 experts of a width other than
    the dense one, top-4), the sigmoid-and-bias router, dropless dispatch,
    float32."""
    return dataclasses.replace(
        cfg, name=cfg.name + "+smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, expert_d_ff=48, vocab_size=256,
        n_experts=8, layer_pattern=_pattern(6, (2, 5), DENSE_LAYERS),
        dtype="float32", remat="none", attn_chunk=8)
