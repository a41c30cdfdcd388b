"""Model / shape configuration schema for every assigned architecture
(port of `repro/configs/base.py`; `torch_dtype` in place of `jax_dtype`)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LayerPattern:
    """Per-superblock layer layout for hybrid archs (scan unit).

    kinds: tuple over sublayers, entries in {"attn", "mamba"}.
    moe_mask: tuple[bool] — which sublayers use MoE instead of dense MLP
              (attn-kind sublayers still carry their own MLP in this arch
              family; mamba sublayers in jamba carry the MLP too).
    """

    kinds: tuple
    moe_mask: tuple
    windows: tuple = ()  # per-sublayer attention window (None = full/global)

    def __post_init__(self):
        assert len(self.kinds) == len(self.moe_mask)
        if not self.windows:
            object.__setattr__(self, "windows", (None,) * len(self.kinds))
        assert len(self.windows) == len(self.kinds)

    @property
    def size(self) -> int:
        return len(self.kinds)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # MLP
    mlp_act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    moe_every: int = 1  # MoE on layers where (idx % moe_every == moe_offset)
    moe_offset: int = 0
    # attention
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # tokens; None = full attention
    qk_norm: bool = False  # chameleon QK-norm
    # SSM (mamba-1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)
    # hybrid layout (None for homogeneous stacks)
    layer_pattern: Optional[LayerPattern] = None
    # modality frontend stub: model consumes precomputed embeddings
    embeds_input: bool = False
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"
    # the paper's technique as a first-class LM feature
    binary_ffn: bool = False  # BitLinear (XNOR-popcount) FFN projections
    cam_head: bool = False  # PiC-BNN CAM-ensemble greedy-decode head
    cam_head_thresholds: int = 33
    # "votes" = PiC-BNN Algorithm 1 (binary measurements only);
    # "exact" = full-precision POPCOUNT readout over the same binary match
    #           (the ADC/TDC competitor the paper compares against)
    cam_head_mode: str = "votes"
    # remat policy for the layer scan: none | dots | full
    remat: str = "full"
    # TP partial-sum all-reduces in bf16 instead of f32 (halves the
    # activation-AR wire bytes; each partial is still f32-accumulated
    # inside the MXU before rounding) — §Perf variant, off by default
    tp_ar_bf16: bool = False
    # attention kv-chunk for flash-style scan
    attn_chunk: int = 1024

    # Port-only settings, off for every mirrored architecture.  They are
    # plain class attributes, not fields, so a mirrored config's
    # `dataclasses.asdict` stays the reference's; the port-only
    # architectures' subclass (`configs/lfm2_8b_a1b.py`) makes them fields.
    norm_eps = 1e-6  # the RMS norms' epsilon
    qk_norm_scale = False  # QK-norm with a learned scale a head dim
    expert_d_ff = None  # the experts' width (None: d_ff)
    moe_router = "softmax"  # "softmax" | "sigmoid_bias" (+ expert_bias)
    moe_dropless = False  # inference dispatch sorted by expert, no capacity
    binary_experts = False  # under binary_ffn, experts on kernel 1 too
    conv_cache = 3  # taps of a "conv" sublayer's causal depthwise conv

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.dt_rank is None:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    # -- derived ------------------------------------------------------------
    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def blocks(self) -> int:
        """Number of scan steps (superblocks for hybrids, layers otherwise)."""
        if self.layer_pattern is not None:
            assert self.n_layers % self.layer_pattern.size == 0
            return self.n_layers // self.layer_pattern.size
        return self.n_layers

    def pattern(self) -> LayerPattern:
        """The per-scan-step layout (homogeneous stacks: one sublayer)."""
        if self.layer_pattern is not None:
            return self.layer_pattern
        kind = "mamba" if self.family == "ssm" else "attn"
        moe = self.n_experts > 0
        return LayerPattern(
            kinds=(kind,), moe_mask=(moe,), windows=(self.sliding_window,)
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        if self.mlp_act == "swiglu":
            mlp_dense = 3 * d * f
        else:
            mlp_dense = 2 * d * f
        mlp_moe = self.n_experts * mlp_dense + d * self.n_experts
        din, n = self.d_inner, self.ssm_state
        mamba = (
            d * 2 * din  # in_proj
            + din * self.ssm_conv + din  # conv w + b
            + din * (self.dt_rank + 2 * n)  # x_proj
            + self.dt_rank * din + din  # dt_proj
            + din * n + din  # A_log, D
            + din * d  # out_proj
        )
        total = emb
        pat = self.pattern()
        for b in range(self.blocks):
            for s, kind in enumerate(pat.kinds):
                total += d  # norm scale
                if kind == "attn":
                    total += attn
                    has_ffn = True
                else:
                    total += mamba
                    has_ffn = self.family == "hybrid"
                if has_ffn:
                    total += d  # norm2
                    total += mlp_moe if pat.moe_mask[s] else mlp_dense
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.mlp_act == "swiglu" else 2) * d * f
        inactive = 0
        pat = self.pattern()
        for b in range(self.blocks):
            for s in range(pat.size):
                if pat.moe_mask[s]:
                    inactive += (self.n_experts - self.moe_top_k) * per_expert
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES: Sequence[ShapeConfig] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def long_context_applicable(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM / hybrid /
    sliding-window / chunked-local attention); pure full-attention archs
    are skipped per the assignment (recorded in DESIGN.md)."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.sliding_window is not None:
        return True
    if cfg.layer_pattern is not None and any(
        w is not None for w in cfg.layer_pattern.windows
    ):
        # mostly-local interleaves (llama4): global layers' caches are
        # sequence-sharded; local layers hold rolling windows
        return True
    return False


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not long_context_applicable(cfg):
            continue
        out.append(s)
    return out
