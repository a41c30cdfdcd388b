"""Technique-enabled and reduced (smoke-test) config variants (port of
`repro/configs/variants.py`)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LayerPattern, ModelConfig


def with_binary_ffn(cfg: ModelConfig) -> ModelConfig:
    """BitLinear (XNOR-popcount) FFN variant of any arch."""
    return dataclasses.replace(
        cfg, name=cfg.name + "+binary-ffn", binary_ffn=True
    )


def with_cam_head(cfg: ModelConfig, mode: str = "votes") -> ModelConfig:
    """PiC-BNN CAM-ensemble greedy-decode head variant.

    mode="exact" gives the ADC/TDC-readout competitor baseline."""
    suffix = "+cam-head" if mode == "votes" else "+cam-head-exact"
    return dataclasses.replace(
        cfg, name=cfg.name + suffix, cam_head=True, cam_head_mode=mode
    )


def reduced(cfg: ModelConfig, *, blocks: int = 2) -> ModelConfig:
    """Smoke-test configuration: same family/pattern, tiny dimensions.

    Keeps the structural properties under test (GQA ratio, MoE routing,
    hybrid interleave, window pattern) while shrinking every width so one
    forward/train step runs in milliseconds on CPU.
    """
    pat = cfg.pattern()
    # preserve the GQA ratio where possible
    ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    n_heads = 4 if ratio <= 4 else ratio
    n_kv = max(n_heads // ratio, 1)
    new_pattern = None
    if cfg.layer_pattern is not None:
        new_pattern = LayerPattern(
            kinds=pat.kinds,
            moe_mask=pat.moe_mask,
            windows=tuple(
                None if w is None else min(w, 16) for w in pat.windows
            ),
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "+smoke",
        n_layers=blocks * pat.size,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=cfg.d_ff and 128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        sliding_window=None if cfg.sliding_window is None else 16,
        layer_pattern=new_pattern,
        dt_rank=8,
        dtype="float32",
        remat="none",
        attn_chunk=8,
        cam_head_thresholds=9,
    )
