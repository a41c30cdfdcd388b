"""Model configurations (port of `repro.configs`).

The paper's binary MLPs and CNNs live in `paper_mlp` / `paper_cnn`; this
package's namespace is the LM architecture registry: `--arch <id>`
resolution for every launcher (`get_config`, `REGISTRY`, `ALIASES`,
`list_archs`) over the ten architecture configs mirrored from the JAX
package.  `PORT_ONLY` holds the architectures the port alone has
(`lfm2-8b-a1b`): `get_config` resolves them, the mirrored registry and
`list_archs()` leave them out.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    LayerPattern,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    long_context_applicable,
)
from repro_torch.configs import variants  # noqa: F401
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.jamba_52b import CONFIG as _jamba
from repro_torch.configs import lfm2_8b_a1b as _lfm2
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32_1b
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.llama4_maverick import CONFIG as _llama4
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _stablelm,
        _llama32_1b,
        _starcoder2,
        _llama3_405b,
        _llama4,
        _mixtral,
        _falcon_mamba,
        _jamba,
        _chameleon,
        _musicgen,
    )
}

# short aliases for the CLI
ALIASES = {
    "stablelm-3b": "stablelm-3b",
    "llama3.2-1b": "llama3.2-1b",
    "starcoder2-15b": "starcoder2-15b",
    "llama3-405b": "llama3-405b",
    "llama4-maverick": "llama4-maverick-400b-a17b",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-a17b",
    "mixtral-8x7b": "mixtral-8x7b",
    "falcon-mamba-7b": "falcon-mamba-7b",
    "jamba-v0.1-52b": "jamba-v0.1-52b",
    "jamba-52b": "jamba-v0.1-52b",
    "chameleon-34b": "chameleon-34b",
    "musicgen-medium": "musicgen-medium",
}

# the port's own architectures: name -> (config, its `+smoke` reduction)
PORT_ONLY = {_lfm2.CONFIG.name: (_lfm2.CONFIG, _lfm2.smoke)}


def get_config(name: str) -> ModelConfig:
    """`<arch>[+modifier...]` -> its config; modifiers apply left to
    right: binary-ffn, cam-head, cam-head-exact, bf16ar, smoke."""
    base, *mods = name.split("+")
    reduce = variants.reduced
    if base in PORT_ONLY:
        cfg, reduce = PORT_ONLY[base]
    else:
        cfg = REGISTRY[ALIASES.get(base, base)]
    for mod in mods:
        if mod == "binary-ffn":
            cfg = variants.with_binary_ffn(cfg)
        elif mod == "cam-head":
            cfg = variants.with_cam_head(cfg)
        elif mod == "cam-head-exact":
            cfg = variants.with_cam_head(cfg, mode="exact")
        elif mod == "bf16ar":
            cfg = dataclasses.replace(
                cfg, name=cfg.name + "+bf16ar", tp_ar_bf16=True
            )
        elif mod == "smoke":
            cfg = reduce(cfg)
        else:
            raise KeyError(f"unknown config modifier {mod!r}")
    return cfg


def list_archs() -> list[str]:
    return sorted(REGISTRY)
