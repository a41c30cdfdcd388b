"""Logical-axis based sharding (port of `repro.sharding`): models annotate
tensors with *logical* axis names; a rule set maps those to physical
mesh axes per run mode, and DTensor places them on a DeviceMesh."""

from repro_torch.sharding.rules import (  # noqa: F401
    AxisRules,
    LONG_CONTEXT_RULES,
    P,
    PartitionSpec,
    PICBNN_SERVE_RULES,
    SERVE_RULES,
    SERVE_SEQCACHE_RULES,
    TRAIN_RULES,
    TRAIN_SP_RULES,
    ZERO1_PARAM_RULES,
    current_rules,
    logical_to_spec,
    placements,
    sanitize_spec,
    shard,
    use_rules,
)
