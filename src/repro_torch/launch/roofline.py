"""Roofline terms of a dry-run cell on the NVIDIA H100 SXM (port of
`repro/launch/roofline.py`, which takes TPU v5e constants).

Constants, per card:
    989.4e12 FLOP/s dense bf16   (NVIDIA H100 SXM data sheet)
    3.35e12 B/s HBM3             (NVIDIA H100 SXM data sheet)
    NVLink 450e9 B/s a direction (NVLink 4, 18 links of 25 GB/s, data
                                  sheet) for a group within one node
    50e9 B/s                     (one 400 Gb/s InfiniBand NDR port a card)
                                  for a group that spans nodes
    9.96e15 bit-ops/s 1-bit      19,044 bit-MACs a clock an SM measured by
                                  `scripts/torch_mma_probe.py` (NVIDIA H100
                                  80GB HBM3, 700 W) x 132 SMs x 1.98 GHz =
                                  4.98e15 bit-MACs/s, two bit-ops a MAC

The ranks map onto nodes of 8 cards with 'model' innermost (rank r on
node r // 8): the 16 x 16 mesh's 'model' axis of 16 spans two nodes and
its 'data' axis sixteen, so both go at the network's rate; only a group
of at most 8 consecutive ranks rides NVLink (`hlo_cost.RANKS_PER_NODE`).

Three terms, in seconds a step (lower bounds, each resource perfectly
overlapped with itself):
    compute    = device_flops / PEAK_FLOPS + device_binary_ops / BINARY_OPS
    memory     = device_hbm_bytes / HBM_BW
    collective = nvlink bytes / NVLINK_BW + the other wire bytes / NET_BW

device_* numbers come from the per-device cost counter
(launch/hlo_cost.py).  The global `FlopCounterMode` figure is recorded
beside them with its own caveat (it counts DTensor ops at their global
shapes).

MODEL_FLOPS is the analytic useful-work count (6*N*D for training dense,
6*N_active*D for MoE, plus attention terms); the ratio
MODEL_FLOPS / device FLOPs x cards exposes remat recompute and sharding
redundancy.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989.4e12  # dense bf16 a card
HBM_BW = 3.35e12  # bytes/s a card
NVLINK_BW = 450e9  # bytes/s a direction, a group within one node
NET_BW = 50e9  # bytes/s a card, a group across nodes
BINARY_OPS = 2 * 19044 * 132 * 1.98e9  # 1-bit tensor-core bit-ops/s


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Analytic useful FLOPs per step (global, fwd [+bwd for train])."""
    n_active = cfg.active_param_count()
    n_embed = cfg.vocab_size * cfg.d_model * (2 if not cfg.tie_embeddings else 1)
    # matmul params exclude embedding lookup (gather, ~0 flops) but the
    # 6ND convention includes the lm_head matmul == vocab*d once
    n_matmul = n_active - n_embed + cfg.vocab_size * cfg.d_model

    pat = cfg.pattern()
    attn_subs = [i for i, k in enumerate(pat.kinds) if k == "attn"]

    b = shape.global_batch
    if shape.kind == "decode":
        tokens = b  # one token per sequence
        # attention reads the whole cache (or window) once per layer
        flops_attn = 0.0
        for i in attn_subs:
            w = pat.windows[i]
            kv = shape.seq_len if w is None else min(w, shape.seq_len)
            flops_attn += cfg.blocks * 4.0 * b * kv * cfg.n_heads * cfg.head_dim
        fwd = 2.0 * n_matmul * tokens + flops_attn
        return {"total": fwd, "matmul": 2.0 * n_matmul * tokens,
                "attention": flops_attn, "tokens": tokens}

    s = shape.seq_len
    tokens = b * s
    flops_attn = 0.0
    for i in attn_subs:
        w = pat.windows[i]
        kv_avg = s / 2 if w is None else min(w, s / 2)
        flops_attn += cfg.blocks * 4.0 * b * s * kv_avg * cfg.n_heads * cfg.head_dim
    fwd = 2.0 * n_matmul * tokens + flops_attn
    if shape.kind == "train":
        total = 3.0 * fwd  # bwd ~ 2x fwd
    else:
        total = fwd
    return {"total": total, "matmul": (3.0 if shape.kind == "train" else 1.0)
            * 2.0 * n_matmul * tokens,
            "attention": (3.0 if shape.kind == "train" else 1.0) * flops_attn,
            "tokens": tokens}


@dataclasses.dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    hlo_flops_global: float
    useful_ratio: float
    step_time_lb_s: float
    roofline_fraction: float  # useful-compute time / bottleneck time
    binary_s: float = 0.0  # kernels 1 and 2's part of compute_s

    def to_dict(self):
        return dataclasses.asdict(self)


def derive(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_chips: int,
    device_flops: float,
    device_hbm_bytes: float,
    device_wire_bytes: float,
    device_binary_ops: float = 0.0,
    device_nvlink_bytes: float = 0.0,
) -> RooflineReport:
    """The reference's three terms on the H100.  Wire bytes not named as
    NVLink's (`device_nvlink_bytes`, a part of `device_wire_bytes`) go at
    the network's rate."""
    binary_s = device_binary_ops / BINARY_OPS
    compute_s = device_flops / PEAK_FLOPS + binary_s
    memory_s = device_hbm_bytes / HBM_BW
    collective_s = (device_nvlink_bytes / NVLINK_BW
                    + (device_wire_bytes - device_nvlink_bytes) / NET_BW)
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)["total"]
    hlo_global = device_flops * n_chips
    useful = mf / hlo_global if hlo_global else 0.0
    step_lb = max(terms.values())
    # fraction of the machine's peak that useful work would achieve if the
    # step ran at the bottleneck bound:
    ideal_compute_s = mf / (n_chips * PEAK_FLOPS)
    frac = ideal_compute_s / step_lb if step_lb > 0 else 0.0
    return RooflineReport(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_global=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=useful,
        step_time_lb_s=step_lb,
        roofline_fraction=min(frac, 1.0),
        binary_s=binary_s,
    )
