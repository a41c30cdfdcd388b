"""Token pipelines for LM training: synthetic streams and memmap files
(port of `repro/data/tokens.py`, numpy only, kept as its own copy).

Each host reads its own shard of a flat uint32 token file (memmap,
zero-copy) with a stride equal to the host count.  Batches are numpy
arrays, bit-equal to the reference's for the same `DataConfig`; the
train step moves them to its device.  One host runs with host_count=1;
multi-host identity is covered by tests over the index math.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int  # global batch (sequences)
    seq_len: int
    vocab_size: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


def synthetic_stream(cfg: DataConfig) -> Iterator[dict]:
    """Zipf-distributed random tokens with a causal LM (shift) target.

    Deterministic per (seed, host_index, step): restart-safe — resuming at
    step k regenerates the identical batch (checkpoint/restart tests rely
    on this property).
    """
    assert cfg.batch % cfg.host_count == 0
    per_host = cfg.batch // cfg.host_count
    step = 0
    while True:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_index
        )
        z = rng.zipf(1.3, size=(per_host, cfg.seq_len + 1))
        toks = (z % (cfg.vocab_size - 1)).astype(np.int32) + 1
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1


def write_token_file(path: Path, tokens: np.ndarray):
    tokens.astype(np.uint32).tofile(path)


def memmap_stream(
    path: Path, cfg: DataConfig, start_step: int = 0
) -> Iterator[dict]:
    """Strided reads over a flat uint32 token file.

    Host h reads sequences [h, h + H, h + 2H, ...] of each global batch —
    host-disjoint and deterministic, so elastic restarts with a different
    host count re-partition cleanly.
    """
    data = np.memmap(path, dtype=np.uint32, mode="r")
    seq = cfg.seq_len + 1
    n_seqs = len(data) // seq
    per_host = cfg.batch // cfg.host_count
    step = start_step
    while True:
        base = (step * cfg.batch) % max(n_seqs - cfg.batch, 1)
        idx = base + cfg.host_index + cfg.host_count * np.arange(per_host)
        idx = idx % n_seqs
        block = np.stack([data[i * seq : (i + 1) * seq] for i in idx])
        block = block.astype(np.int32)
        yield {"tokens": block[:, :-1], "labels": block[:, 1:]}
        step += 1


def embeds_stream(cfg: DataConfig, d_model: int) -> Iterator[dict]:
    """Frontend-stub stream for embeds-input archs (vlm/audio): random
    frame/patch embeddings + token labels."""
    per_host = cfg.batch // cfg.host_count
    step = 0
    while True:
        rng = np.random.default_rng(cfg.seed + 7 * step + cfg.host_index)
        yield {
            "embeds": rng.normal(
                0, 1, (per_host, cfg.seq_len, d_model)
            ).astype(np.float32),
            "labels": rng.integers(
                0, cfg.vocab_size, (per_host, cfg.seq_len)
            ).astype(np.int32),
        }
        step += 1
