"""Content-addressable memory (CAM) arrays with Hamming-distance search
(port of `repro/core/cam.py`).

A :class:`CAMArray` stores binary rows as packed int32 words.  A search
asserts a binary query on every row at once; its reference semantics is
the Hamming distance of each row to the query (`search_hd`), from which
every match decision ``HD(row, query) <= T`` derives.  Batch-norm
constants are realized as extra always-match / always-mismatch cells
appended to each row (`write_weights_with_bias`), and the query drives
logic '1' on those bias searchlines (`query_with_bias`).

`search` compares the distances against a threshold, optionally under
PVT noise (`physics.sample_search_thresholds`, drawn from a
`torch.Generator`); `search_knobs` derives the threshold from the analog
knob voltages (`physics.sample_effective_threshold` under noise).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import binarize, physics
from repro_torch.core.device_model import (
    AnalogParams,
    NoiseModel,
    NOISELESS,
    default_params,
    hd_threshold,
)


@dataclasses.dataclass(frozen=True)
class BankConfig:
    """One logical configuration of the 128-kbit PiC-BNN macro."""

    rows: int
    width: int  # bits per row

    @property
    def capacity_bits(self) -> int:
        """Bits the configuration stores."""
        return self.rows * self.width


# The three logical configurations of the fabricated macro (Sec. III).
CONFIG_512x256 = BankConfig(512, 256)
CONFIG_1024x128 = BankConfig(1024, 128)
CONFIG_2048x64 = BankConfig(2048, 64)
LOGICAL_CONFIGS: Sequence[BankConfig] = (
    CONFIG_512x256,
    CONFIG_1024x128,
    CONFIG_2048x64,
)


def pick_bank_config(width_bits: int) -> BankConfig:
    """Smallest logical row width that fits `width_bits` (else widest)."""
    for cfg in sorted(LOGICAL_CONFIGS, key=lambda c: c.width):
        if cfg.width >= width_bits:
            return cfg
    return max(LOGICAL_CONFIGS, key=lambda c: c.width)


@dataclasses.dataclass
class CAMArray:
    """A (logical) CAM array holding N binary rows of `n_bits` each.

    rows_packed : [N, ceil(n_bits/32)] int32 — stored data D
    n_bits      : logical row width (pad bits are 0 in both query and rows,
                  so they never mismatch)
    """

    rows_packed: torch.Tensor
    n_bits: int

    @classmethod
    def from_bits(cls, bits) -> "CAMArray":
        """bits: [N, n_bits] in {0,1}."""
        bits = torch.as_tensor(bits)
        return cls(rows_packed=binarize.pack_bits(bits), n_bits=bits.shape[-1])

    @classmethod
    def from_pm1(cls, values) -> "CAMArray":
        """values: [N, n_bits] in {-1,+1}."""
        return cls.from_bits(binarize.to_bits(torch.as_tensor(values)))

    @property
    def n_rows(self) -> int:
        """Rows stored (classes, for an ensemble head)."""
        return self.rows_packed.shape[0]

    def to(self, device) -> "CAMArray":
        """The same array with its rows on `device`."""
        return CAMArray(self.rows_packed.to(device), self.n_bits)

    def search_hd(self, query_packed: torch.Tensor) -> torch.Tensor:
        """Hamming distance of every row against query(s).

        query_packed: [..., Kw] int32 -> [..., N] int32.
        """
        return binarize.hamming_packed(
            query_packed[..., None, :], self.rows_packed
        )

    def search(self, query_packed: torch.Tensor, threshold, *,
               noise: NoiseModel = NOISELESS,
               params: Optional[AnalogParams] = None,
               key: Optional[torch.Generator] = None) -> torch.Tensor:
        """Approximate search: per-row binary match under HD tolerance.

        threshold — HD tolerance T, scalar or broadcastable to [..., N].
        noise/key — optional PVT noise on the effective per-row threshold
                    (`physics.sample_search_thresholds`: every sigma, with
                    nearest-Table-I-anchor knob provenance); `key` is a
                    `torch.Generator` on the query's device.

        Returns uint8 [..., N]: 1 where HD(row, query) <= T_eff.
        """
        hd = self.search_hd(query_packed)
        t_eff = physics.sample_search_thresholds(
            key, threshold, noise, tuple(hd.shape), params=params,
            device=hd.device)
        return (hd.to(torch.float32) <= t_eff).to(torch.uint8)

    def search_knobs(self, query_packed: torch.Tensor, v_ref, v_eval, v_st,
                     *, params: Optional[AnalogParams] = None,
                     noise: NoiseModel = NOISELESS,
                     key: Optional[torch.Generator] = None) -> torch.Tensor:
        """Search with the threshold derived from the knob voltages; under
        noise the voltages themselves are perturbed
        (`physics.sample_effective_threshold`, one draw per row)."""
        params = params or default_params()
        if key is not None and noise.is_active:
            t = physics.sample_effective_threshold(
                key, params, noise, v_ref, v_eval, v_st,
                shape=(self.n_rows,))
        else:
            t = torch.as_tensor(hd_threshold(params, v_ref, v_eval, v_st))
        return self.search(query_packed, t)


def write_weights_with_bias(weights_pm1, bias_counts,
                            bias_cells: int) -> CAMArray:
    """Build a CAM array realizing `W x + C` rows (paper Eq. 4).

    weights_pm1 : [N, K] in {-1,+1} — the binary weight rows W_j.
    bias_counts : [N] integer C_j in [-bias_cells, +bias_cells].
    bias_cells  : number of extra CAM cells appended per row.

    With p cells at '1' and (bias_cells - p) at '0' the row's dot product
    gains 2p - bias_cells, so p = (C_j + bias_cells)/2.  When C_j and
    bias_cells differ in parity, C_j is rounded DOWN by one: for the
    dead-zone-free C_j that `bnn.fold` emits, y + C > 0 <=> y + (C-1) >= 0,
    so the CAM row makes the same sign decision as the folded oracle on
    every input (rounding toward zero would flip it at y = -C - 1).
    """
    w = np.asarray(weights_pm1)
    c = np.asarray(bias_counts).astype(np.int64)
    c = np.clip(c, -bias_cells, bias_cells)
    # after the clip, c == -bias_cells has even parity, so the decrement
    # never leaves the representable range
    odd = (c + bias_cells) % 2 != 0
    c = np.where(odd, c - 1, c)
    p = (c + bias_cells) // 2  # cells storing '1'
    bias_bits = (np.arange(bias_cells)[None, :] < p[:, None]).astype(np.uint8)
    w_bits = (w > 0).astype(np.uint8)
    all_bits = np.concatenate([w_bits, bias_bits], axis=-1)
    return CAMArray(rows_packed=binarize.words_to_torch(
        binarize.np_pack_bits(all_bits)), n_bits=all_bits.shape[-1])


def query_with_bias(x_pm1: torch.Tensor, bias_cells: int) -> torch.Tensor:
    """Pack an activation query, appending the all-'1' bias drive bits."""
    bits = binarize.to_bits(torch.as_tensor(x_pm1))
    ones = torch.ones((*bits.shape[:-1], bias_cells), dtype=torch.uint8,
                      device=bits.device)
    return binarize.pack_bits(torch.cat([bits, ones], dim=-1))
