"""Algorithm 1, noiseless half (port of `repro/core/ensemble.py`).

The output layer of a classification BNN runs once per Hamming-distance
tolerance T_t of a sweep; class j collects
``votes_j = #{t : HD_j <= T_t}`` and the prediction is the argmax of the
votes.  In the noiseless limit the votes are monotone decreasing in HD_j,
so argmax(votes) == argmin(HD) == argmax of the full-precision logit.

Execution modes:
  fused  — HD computed once per (query, row), compared against every T in
           one pass (plain PyTorch; the oracle of the kernels).
  kernel — the same vote through `kernels.fused_mlp.fused_mlp_votes`
           in its head-only form (kernel 3 on the card: query in shared
           memory, HD once, then the P-threshold compare), as the
           reference routes it.

The silicon-noise modes (`votes_faithful`, `votes_fused_noisy`,
`accuracy_sweep`, calibrated thresholds) wait for the noise slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.bnn import FoldedLayer
from repro_torch.core.cam import CAMArray, query_with_bias, write_weights_with_bias

# Algorithm 1 line 3: HD threshold sweep {0, 2, 4, ..., 64} -> 33 passes.
PAPER_THRESHOLDS = tuple(range(0, 65, 2))

_NOISE_SLICE = "waits for the silicon-noise slice of the port"


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    """Algorithm-1 settings: threshold sweep, bias cells, execution mode.

    `noise` and `calibrated` exist for parity with the reference; any
    value other than the noiseless default raises NotImplementedError.
    """

    thresholds: Sequence[int] = PAPER_THRESHOLDS
    bias_cells: int = 64
    noise: Any = None
    mode: str = "fused"  # fused | kernel  (faithful: noise slice)
    calibrated: bool = False

    def __post_init__(self):
        if self.noise is not None:
            raise NotImplementedError(f"EnsembleConfig.noise {_NOISE_SLICE}")

    @property
    def n_passes(self) -> int:
        """Output-layer executions in the Algorithm-1 sweep."""
        return len(self.thresholds)


@dataclasses.dataclass
class CAMEnsembleHead:
    """The deployed output layer: a CAM array + the threshold schedule.

    cam        : rows = classes; row = [binary weights | bias cells(C_j)]
    thresholds : [n_passes] HD-space tolerances (int32; float32 once the
                 noise slice brings calibrated thresholds)
    """

    cam: CAMArray
    thresholds: torch.Tensor
    bias_cells: int

    @property
    def n_classes(self) -> int:
        """Classes = CAM rows of the head."""
        return self.cam.n_rows

    def to(self, device) -> "CAMEnsembleHead":
        """The same head with its rows and thresholds on `device`."""
        return CAMEnsembleHead(self.cam.to(device),
                               self.thresholds.to(device), self.bias_cells)


def build_head(layer: FoldedLayer, cfg: EnsembleConfig) -> CAMEnsembleHead:
    """Write the folded output layer into a CAM ensemble head.

    The paper's sweep {0, 2, ..., 64} is centred on the exact-majority
    point of the biased row (n_total = n_in + bias_cells):
    ``T_t = n_total//2 - max(sweep)//2 + t`` — the 33 equispaced
    tolerances straddle the decision boundary (a raw absolute sweep over a
    192-bit row would never fire).
    """
    if cfg.calibrated:
        raise NotImplementedError(
            f"build_head(calibrated=True) {_NOISE_SLICE}"
        )
    cam = write_weights_with_bias(layer.weights_pm1, layer.c, cfg.bias_cells)
    n_total = layer.n_in + cfg.bias_cells
    center = n_total // 2
    sweep = np.asarray(cfg.thresholds, np.int64)
    offset = center - sweep.max() // 2
    thresholds = torch.as_tensor(offset + sweep, dtype=torch.int32)
    return CAMEnsembleHead(cam=cam, thresholds=thresholds,
                           bias_cells=cfg.bias_cells)


def _compare(hd: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """votes = #{t : hd <= T_t}; float thresholds compare float32(hd)."""
    if thresholds.is_floating_point():
        hd = hd.to(torch.float32)
    return (hd[..., None] <= thresholds).sum(-1, dtype=torch.int32)


def votes_fused(head: CAMEnsembleHead, x_pm1: torch.Tensor) -> torch.Tensor:
    """HD once, every threshold compared against it (plain PyTorch).

    x_pm1: [..., n_in] ±1 activations -> int32 votes [..., classes].
    """
    q = query_with_bias(x_pm1, head.bias_cells)
    return _compare(head.cam.search_hd(q), head.thresholds)


def votes_kernel(head: CAMEnsembleHead, x_pm1: torch.Tensor) -> torch.Tensor:
    """The fused vote through kernel 3 with no hidden layers (its plain
    version on the CPU).  Same result as `votes_fused`."""
    from repro_torch.kernels import fused_mlp  # local: core stays import-light

    x = torch.as_tensor(x_pm1)
    q = query_with_bias(x.reshape(-1, x.shape[-1]), head.bias_cells)
    votes = fused_mlp.fused_mlp_votes(
        q, (), (), (), head.cam.rows_packed, head.thresholds,
        bias_cells=head.bias_cells,
    )
    return votes.reshape(*x.shape[:-1], head.n_classes)


def predict(head: CAMEnsembleHead, x_pm1: torch.Tensor,
            cfg: EnsembleConfig) -> torch.Tensor:
    """Algorithm 1 final prediction: per-class majority vote -> argmax."""
    if cfg.mode == "fused":
        v = votes_fused(head, x_pm1)
    elif cfg.mode == "kernel":
        v = votes_kernel(head, x_pm1)
    elif cfg.mode == "faithful":
        raise NotImplementedError(f"mode='faithful' {_NOISE_SLICE}")
    else:
        raise ValueError(f"unknown ensemble mode {cfg.mode!r}")
    return torch.argmax(v, dim=-1)


def topk_from_votes(votes: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k classes by vote count (ties broken by class index)."""
    return torch.argsort(-votes, dim=-1, stable=True)[..., :k]


def accuracy_from_cumulative(cum_votes: torch.Tensor, labels,
                             topk=(1, 2)) -> dict[int, dict[str, float]]:
    """{p: {topK: acc}} from per-pass cumulative votes [P, B, C]."""
    labels = torch.as_tensor(labels, device=cum_votes.device)[:, None]
    out = {}
    for p in range(1, cum_votes.shape[0] + 1):
        order = torch.argsort(-cum_votes[p - 1], dim=-1, stable=True)
        out[p] = {
            f"top{k}": float(
                (order[:, :k] == labels).any(-1).to(torch.float32).mean()
            )
            for k in topk
        }
    return out


def sweep_from_votes(votes: torch.Tensor, n_passes: int) -> torch.Tensor:
    """Per-pass cumulative vote counts recovered from the fused total.

    NOISELESS ONLY: with the schedule sorted ascending, pass t fires on
    class j iff t >= n_passes - votes_j, so the count after the first p
    passes is clip(votes_j - (n_passes - p), 0, p).

    votes: [..., C] int32 -> [n_passes, ..., C] int32.
    """
    p = torch.arange(1, n_passes + 1, device=votes.device).reshape(
        (-1,) + (1,) * votes.ndim
    )
    v = votes[None] - (n_passes - p)
    return torch.minimum(torch.clamp(v, min=0), p).to(torch.int32)
