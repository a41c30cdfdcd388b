"""Algorithm 1 (port of `repro/core/ensemble.py`).

The output layer of a classification BNN runs once per Hamming-distance
tolerance T_t of a sweep; class j collects
``votes_j = #{t : HD_j <= T_t}`` and the prediction is the argmax of the
votes.  In the noiseless limit the votes are monotone decreasing in HD_j,
so argmax(votes) == argmin(HD) == argmax of the full-precision logit.

Under analog noise each vote is a Bernoulli trial whose probability is
sigmoid-like in (T_t - HD_j); summing over passes concentrates the
estimate (the paper's law-of-large-numbers argument).

Execution modes:
  faithful — one search per threshold, per-pass PVT noise (the silicon
             flow), thresholds from `physics.SearchPhysics.sample`.
  fused    — HD computed once per (query, row), compared against every T
             in one pass (plain PyTorch; the oracle of the kernels).
             `votes_fused_noisy` is its silicon twin: the same sampler,
             equal to `faithful` in distribution (and draw for draw on the
             same generator state), equal to `fused` when noiseless.
  kernel   — the same vote through `kernels.fused_mlp.fused_mlp_votes`
             in its head-only form (kernel 3 on the card: query in shared
             memory, HD once, then the P-threshold compare), as the
             reference routes it.

Random draws come from a `torch.Generator` (`key=`), which matches the
reference's `jax.random` keys in distribution, not draw for draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bnn import FoldedLayer
from repro_torch.core.cam import CAMArray, query_with_bias, write_weights_with_bias
from repro_torch.core.device_model import AnalogParams, NoiseModel, NOISELESS
from repro_torch.core.physics import SearchPhysics, achieved_sweep

# Algorithm 1 line 3: HD threshold sweep {0, 2, 4, ..., 64} -> 33 passes.
PAPER_THRESHOLDS = tuple(range(0, 65, 2))


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    """Algorithm-1 settings: threshold sweep, bias cells, the PVT model of
    `predict(mode="faithful")`, execution mode, and whether the head
    deploys the knob schedule's calibrated (float) thresholds."""

    thresholds: Sequence[int] = PAPER_THRESHOLDS
    bias_cells: int = 64
    noise: NoiseModel = NOISELESS
    mode: str = "fused"  # faithful | fused | kernel
    calibrated: bool = False

    @property
    def n_passes(self) -> int:
        """Output-layer executions in the Algorithm-1 sweep."""
        return len(self.thresholds)


@dataclasses.dataclass
class CAMEnsembleHead:
    """The deployed output layer: a CAM array + the threshold schedule.

    cam        : rows = classes; row = [binary weights | bias cells(C_j)]
    thresholds : [n_passes] HD-space tolerances (int32; float32 for a
                 calibrated head)
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

    With ``cfg.calibrated`` the ideal integer sweep is replaced by the
    knob schedule's achieved tolerances (`physics.achieved_sweep`), with
    the same centring, as float32 (equispaced sweeps only: the schedule
    targets ``linspace(0, max, P)``).
    """
    cam = write_weights_with_bias(layer.weights_pm1, layer.c, cfg.bias_cells)
    n_total = layer.n_in + cfg.bias_cells
    center = n_total // 2
    sweep = np.asarray(cfg.thresholds, np.int64)
    offset = center - sweep.max() // 2
    if cfg.calibrated:
        if not np.array_equal(
            sweep, np.linspace(0, sweep.max(), len(sweep)).round()
        ):
            raise ValueError(
                "calibrated=True supports only an equispaced threshold "
                f"sweep (the knob schedule targets it); got {sweep}"
            )
        t_hd = offset + achieved_sweep(len(sweep), int(sweep.max()))
        thresholds = torch.from_numpy(np.asarray(t_hd, np.float32))
    else:
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


def _noisy_thresholds(head, hd, key, noise, params, physics):
    phys = physics or SearchPhysics.for_head(head, noise, params)
    return phys.sample(key, batch_shape=tuple(hd.shape[:-1]),
                       n_rows=hd.shape[-1])


def votes_faithful(head: CAMEnsembleHead, x_pm1: torch.Tensor, *,
                   noise: NoiseModel = NOISELESS,
                   key: Optional[torch.Generator] = None,
                   params: Optional[AnalogParams] = None,
                   physics: Optional[SearchPhysics] = None) -> torch.Tensor:
    """The silicon flow: one search per threshold, per-pass PVT noise.

    x_pm1: [..., n_in] ±1 activations -> int32 votes [..., classes].
    The effective thresholds come from `SearchPhysics.sample` (every
    NoiseModel term); pass `physics` to reuse a prebuilt bundle, else one
    is built from (head, noise, params).  `key` is a `torch.Generator` on
    the head's device.
    """
    q = query_with_bias(x_pm1, head.bias_cells)
    hd = head.cam.search_hd(q).to(torch.float32)  # [..., C] (analog ML)
    t_eff = _noisy_thresholds(head, hd, key, noise, params, physics)
    votes = torch.zeros(hd.shape, dtype=torch.int32, device=hd.device)
    for t in range(t_eff.shape[0]):  # one search per pass, as in silicon
        votes += (hd <= t_eff[t]).to(torch.int32)
    return votes


def votes_fused_noisy(head: CAMEnsembleHead, x_pm1: torch.Tensor, *,
                      key: Optional[torch.Generator],
                      noise: NoiseModel = NOISELESS,
                      params: Optional[AnalogParams] = None,
                      physics: Optional[SearchPhysics] = None
                      ) -> torch.Tensor:
    """Fused sweep under PVT noise: HD once, sampled thresholds [P, ..., C]
    compared in one vectorized step.  Draw for draw equal to
    `votes_faithful` on the same generator state, bit-equal to
    `votes_fused` when noiseless."""
    q = query_with_bias(x_pm1, head.bias_cells)
    hd = head.cam.search_hd(q).to(torch.float32)
    t_eff = _noisy_thresholds(head, hd, key, noise, params, physics)
    return (hd[None] <= t_eff).sum(0, dtype=torch.int32)


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
            cfg: EnsembleConfig, *,
            key: Optional[torch.Generator] = None) -> torch.Tensor:
    """Algorithm 1 final prediction: per-class majority vote -> argmax
    (`key` feeds the faithful mode's noise)."""
    if cfg.mode == "faithful":
        v = votes_faithful(head, x_pm1, noise=cfg.noise, key=key)
    elif cfg.mode == "fused":
        v = votes_fused(head, x_pm1)
    elif cfg.mode == "kernel":
        v = votes_kernel(head, x_pm1)
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


def accuracy_sweep(head: CAMEnsembleHead, hidden_pm1: torch.Tensor, labels,
                   cfg: EnsembleConfig, *,
                   key: Optional[torch.Generator] = None,
                   topk=(1, 2)) -> dict[int, dict[str, float]]:
    """Fig. 5: accuracy of Algorithm 1 truncated to its first p passes,
    p = 1..n_passes, under `cfg.noise` (one realization from `key`).
    Returns {p: {"top1": ..., "top2": ...}}."""
    q = query_with_bias(hidden_pm1, head.bias_cells)
    hd = head.cam.search_hd(q).to(torch.float32)  # [B, C]
    t_eff = _noisy_thresholds(head, hd, key, cfg.noise, None, None)
    cum = torch.cumsum((hd[None] <= t_eff).to(torch.int32), dim=0)
    return accuracy_from_cumulative(cum, labels, topk)
