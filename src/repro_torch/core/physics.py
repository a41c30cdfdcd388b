"""Search physics: the only producer of effective HD thresholds (port of
`repro/core/physics.py`).

Every noisy CAM search of the port — `cam.CAMArray.search`, the
Algorithm-1 ensemble (`ensemble.votes_faithful`, `votes_fused_noisy`,
`accuracy_sweep`) and the pipeline's silicon specs — takes its effective
per-pass thresholds from this module; the consumers only compare.

Every PVT non-ideality of `device_model.NoiseModel` is referred to the
threshold side of the matchline comparison, in HD units:

  sigma_vref    — V_ref drift through ``d(m*)/dV_ref`` at the pass's knob
                  point (`vref_sensitivity`); one MLSA reference per
                  search, so the draw is PASS-GLOBAL (shared by its rows).
  sigma_tjitter — strobe jitter, ``m* ~ 1/t_s``: multiplicative on the
                  pass's logical tolerance, clamped at ``max(tj, 0.5)``;
                  pass-global.
  sigma_hd      — MLSA offset + discharge mismatch: PER-ROW.
  temp_drift_hd — a deterministic offset shared by all rows.

``match <=> HD <= T + eps <=> HD - eps <= T``, so noise on the threshold
gives the same vote distribution as noise on the analog reading; the
Hamming distances are computed once and only the compare sees the noise.
In the noiseless limit every sampler returns the base thresholds
bit-exactly.

Randomness, the port's counterpart of the reference's `jax.random` keys:

  * a `torch.Generator` (`sample`, the batch-level draws): each call is
    one realization, drawn on the generator's device with `torch.randn`
    in the reference's order (V_ref, strobe, row);
  * raw uint32 [B, 2] key words (`sample_keyed`, the per-request draws):
    a counter-based generator keyed by each row's words
    (`core/keys.py`), so a row's thresholds depend on its key alone.

The deterministic fields (`thresholds`, `m_logical`, `dm_dvref`: the
knob schedule's inversion) are computed on the host in numpy, with the
reference's float32 arithmetic, then moved to the pipeline's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.device_model import (
    TABLE1,
    AnalogParams,
    NoiseModel,
    NOISELESS,
    _f32,
    default_params,
    hd_threshold,
    knob_schedule,
)


# ---------------------------------------------------------------------------
# Knob-space sensitivities and provenance (host, numpy float32)
# ---------------------------------------------------------------------------
def vref_sensitivity(params: AnalogParams, v_ref, v_eval, v_st) -> np.ndarray:
    """Analytic ``d(m*)/dV_ref = -(C/k) / (V_ref g t_s)`` [HD/V], float32:
    finite (and negative) even at V_ref = VDD where m* is zero."""
    v_ref = _f32(v_ref)
    denom = params.g_rel(v_eval) * params.t_sample(v_st)
    return np.float32(-params.c_over_g) / (
        np.maximum(v_ref, np.float32(1e-3)) * denom)


def anchor_knobs(threshold):
    """Nearest Table-I operating point by HD tolerance (elementwise):
    (v_ref, v_eval, v_st) float32 arrays broadcast like `threshold` [V]."""
    thr = _f32(threshold)
    anchors_hd = TABLE1[:, 3].astype(np.float32)
    idx = np.argmin(np.abs(thr[..., None] - anchors_hd), axis=-1)
    knobs = (TABLE1[:, :3] / 1e3).astype(np.float32)[idx]
    return knobs[..., 0], knobs[..., 1], knobs[..., 2]


@functools.lru_cache(maxsize=8)
def _schedule_cached(n_passes: int, sweep_max: int):
    """Table-I-calibrated knob schedule, cached per (P, sweep span)."""
    knobs, achieved = knob_schedule(n_passes, sweep_max)
    return np.asarray(knobs, np.float32), np.asarray(achieved, np.float32)


def achieved_sweep(n_passes: int, sweep_max: int) -> np.ndarray:
    """The knob schedule's achieved calibrated logical tolerances [P]
    (float32): what the analog knobs deliver when asked for the ideal
    sweep ``linspace(0, sweep_max, P)``; `ensemble.build_head
    (calibrated=True)` deploys them."""
    return _schedule_cached(int(n_passes), int(sweep_max))[1]


# ---------------------------------------------------------------------------
# The one sampling core
# ---------------------------------------------------------------------------
def combine_deltas(noise: NoiseModel, m_logical, dm_dvref, z_vref, z_tj,
                   z_row) -> torch.Tensor:
    """Threshold perturbations from standard normals, float32: the ONE
    place the sigmas meet randomness (reference physics.py:130-138).

    z_vref, z_tj : pass-global normals ``[..., 1]``; z_row ``[..., n_rows]``.
    m_logical / dm_dvref broadcast against them.
    """
    dv = noise.sigma_vref * z_vref
    tj = 1.0 + noise.sigma_tjitter * z_tj
    row = noise.sigma_hd * z_row
    return (
        dm_dvref * dv
        + m_logical * (1.0 / torch.clamp(tj, min=0.5) - 1.0)
        + row
        + noise.temp_drift_hd
    )


def _sample_deltas(generator: torch.Generator, noise: NoiseModel,
                   m_logical, dm_dvref, global_shape: tuple,
                   n_rows: int) -> torch.Tensor:
    """Deltas ``global_shape + (n_rows,)`` from `generator`: the V_ref and
    strobe draws per `global_shape` entry (one search cycle), sigma_hd per
    row, in that order."""
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.float32)
    z_v = torch.randn(global_shape + (1,), **kw)
    z_t = torch.randn(global_shape + (1,), **kw)
    z_r = torch.randn(global_shape + (n_rows,), **kw)
    return combine_deltas(noise, m_logical, dm_dvref, z_v, z_t, z_r)


def sample_effective_threshold(generator: torch.Generator,
                               params: AnalogParams, noise: NoiseModel,
                               v_ref, v_eval, v_st, shape=()) -> torch.Tensor:
    """Exact knob-space sampler: perturb V_ref, convert to HD through the
    model, then apply the strobe jitter and the row noise.  float32
    ``shape`` on the generator's device."""
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.float32)
    shape = tuple(shape)
    v_ref_n = torch.as_tensor(v_ref, dtype=torch.float32,
                              device=generator.device) \
        + noise.sigma_vref * torch.randn(shape, **kw)
    base = hd_threshold(params, v_ref_n, v_eval, v_st)
    tj = 1.0 + noise.sigma_tjitter * torch.randn(shape, **kw)
    base = base / torch.clamp(tj, min=0.5)
    row = noise.sigma_hd * torch.randn(shape, **kw)
    return base + row + noise.temp_drift_hd


def sample_search_thresholds(generator: Optional[torch.Generator],
                             threshold, noise: NoiseModel, shape: tuple,
                             params: Optional[AnalogParams] = None,
                             device=None) -> torch.Tensor:
    """Effective thresholds for a single-pass CAM search (no schedule).

    threshold : scalar or array broadcastable to `shape` ([..., n_rows]).
    shape     : the last axis is the row axis (per-row sigma_hd draws);
                leading axes are independent search cycles.
    device    : where the result lives (default: the generator's, else
                the threshold tensor's, else the CPU).

    ``generator=None`` or a noiseless model returns the base thresholds
    broadcast — the bit-exact noiseless limit.
    """
    if device is None:
        device = (generator.device if generator is not None
                  else threshold.device if isinstance(threshold, torch.Tensor)
                  else "cpu")
    shape = tuple(shape)
    t = torch.as_tensor(threshold).to(device, torch.float32).expand(shape)
    if generator is None or not noise.is_active:
        return t
    if noise.sigma_vref or noise.sigma_tjitter:
        # knob provenance of the raw (usually scalar) threshold, on the host
        params = params or default_params()
        raw = _f32(threshold.cpu() if isinstance(threshold, torch.Tensor)
                   else threshold)
        m_logical = t.new_tensor(raw)
        dm_dvref = t.new_tensor(vref_sensitivity(params,
                                                 *anchor_knobs(raw)))
    else:  # only per-row noise / drift: no knob-space terms
        m_logical = dm_dvref = 0.0
    delta = _sample_deltas(generator, noise, m_logical, dm_dvref,
                           shape[:-1], shape[-1])
    return t + delta


# ---------------------------------------------------------------------------
# SearchPhysics: schedule-aware physics for the Algorithm-1 ensemble head
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SearchPhysics:
    """AnalogParams + NoiseModel + per-pass knob provenance, bundled.

    thresholds : [P] float32 base HD-space thresholds (as deployed).
    m_logical  : [P] float32 logical tolerance per pass (knob-achieved).
    dm_dvref   : [P] float32 d(m*)/dV_ref at each pass's knob point.
    noise      : the PVT model; params: the analog constants (None when
                 the knob-space sigmas are inactive and never needed).
    """

    thresholds: torch.Tensor
    m_logical: torch.Tensor
    dm_dvref: torch.Tensor
    noise: NoiseModel
    params: Optional[AnalogParams] = None

    @property
    def n_passes(self) -> int:
        """Passes in the Algorithm-1 threshold schedule."""
        return int(self.thresholds.shape[0])

    @property
    def is_noiseless(self) -> bool:
        """True when sampling returns the base thresholds bit-exactly."""
        return not self.noise.is_active

    @property
    def device(self) -> torch.device:
        """Where the fields (and the samples) live."""
        return self.thresholds.device

    def to(self, device) -> "SearchPhysics":
        """The same physics with its fields on `device`."""
        return dataclasses.replace(
            self, thresholds=self.thresholds.to(device),
            m_logical=self.m_logical.to(device),
            dm_dvref=self.dm_dvref.to(device))

    @classmethod
    def for_sweep(cls, thresholds_hd, noise: NoiseModel = NOISELESS,
                  params: Optional[AnalogParams] = None) -> "SearchPhysics":
        """Physics for an Algorithm-1 threshold schedule (HD space), on the
        CPU (`to` moves it).

        Knob provenance, computed only when a knob-space sigma (vref /
        tjitter) is active: the Table-I-calibrated `knob_schedule` over
        the sweep's span when the schedule is equispaced (atol 1e-3),
        else the nearest Table-I anchor per pass.
        """
        if isinstance(thresholds_hd, torch.Tensor):
            thresholds_hd = thresholds_hd.cpu().numpy()
        t = np.asarray(thresholds_hd, np.float32)
        if not (noise.sigma_vref or noise.sigma_tjitter):
            zero = torch.zeros(t.shape, dtype=torch.float32)
            return cls(thresholds=torch.from_numpy(t.copy()), m_logical=zero,
                       dm_dvref=zero.clone(), noise=noise, params=params)
        span = float(t.max() - t.min()) if t.size else 0.0
        params = params or default_params()
        logical = t - (t.min() if t.size else 0.0)
        equispaced = t.size >= 2 and span > 0 and np.allclose(
            logical, np.linspace(0.0, span, t.size), atol=1e-3
        )
        if equispaced:
            knobs, achieved = _schedule_cached(t.size, int(round(span)))
            m_log = achieved
            dmdv = vref_sensitivity(params, knobs[:, 0], knobs[:, 1],
                                    knobs[:, 2])
        else:  # degenerate / non-uniform sweep: nearest-anchor provenance
            vr, ve, vs = anchor_knobs(logical)
            m_log = logical
            dmdv = vref_sensitivity(params, vr, ve, vs)
        return cls(
            thresholds=torch.from_numpy(t.copy()),
            m_logical=torch.from_numpy(np.array(m_log, np.float32)),
            dm_dvref=torch.from_numpy(np.array(dmdv, np.float32)),
            noise=noise,
            params=params,
        )

    @classmethod
    def for_head(cls, head, noise: NoiseModel = NOISELESS,
                 params: Optional[AnalogParams] = None) -> "SearchPhysics":
        """Physics for a deployed `ensemble.CAMEnsembleHead`, on the
        head's device."""
        with obs.span("physics.fit"):
            return cls.for_sweep(head.thresholds, noise, params).to(
                head.thresholds.device)

    def _base(self, lead_dims: int) -> torch.Tensor:
        return self.thresholds.reshape((self.n_passes,)
                                       + (1,) * (lead_dims + 1))

    def sample(self, generator: Optional[torch.Generator],
               batch_shape: tuple = (), n_rows: int = 1) -> torch.Tensor:
        """Sampled effective thresholds ``[P, *batch_shape, n_rows]``.

        Each (pass, batch element) is one silicon search cycle: the V_ref
        and strobe draws are shared across its `n_rows` rows; sigma_hd is
        drawn per row.  The generator must live on `self.device`.
        ``generator=None`` or a noiseless model returns the base schedule
        broadcast — the bit-exact noiseless limit.
        """
        batch_shape = tuple(batch_shape)
        shape = (self.n_passes,) + batch_shape + (n_rows,)
        with obs.span("sampler"):
            base = self._base(len(batch_shape))
            if generator is None or self.is_noiseless:
                return base.expand(shape)
            lead = (self.n_passes,) + (1,) * len(batch_shape) + (1,)
            delta = _sample_deltas(
                generator, self.noise,
                m_logical=self.m_logical.reshape(lead),
                dm_dvref=self.dm_dvref.reshape(lead),
                global_shape=(self.n_passes,) + batch_shape,
                n_rows=n_rows,
            )
            return base + delta

    def sample_keyed(self, key_words: torch.Tensor, n_rows: int,
                     n_samples: int = 1) -> torch.Tensor:
        """Per-request thresholds ``[P, n_samples, B, n_rows]`` from B keys.

        key_words : [B, 2] int64 uint32 words (`keys.as_key_words`) on
                    `self.device`.  Row b's thresholds depend on its own
                    key alone (counter-based, `core/keys.py`): the serving
                    determinism contract.  Per (sample, pass, b) one V_ref
                    and one strobe draw, sigma_hd per row.
        On the card one launch of the keyed sampler kernel draws them
        (`kernels/keyed_sampler.py`; the span counts kernel=1), on the CPU
        its plain version (kernel=0).
        """
        # local: core stays import-light
        from repro_torch.kernels import keyed_sampler

        b = key_words.shape[0]
        shape = (self.n_passes, n_samples, b, n_rows)
        with obs.span("sampler"):
            if self.is_noiseless:
                return self._base(2).expand(shape)
            out = keyed_sampler.keyed_thresholds(
                key_words, self.thresholds, self.m_logical, self.dm_dvref,
                self.noise, n_rows, n_samples)
            if obs.enabled():
                obs.count(kernel=int(key_words.is_cuda))
            return out
