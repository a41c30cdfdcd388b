"""Behavioural model of the PiC-BNN analog matchline (port of
`repro/core/device_model.py`).

The silicon senses the Hamming distance between a query and a stored row
through the discharge rate of the matchline: every mismatching bitcell
opens one pull-down path.  The MLSA compares ``V_ML`` at a sampling time
``t_s`` against ``V_ref``; three knobs set the effective Hamming-distance
(HD) tolerance threshold (paper Sec. III/IV, Table I)::

    V_ML(t; m) = VDD * exp(-m * g(V_eval) * t(V_st) / C_ML)
    match  <=>  m < m* = ln(VDD / V_ref) * C / (g(V_eval) * t_s(V_st))

with ``g(v) = max(v - V_TH, 0)**alpha`` and ``t_s`` affine in V_st.

Everything here runs on the host, once, at compile time: numpy, plus
scipy's `least_squares` and `RBFInterpolator` for the Table-I fit.  The
arithmetic keeps the reference's float32/float64 mix: the reference
evaluates `hd_threshold` (and the conductance / sampling-time terms) in
float32 jax arithmetic, converting each float64 operand to float32 at the
first jax operation, while the fit's own model is float64 numpy.  Here
those steps are numpy float32 at the same places, so the calibrated
thresholds agree to 1e-5 HD and the knob-schedule grid search picks the
same V_ref wherever the choice is not a tie: numpy's float32 `log` and
`power` differ from XLA's in the last bit for some inputs, which decides
ties among grid points whose calibrated tolerance clips to 0.
`hd_threshold` also takes torch tensors (float32 torch arithmetic, for
`physics.sample_effective_threshold`'s perturbed voltages on the device).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

# Silicon operating points: Table I of the paper.
#   (V_ref [mV], V_eval [mV], V_st [mV]) -> HD tolerance threshold
TABLE1 = np.array(
    [
        # V_ref, V_eval, V_st, HD
        [1200.0, 1200.0, 1200.0, 0.0],
        [750.0, 950.0, 1200.0, 4.0],
        [775.0, 600.0, 1200.0, 8.0],
        [1175.0, 350.0, 1150.0, 12.0],
        [950.0, 525.0, 1100.0, 16.0],
        [1025.0, 475.0, 1000.0, 20.0],
        [950.0, 500.0, 1025.0, 24.0],
        [775.0, 600.0, 1100.0, 28.0],
        [1175.0, 400.0, 1150.0, 32.0],
        [1000.0, 475.0, 725.0, 36.0],
    ]
)

# Table II silicon measurements (the performance/energy model).
TECHNOLOGY_NM = 65
VDD_V = 1.2
SOC_AREA_MM2 = 2.38
PICBNN_AREA_MM2 = 0.87
PICBNN_CAPACITY_KBIT = 128
PICBNN_POWER_MW = 0.8
SOC_POWER_MW = 0.3  # PiC-BNN + RISC-V control processor ("overall")
PICBNN_TOPS = 184.0
CLOCK_HZ = 25e6
MNIST_INFERENCES_PER_S = 560e3
INFERENCES_PER_S_PER_W = 703e6
BITCELL_AREA_UM2 = 3.24
BANK_AREA_MM2 = 0.21
N_BANKS = 4

# Logical bank configurations (paper Sec. III): rows x row-width.
BANK_CONFIGS = ((512, 256), (1024, 128), (2048, 64))


def _f32(x):
    """float32 of `x` as the reference's first jax operation makes it:
    a float64 array or Python float rounds to float32 there."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.asarray(x, np.float32)


def _clamp_min(x, lo: float):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=lo)
    return np.maximum(x, np.float32(lo))


def _clamp_max(x, hi: float):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, max=hi)
    return np.minimum(x, np.float32(hi))


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


@dataclasses.dataclass(frozen=True)
class AnalogParams:
    """Free constants of the behavioural matchline model.

    The defaults are placeholders; `default_params()` gives the result of
    :func:`calibrate_table1` (least squares over the ten Table I points).
    """

    vdd: float = 1.2  # supply [V]
    v_th: float = 0.30  # M_eval threshold voltage [V] (65nm regular-VT)
    alpha: float = 1.3  # alpha-power-law exponent (short channel)
    # Discharge constant: ln(VDD/V_ref) * c_over_g / (g_rel * t_rel) = m*
    c_over_g: float = 250.0  # lumped C_ML / k  [fitted, dimensionless scale]
    # Sampling time model: t_s = t0 + t1 * (VDD - V_st)
    t0: float = 0.35
    t1: float = 1.0

    def g_rel(self, v_eval):
        """Relative conductance of M_eval (alpha-power law, saturated),
        float32."""
        v_ov = _clamp_min(_f32(v_eval - self.v_th), 1e-6)
        if isinstance(v_ov, torch.Tensor):
            return v_ov ** self.alpha
        return np.power(v_ov, np.float32(self.alpha))

    def t_sample(self, v_st):
        """Relative MLSA sampling time, affine in (VDD - V_st): lowering
        V_st delays the sample, float32."""
        lag = _clamp_min(_f32(self.vdd - v_st), 0.0)
        if isinstance(lag, torch.Tensor):
            return self.t0 + self.t1 * lag
        return np.float32(self.t0) + np.float32(self.t1) * lag


def hd_threshold(params: AnalogParams, v_ref, v_eval, v_st):
    """Continuous HD tolerance threshold m* for a knob setting (volts),
    float32 (a torch tensor when `v_ref` is one, else numpy).

    A row matches iff its Hamming distance m satisfies ``m <= m*``;
    V_ref == VDD gives m* = 0 (exact match).
    """
    v_ref = _f32(v_ref)
    if isinstance(v_ref, torch.Tensor):
        ratio = params.vdd / _clamp_max(v_ref, params.vdd)
    else:
        ratio = np.float32(params.vdd) / _clamp_max(v_ref, params.vdd)
    lnr = _log(_clamp_min(ratio, 1.0))
    denom = params.g_rel(v_eval) * params.t_sample(v_st)
    if isinstance(lnr, torch.Tensor):
        denom = torch.as_tensor(denom, dtype=torch.float32,
                                device=lnr.device)
        return params.c_over_g * lnr / denom
    return np.asarray(np.float32(params.c_over_g) * lnr / denom)


def table1_residuals(params: AnalogParams) -> np.ndarray:
    """Model-vs-silicon HD threshold residuals over the Table I points
    (float32 model minus float64 measurement: float64)."""
    v = TABLE1
    pred = np.asarray(
        hd_threshold(params, v[:, 0] / 1e3, v[:, 1] / 1e3, v[:, 2] / 1e3)
    )
    return pred - v[:, 3]


def calibrate_table1(iters: int = 200,
                     seed: int = 0) -> tuple[AnalogParams, float]:
    """Least-squares fit of the free model constants against Table I.

    Multi-start trust-region least squares over (c_over_g, alpha, v_th,
    t0, t1), float64 numpy throughout.  The silicon surface is
    non-monotone in V_eval, so a smooth 5-parameter model leaves an RMSE
    of ~6-7 HD units; :class:`CalibratedModel` closes it with an RBF
    residual.  Returns (fitted params, RMSE in HD units).
    """
    from scipy.optimize import least_squares  # deferred: host-side only

    v = TABLE1
    vr, ve, vs, hd = v[:, 0] / 1e3, v[:, 1] / 1e3, v[:, 2] / 1e3, v[:, 3]

    def predict(theta):
        c, a, vt, t0, t1 = theta
        g = np.maximum(ve - vt, 1e-4) ** a
        ts = np.maximum(t0 + t1 * np.maximum(1.2 - vs, 0.0), 1e-3)
        lnr = np.log(np.maximum(1.2 / np.minimum(vr, 1.2), 1.0))
        return c * lnr / (g * ts)

    def resid(theta):
        return predict(theta) - hd

    rng = np.random.default_rng(seed)
    best = None
    lo = [1.0, 0.3, 0.0, 0.01, 0.0]
    hi = [5000.0, 2.5, 0.34, 5.0, 10.0]
    for _ in range(iters):
        x0 = np.array([rng.uniform(l, h) for l, h in zip(lo, hi)])
        try:
            r = least_squares(resid, x0, bounds=(lo, hi))
        except Exception:
            continue
        if best is None or r.cost < best.cost:
            best = r
    assert best is not None
    c, a, vt, t0, t1 = (float(x) for x in best.x)
    fitted = AnalogParams(c_over_g=c, alpha=a, v_th=vt, t0=t0, t1=t1)
    rmse = float(np.sqrt(np.mean(table1_residuals(fitted) ** 2)))
    return fitted, rmse


@dataclasses.dataclass(frozen=True)
class CalibratedModel:
    """Physical model + per-chip RBF residual anchored at Table I points.

    ``hd_threshold(knobs)`` = physical(knobs) + rbf_residual(knobs): exact
    at the ten measured operating points, smooth in between (what silicon
    bring-up does with per-die calibration tables).
    """

    params: AnalogParams
    _rbf: object  # scipy RBFInterpolator over (V_ref, V_eval, V_st) [V]

    @classmethod
    def fit(cls, params: Optional[AnalogParams] = None) -> "CalibratedModel":
        """Fit the RBF residual over Table I for `params` (default: a
        fresh `calibrate_table1`)."""
        from scipy.interpolate import RBFInterpolator

        if params is None:
            params, _ = calibrate_table1()
        pts = TABLE1[:, :3] / 1e3
        res = -table1_residuals(params)  # correction = measured - model
        rbf = RBFInterpolator(pts, res, kernel="thin_plate_spline")
        return cls(params=params, _rbf=rbf)

    def hd_threshold(self, v_ref, v_eval, v_st) -> np.ndarray:
        """Calibrated threshold: float32 model + float64 residual, >= 0."""
        knobs = np.stack(
            np.broadcast_arrays(
                np.asarray(v_ref, float),
                np.asarray(v_eval, float),
                np.asarray(v_st, float),
            ),
            axis=-1,
        ).reshape(-1, 3)
        base = np.asarray(
            hd_threshold(self.params, knobs[:, 0], knobs[:, 1], knobs[:, 2])
        )
        corrected = base + self._rbf(knobs)
        return np.maximum(corrected, 0.0).reshape(np.shape(v_ref))

    def residuals_table1(self) -> np.ndarray:
        """Calibrated-model residuals at the Table I points (~0)."""
        v = TABLE1
        pred = self.hd_threshold(v[:, 0] / 1e3, v[:, 1] / 1e3, v[:, 2] / 1e3)
        return pred - v[:, 3]


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Gaussian PVT variation applied to a CAM search.

    sigma_hd        — per-row input-referred noise, in HD units (MLSA
                      offset + discharge-path mismatch).
    sigma_vref      — V_ref drift [V], converted through d(m*)/d(V_ref).
    sigma_tjitter   — relative sampling-time jitter (fraction of t_s).
    temp_drift_hd   — deterministic HD-threshold offset shared by all
                      rows of a pass (temperature drift).
    """

    sigma_hd: float = 1.0
    sigma_vref: float = 0.01
    sigma_tjitter: float = 0.02
    temp_drift_hd: float = 0.0

    @property
    def is_active(self) -> bool:
        """True when ANY non-ideality (random sigma or drift) is nonzero."""
        return bool(
            self.sigma_hd
            or self.sigma_vref
            or self.sigma_tjitter
            or self.temp_drift_hd
        )

    def effective_threshold(self, generator: torch.Generator,
                            params: AnalogParams, v_ref, v_eval, v_st,
                            shape=()):
        """Sample a per-row effective HD threshold under PVT noise
        (delegates to `physics.sample_effective_threshold`)."""
        from repro_torch.core import physics  # deferred: circular import

        return physics.sample_effective_threshold(
            generator, params, self, v_ref, v_eval, v_st, shape
        )


NOISELESS = NoiseModel(sigma_hd=0.0, sigma_vref=0.0, sigma_tjitter=0.0)

# Silicon-like default: ~1 HD unit of row noise, 10 mV V_ref sigma, 2% jitter
SILICON = NoiseModel()


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-operation energy/latency derived from Table II silicon figures.

    One CAM search over a bank of R rows x W bits performs R*W binary MACs
    in a single cycle; at 25 MHz and 0.8 mW one cycle costs 32 pJ.
    """

    clock_hz: float = CLOCK_HZ
    power_w: float = PICBNN_POWER_MW * 1e-3
    soc_power_w: float = (PICBNN_POWER_MW + SOC_POWER_MW) * 1e-3
    tuning_cycles: int = 2500  # voltage re-tune latency (amortized, Sec. V-B)

    @property
    def energy_per_cycle_j(self) -> float:
        """Joules per search cycle of the whole macro."""
        return self.power_w / self.clock_hz

    def search_energy_j(self, rows: int, width: int) -> float:
        """Energy of one search cycle, scaled by active array fraction."""
        full = 4 * 2048 * 64  # all banks active, largest config
        frac = (rows * width) / full
        return self.energy_per_cycle_j * max(min(frac, 1.0), 0.01)

    def ops_per_search(self, rows: int, width: int) -> int:
        """Binary operations of one search (XNOR + accumulate per cell)."""
        return 2 * rows * width


@functools.lru_cache(maxsize=1)
def default_params() -> AnalogParams:
    """Calibrated-by-default analog constants (cached; ~5 s once)."""
    params, _rmse = calibrate_table1(iters=60)
    return params


@functools.lru_cache(maxsize=1)
def default_calibrated() -> CalibratedModel:
    """`CalibratedModel.fit(default_params())`, cached."""
    return CalibratedModel.fit(default_params())


def knob_schedule(
    n_thresholds: int,
    max_hd: int,
    params: Optional[AnalogParams] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """A (V_ref, V_eval, V_st) schedule sweeping HD tolerance.

    Each target of ``linspace(0, max_hd, n)`` takes V_eval/V_st from the
    nearest Table I anchor and V_ref from a 512-point grid search of the
    calibrated model (the RBF correction makes the surface only
    piecewise monotone).  Returns (knobs [n,3] float32 volts, achieved
    HD thresholds [n] under the calibrated model).
    """
    params = params or default_params()
    cal = default_calibrated()
    targets = np.linspace(0.0, max_hd, n_thresholds)
    anchor_idx = np.abs(TABLE1[:, 3][None, :] - targets[:, None]).argmin(1)
    v_eval = TABLE1[anchor_idx, 1] / 1e3
    v_st = TABLE1[anchor_idx, 2] / 1e3
    grid = np.linspace(0.30, params.vdd, 512)
    v_ref = np.empty(n_thresholds)
    for i, tgt in enumerate(targets):
        pred = cal.hd_threshold(
            grid, np.full_like(grid, v_eval[i]), np.full_like(grid, v_st[i])
        )
        v_ref[i] = grid[np.abs(pred - tgt).argmin()]
    knobs = np.stack([v_ref, v_eval, v_st], axis=-1).astype(np.float32)
    achieved = cal.hd_threshold(knobs[:, 0], knobs[:, 1], knobs[:, 2])
    return knobs, np.asarray(achieved)
