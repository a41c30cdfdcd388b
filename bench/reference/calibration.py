"""The knob-space provenance of the paper's threshold sweep, worked out
again from Table I: a frozen copy of the matchline model's fit, its RBF
correction and the knob schedule, in numpy and scipy alone.

The silicon draws perturb each pass's threshold by
``dm_dvref * sigma_vref * z_v + m_logical * (1 / max(1 + sigma_tj * z_t,
0.5) - 1) + sigma_hd * z_row + drift``; `pass_fields` gives the per-pass
``m_logical`` (the tolerance the knobs achieve) and ``dm_dvref`` (the
analytic d(m*)/dV_ref at each pass's knob point), float32, with the same
float32 / float64 mix at the same places as the system under test, so
the two agree bit for bit on one machine.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# PiC-BNN Table I: (V_ref [mV], V_eval [mV], V_st [mV]) -> HD tolerance.
TABLE1 = np.array([
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
])


def _f32(x):
    return np.asarray(x, np.float32)


@dataclasses.dataclass(frozen=True)
class Matchline:
    """The matchline's free constants: m* = c_over_g * ln(VDD / V_ref) /
    (g(V_eval) t_s(V_st)), g the alpha-power law, t_s affine in V_st."""

    vdd: float = 1.2
    v_th: float = 0.30
    alpha: float = 1.3
    c_over_g: float = 250.0
    t0: float = 0.35
    t1: float = 1.0

    def g_rel(self, v_eval):
        v_ov = np.maximum(_f32(v_eval - self.v_th), np.float32(1e-6))
        return np.power(v_ov, np.float32(self.alpha))

    def t_sample(self, v_st):
        lag = np.maximum(_f32(self.vdd - v_st), np.float32(0.0))
        return np.float32(self.t0) + np.float32(self.t1) * lag

    def threshold(self, v_ref, v_eval, v_st) -> np.ndarray:
        """m* in HD units, float32."""
        ratio = np.float32(self.vdd) / np.minimum(_f32(v_ref),
                                                  np.float32(self.vdd))
        lnr = np.log(np.maximum(ratio, np.float32(1.0)))
        denom = self.g_rel(v_eval) * self.t_sample(v_st)
        return np.asarray(np.float32(self.c_over_g) * lnr / denom)


def _residuals(m: Matchline) -> np.ndarray:
    v = TABLE1
    return np.asarray(m.threshold(v[:, 0] / 1e3, v[:, 1] / 1e3,
                                  v[:, 2] / 1e3)) - v[:, 3]


def fit_table1(iters: int = 60, seed: int = 0) -> Matchline:
    """Multi-start bounded least squares of (c_over_g, alpha, v_th, t0,
    t1) against Table I, float64."""
    from scipy.optimize import least_squares

    v = TABLE1
    vr, ve, vs, hd = v[:, 0] / 1e3, v[:, 1] / 1e3, v[:, 2] / 1e3, v[:, 3]

    def resid(theta):
        c, a, vt, t0, t1 = theta
        g = np.maximum(ve - vt, 1e-4) ** a
        ts = np.maximum(t0 + t1 * np.maximum(1.2 - vs, 0.0), 1e-3)
        lnr = np.log(np.maximum(1.2 / np.minimum(vr, 1.2), 1.0))
        return c * lnr / (g * ts) - hd

    rng = np.random.default_rng(seed)
    best = None
    lo = [1.0, 0.3, 0.0, 0.01, 0.0]
    hi = [5000.0, 2.5, 0.34, 5.0, 10.0]
    for _ in range(iters):
        x0 = np.array([rng.uniform(l, h) for l, h in zip(lo, hi)])
        try:
            r = least_squares(resid, x0, bounds=(lo, hi))
        except (ValueError, np.linalg.LinAlgError):
            continue
        if best is None or r.cost < best.cost:
            best = r
    if best is None:
        raise RuntimeError("no start of the Table I fit converged")
    c, a, vt, t0, t1 = (float(x) for x in best.x)
    return Matchline(c_over_g=c, alpha=a, v_th=vt, t0=t0, t1=t1)


@functools.lru_cache(maxsize=1)
def calibrated():
    """(fitted matchline, RBF residual over Table I's knobs)."""
    from scipy.interpolate import RBFInterpolator

    m = fit_table1()
    rbf = RBFInterpolator(TABLE1[:, :3] / 1e3, -_residuals(m),
                          kernel="thin_plate_spline")
    return m, rbf


def calibrated_threshold(v_ref, v_eval, v_st) -> np.ndarray:
    """Model (float32) plus the float64 RBF correction, floored at 0."""
    m, rbf = calibrated()
    knobs = np.stack(np.broadcast_arrays(
        np.asarray(v_ref, float), np.asarray(v_eval, float),
        np.asarray(v_st, float)), axis=-1).reshape(-1, 3)
    base = np.asarray(m.threshold(knobs[:, 0], knobs[:, 1], knobs[:, 2]))
    return np.maximum(base + rbf(knobs), 0.0).reshape(np.shape(v_ref))


@functools.lru_cache(maxsize=4)
def knob_schedule(n: int, max_hd: int):
    """Knobs [n, 3] float32 and achieved tolerances [n] for the targets
    linspace(0, max_hd, n): V_eval and V_st from the nearest Table I
    anchor, V_ref from a 512-point grid of the calibrated model."""
    m, _ = calibrated()
    targets = np.linspace(0.0, max_hd, n)
    idx = np.abs(TABLE1[:, 3][None, :] - targets[:, None]).argmin(1)
    v_eval, v_st = TABLE1[idx, 1] / 1e3, TABLE1[idx, 2] / 1e3
    grid = np.linspace(0.30, m.vdd, 512)
    v_ref = np.empty(n)
    for i, tgt in enumerate(targets):
        pred = calibrated_threshold(grid, np.full_like(grid, v_eval[i]),
                                    np.full_like(grid, v_st[i]))
        v_ref[i] = grid[np.abs(pred - tgt).argmin()]
    knobs = np.stack([v_ref, v_eval, v_st], axis=-1).astype(np.float32)
    return knobs, np.asarray(
        calibrated_threshold(knobs[:, 0], knobs[:, 1], knobs[:, 2]))


def pass_fields(thresholds, sigma_vref: float, sigma_tjitter: float):
    """(m_logical [P], dm_dvref [P]) float32 for an equispaced HD sweep:
    zeros where no knob-space sigma is active."""
    t = np.asarray(thresholds, np.float32)
    if not (sigma_vref or sigma_tjitter):
        return np.zeros_like(t), np.zeros_like(t)
    span = float(t.max() - t.min())
    logical = t - t.min()
    if not (t.size >= 2 and span > 0 and np.allclose(
            logical, np.linspace(0.0, span, t.size), atol=1e-3)):
        raise ValueError("the benchmark's sweeps are equispaced")
    knobs, achieved = knob_schedule(t.size, int(round(span)))
    knobs = np.asarray(knobs, np.float32)
    m, _ = calibrated()
    denom = m.g_rel(knobs[:, 1]) * m.t_sample(knobs[:, 2])
    dmdv = np.float32(-m.c_over_g) / (
        np.maximum(_f32(knobs[:, 0]), np.float32(1e-3)) * denom)
    return (np.array(np.asarray(achieved, np.float32), np.float32),
            np.array(dmdv, np.float32))
