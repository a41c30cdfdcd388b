"""Fault-tolerant training supervisor: checkpoint/restart, failure
isolation, straggler monitoring, heartbeats (port of
`repro/ft/supervisor.py`).

The contract:
  * every step is RESTARTABLE: state lives in (checkpoint, data cursor),
    and the data pipeline is deterministic in (seed, step), so a restart
    replays the exact failed step;
  * failures are CONTAINED: a step exception (a CUDA error, an injected
    fault) triggers restore-from-latest + replay, up to max_restarts,
    with exponential backoff;
  * stragglers are DETECTED: per-step wall times feed an EWMA z-score
    detector; sustained outliers call `on_straggler`;
  * liveness is OBSERVABLE: a heartbeat file is touched every step.

The port's train step updates its state in place, so a restart writes
the checkpoint back into the live state's tensors (`ckpt.load_into`).
Before the first checkpoint it writes back a host copy of the state
taken when `run` began: the initial state as it was, not as the steps
since have left it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         load_into, restore, snapshot)


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: Path
    ckpt_every: int = 50
    keep_last: int = 3
    max_restarts: int = 5
    backoff_s: float = 0.1
    heartbeat: Optional[Path] = None
    # straggler detection
    ewma_alpha: float = 0.1
    straggler_z: float = 4.0
    straggler_patience: int = 3


class StragglerMonitor:
    """EWMA mean/variance z-score over step wall times."""

    def __init__(self, alpha: float, z: float, patience: int):
        self.alpha, self.z, self.patience = alpha, z, patience
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.strikes = 0
        self.alerts: list[dict] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when a straggler alert fires."""
        if self.mean is None:
            self.mean = dt
            return False
        sd = max(self.var**0.5, 1e-6, 0.05 * self.mean)
        zscore = (dt - self.mean) / sd
        fire = False
        if zscore > self.z:
            self.strikes += 1
            if self.strikes >= self.patience:
                self.alerts.append(
                    {"step": step, "dt": dt, "mean": self.mean, "z": zscore}
                )
                self.strikes = 0
                fire = True
            # ROBUST update: outlier samples do not enter the EWMA —
            # otherwise a sustained straggler inflates the variance and
            # masks itself before `patience` strikes accumulate
            return fire
        self.strikes = 0
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return fire


def _sync() -> None:
    """Wait for the card's queued work (the step's end), if it has any."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Supervisor:
    """Runs (step_fn, data_iter_factory) with checkpoint/restart.

    `state_template`: a tree of the state's structure and shapes (the
    state itself will do). A restored checkpoint lands on the live
    tensors' devices."""

    def __init__(
        self,
        cfg: SupervisorConfig,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        make_data: Callable[[int], Iterator],  # start_step -> iterator
        state_template,
        on_straggler: Optional[Callable[[dict], None]] = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_data = make_data
        self.state_template = state_template
        self.on_straggler = on_straggler
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_last)
        self.monitor = StragglerMonitor(
            cfg.ewma_alpha, cfg.straggler_z, cfg.straggler_patience
        )
        self.restarts = 0
        self.history: list[dict] = []
        self._initial = None

    def _restore_or(self, state):
        """(state, step) from the latest checkpoint, written into `state`;
        without one, `state` reset to the copy `run` took at its start."""
        last = latest_step(self.cfg.ckpt_dir)
        if last is None:
            if self._initial is not None:
                state = load_into(state, self._initial)
            return state, 0
        values, step = restore(self.cfg.ckpt_dir, last, self.state_template)
        return load_into(state, values), step

    def _heartbeat(self, step: int):
        hb = self.cfg.heartbeat
        if hb is not None:
            hb.write_text(json.dumps({"step": step, "time": time.time()}))

    def run(self, init_state, n_steps: int):
        """Train to n_steps total, surviving step failures."""
        state, start = self._restore_or(init_state)
        if start == 0:  # the state to restart from until a checkpoint
            self._initial = snapshot(state)
        while start < n_steps:
            data = self.make_data(start)
            try:
                for step in range(start, n_steps):
                    batch = next(data)
                    t0 = time.time()
                    state, metrics = self.step_fn(state, batch)
                    _sync()
                    dt = time.time() - t0
                    self._heartbeat(step)
                    if self.monitor.observe(step, dt) and self.on_straggler:
                        self.on_straggler(self.monitor.alerts[-1])
                    self.history.append(
                        {"step": step, "dt": dt,
                         **{k: float(v) for k, v in metrics.items()}}
                    )
                    if (step + 1) % self.cfg.ckpt_every == 0:
                        self.ckpt.save_async(step + 1, state)
                        self._initial = None
                start = n_steps
            except Exception:  # noqa: BLE001 — containment boundary
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                time.sleep(self.cfg.backoff_s * 2 ** (self.restarts - 1))
                self.ckpt.wait()
                state, start = self._restore_or(state)
        self.ckpt.wait()
        return state
