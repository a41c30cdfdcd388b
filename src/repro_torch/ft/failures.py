"""Failure injection for fault-tolerance tests (port of
`repro/ft/failures.py`).

Wraps a step function so it raises at chosen steps (once each), emulating
device loss / preemption.  Also provides a slow-step wrapper for
straggler-detector tests.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable


class InjectedFailure(RuntimeError):
    pass


def failing_step(step_fn: Callable, fail_at: Iterable[int]) -> Callable:
    remaining = set(fail_at)
    counter = {"step": 0}

    def wrapped(state, batch):
        s = counter["step"]
        counter["step"] += 1
        if s in remaining:
            remaining.discard(s)
            raise InjectedFailure(f"injected failure at step {s}")
        return step_fn(state, batch)

    return wrapped


def slow_step(step_fn: Callable, slow_at: Iterable[int], delay_s: float):
    slow = set(slow_at)
    counter = {"step": 0}

    def wrapped(state, batch):
        s = counter["step"]
        counter["step"] += 1
        if s in slow:
            time.sleep(delay_s)
        return step_fn(state, batch)

    return wrapped
