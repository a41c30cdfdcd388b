"""The traffic: a closed loop over a pool of batches with work dispatched
ahead, and the host-clock spans the benchmark records around it.

Call i runs row batch i % (row batches) with, when the spec takes per-row
keys, key batch i % (key batches): the keys' pool is larger than the
rows', so each call of a window draws its own thresholds and a sample of
calls checks that many distinct draws.  It then copies its output into a
pinned host buffer without blocking and records an event.  At most
`in_flight` calls are outstanding: before call i + in_flight is
dispatched, the loop waits on call i's event.  A call's inputs count as
done when its output is on the host, at the moment the host sees that.
The output's shape and dtype are the model kind's (`bench/kinds/`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch


class Spans:
    """Host-clock spans by name, recorded only when enabled; inside a
    profiled stretch (`timeline` a list) each span's start and end are
    kept too, so the trace can say what the host was doing while the
    device idled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.timeline = None
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        self.seconds[name].append(t1 - t0)
        if self.timeline is not None:
            self.timeline.append((name, t0, t1))

    def __call__(self, name: str):
        return self._span(name) if self.enabled else contextlib.nullcontext()


class Reservoir:
    """A uniform sample of `k` of the loop's calls, drawn from the seed
    (Algorithm R, decided when a call is dispatched): each kept call's
    index, its inputs (`ClosedLoop.batches`) and its output, copied on the
    device into a buffer set aside in set-up, so keeping a call costs the
    host no more than a launch.  `output` is (shape, dtype) of one call's
    output."""

    def __init__(self, k: int, seed: int, output: tuple, device):
        shape, dtype = output
        self.k = k
        self.rng = np.random.default_rng([seed, 0xC4EC])
        self.seen = 0
        self.outs = torch.empty((k, *shape), dtype=dtype, device=device)
        self.calls: list[tuple[int, tuple]] = []

    def offer(self, index: int, batches: tuple, out: torch.Tensor) -> None:
        """Keep call `index` in place of a random earlier one, or not."""
        self.seen += 1
        if len(self.calls) < self.k:
            j = len(self.calls)
            self.calls.append((index, batches))
        else:
            j = int(self.rng.integers(self.seen))
            if j >= self.k:
                return
            self.calls[j] = (index, batches)
        self.outs[j].copy_(out, non_blocking=True)

    @property
    def kept(self) -> list:
        """[(call, (row batch, key batch or None), output on the host)]."""
        return [(i, b, self.outs[j].cpu())
                for j, (i, b) in enumerate(self.calls)]


@dataclasses.dataclass
class Stats:
    """What one stretch of the loop did."""

    seconds: float = 0.0  # the window's length (the run's end to end)
    dispatched: int = 0  # calls sent
    completed: int = 0  # calls whose output reached the host
    in_window: int = 0  # of those, the ones that did before the window closed


class ClosedLoop:
    """Drives `call(x, keys) -> out` over the pool; `output` is (shape,
    dtype) of one call's `out`."""

    def __init__(self, call, rows: torch.Tensor, keys, in_flight: int,
                 output: tuple, spans: Spans, keep: Reservoir):
        self.call, self.rows, self.keys = call, rows, keys
        self.in_flight, self.spans, self.keep = in_flight, spans, keep
        self.cuda = rows.device.type == "cuda"
        shape, dtype = output
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(in_flight)]
        self.events = [torch.cuda.Event() if self.cuda else None
                       for _ in range(in_flight)]
        self.next = 0  # the index of the next call, across stretches

    def batches(self, i: int) -> tuple:
        """(row batch, key batch or None) of call i."""
        return (i % self.rows.shape[0],
                None if self.keys is None else i % self.keys.shape[0])

    def inputs(self, i: int) -> tuple:
        """The rows and key words of call i."""
        rb, kb = self.batches(i)
        return self.rows[rb], None if kb is None else self.keys[kb]

    def _dispatch(self, i: int) -> None:
        slot = i % self.in_flight
        with self.spans("pipeline.run"):
            out = self.call(*self.inputs(i))
        with self.spans("copy"):
            self.keep.offer(i, self.batches(i), out)
            self.host[slot].copy_(out, non_blocking=self.cuda)
            if self.cuda:
                self.events[slot].record()

    def _complete(self, i: int, t_end: float, stats: Stats) -> None:
        slot = i % self.in_flight
        with self.spans("wait"):
            if self.cuda:
                self.events[slot].synchronize()
        if time.perf_counter() <= t_end:
            stats.in_window += 1
        stats.completed += 1

    def run(self, seconds: float | None = None,
            calls: int | None = None) -> Stats:
        """One stretch: dispatch until `seconds` have passed or `calls`
        were sent, then wait for every call still out."""
        stats = Stats()
        pending: collections.deque = collections.deque()
        t_start = time.perf_counter()
        t_end = t_start + seconds if seconds is not None else float("inf")
        while True:
            if len(pending) == self.in_flight:
                self._complete(pending.popleft(), t_end, stats)
            if time.perf_counter() >= t_end or (
                    calls is not None and stats.dispatched >= calls):
                break
            self._dispatch(self.next)
            pending.append(self.next)
            self.next += 1
            stats.dispatched += 1
        while pending:
            self._complete(pending.popleft(), t_end, stats)
        stats.seconds = (seconds if seconds is not None
                         else time.perf_counter() - t_start)
        return stats
