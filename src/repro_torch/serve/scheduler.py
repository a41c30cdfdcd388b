"""Deadline-driven dynamic micro-batcher + shared serving metrics.

The port's own copy of `repro/serve/scheduler.py` (numpy only): the
coalescing half of the classification serving engine (serve/picbnn.py),
kept free of any device framework so its policy logic is unit-testable
with a fake clock:

  MicroBatcher — thread-safe multi-lane request queue.  One lane per
      model; a batch never mixes lanes (each lane dispatches into its own
      compiled pipeline).  `next_batch` returns a lane's requests when
      the lane reaches `max_batch` (a full bucket) OR its oldest request
      has waited `max_wait_us` (the latency deadline), whichever comes
      first — the classic dynamic-batching trade: batch occupancy vs
      added queueing latency.  Expected dispatch size at arrival rate
      lambda is therefore ~min(max_batch, lambda * max_wait), and the
      coalescing delay any request can suffer is bounded by max_wait
      (the reference's DESIGN.md §9 works the math).

  BatchingPolicy — the knobs, plus `max_queue` admission control
      (bounded total depth; QueueFullError on non-blocking overflow) and
      `max_inflight` (how many dispatched batches may be awaiting device
      completion — the host->device staging / compute overlap depth).

  LatencySummary / latency_summary — the one latency vocabulary shared
      by the classifier engine and its load measurements: per-request
      queue / service / total milliseconds summarized as
      mean/p50/p95/p99/max.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import numpy as np


class QueueFullError(RuntimeError):
    """Admission control rejected a request (queue at max_queue)."""


@dataclasses.dataclass(frozen=True)
class BatchingPolicy:
    """Knobs of the deadline-driven micro-batcher.

    max_batch   : dispatch as soon as a lane holds this many requests
                  (align with the pipeline's bucket grid / max_bucket so
                  dispatches land on precompiled buckets at occupancy 1).
    max_wait_us : dispatch a partial lane once its OLDEST request has
                  waited this long — the coalescing-latency deadline.
    max_queue   : total queued requests across lanes admitted before
                  submit blocks (or raises QueueFullError when
                  non-blocking).  0 = unbounded.
    max_inflight: dispatched-but-uncompleted batch depth; bounds device
                  queue growth while letting staging overlap compute.
    """

    max_batch: int = 256
    max_wait_us: float = 2000.0
    max_queue: int = 0
    max_inflight: int = 2

    @property
    def max_wait_s(self) -> float:
        """The dispatch deadline in seconds."""
        return self.max_wait_us * 1e-6


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    """Percentile summary of a per-request millisecond series."""

    n: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float

    def __str__(self) -> str:
        return (f"mean {self.mean_ms:.3f} / p50 {self.p50_ms:.3f} / "
                f"p95 {self.p95_ms:.3f} / p99 {self.p99_ms:.3f} / "
                f"max {self.max_ms:.3f} ms")


def latency_summary(values_ms) -> LatencySummary:
    """Count/mean/p50/p95/p99 (ms) of a latency sample array."""
    v = np.asarray(values_ms, np.float64)
    if v.size == 0:
        return LatencySummary(0, 0.0, 0.0, 0.0, 0.0, 0.0)
    return LatencySummary(
        n=int(v.size),
        mean_ms=float(v.mean()),
        p50_ms=float(np.percentile(v, 50)),
        p95_ms=float(np.percentile(v, 95)),
        p99_ms=float(np.percentile(v, 99)),
        max_ms=float(v.max()),
    )


@dataclasses.dataclass(frozen=True)
class Span:
    """A contiguous request range [lo, hi) of one enqueued lot."""

    t_enqueue: float
    lot: Any
    lo: int
    hi: int

    @property
    def n(self) -> int:
        """Requests covered by this span."""
        return self.hi - self.lo


class MicroBatcher:
    """Thread-safe deadline-driven request coalescer (multi-lane).

    Requests are enqueued as LOTS — an opaque object carrying `size`
    requests (a client burst is one lot; a single request is a lot of
    size 1).  Keeping lots intact until dispatch is what makes the hot
    path O(1) per *burst* instead of O(1) per request: no per-request
    queue nodes, no per-request lock traffic.  `next_batch` assembles up
    to `max_batch` requests as a list of `Span`s, splitting the last lot
    when it straddles the batch boundary (the remainder keeps its
    original enqueue time — its deadline clock must not reset).

    Dispatch rule per lane: full batch available, OR the lane's oldest
    request has waited `max_wait_us`, OR draining after close().

    `put` is called by any number of client threads, `next_batch` by the
    single dispatch thread.  `clock` is injectable (monotonic seconds)
    so deadline behavior is unit-testable without sleeping.
    """

    def __init__(self, policy: BatchingPolicy,
                 clock: Callable[[], float] = time.perf_counter):
        self.policy = policy
        self._clock = clock
        # lane -> deque of [t_enqueue, lot, lo, hi] (lo advances as the
        # dispatcher consumes the lot front-to-back)
        self._lanes: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        self._sizes: dict[str, int] = {}  # per-lane queued request count
        self._cond = threading.Condition()
        self._closed = False
        self._depth = 0
        self.high_water = 0  # max total queued requests ever observed

    @property
    def depth(self) -> int:
        """Requests currently queued across all lanes."""
        return self._depth

    @property
    def closed(self) -> bool:
        """True once close() was called; puts are rejected after."""
        return self._closed

    def put(self, lane: str, lot: Any, size: int = 1,
            t_enqueue: Optional[float] = None, block: bool = True,
            timeout: Optional[float] = None) -> None:
        """Enqueue one lot of `size` requests.  Raises QueueFullError
        when bounded admission cannot take the whole lot (immediately if
        block=False, after `timeout` otherwise), RuntimeError after
        close()."""
        if size <= 0:
            raise ValueError(f"lot size must be >= 1, got {size}")
        p = self.policy
        if p.max_queue and size > p.max_queue:
            # can NEVER fit, even into an empty queue: reject now — a
            # blocking put would otherwise wait forever
            raise QueueFullError(
                f"lot of {size} exceeds max_queue {p.max_queue}"
            )
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if p.max_queue:
                deadline = (None if timeout is None
                            else self._clock() + timeout)
                while self._depth + size > p.max_queue:
                    if not block:
                        raise QueueFullError(
                            f"queue full ({self._depth}+{size}"
                            f">{p.max_queue})"
                        )
                    remaining = (None if deadline is None
                                 else deadline - self._clock())
                    if remaining is not None and remaining <= 0:
                        raise QueueFullError(
                            f"queue full ({self._depth}/{p.max_queue}) "
                            f"after {timeout}s"
                        )
                    self._cond.wait(remaining)
                    if self._closed:
                        raise RuntimeError("MicroBatcher is closed")
            dq = self._lanes.get(lane)
            if dq is None:
                dq = self._lanes[lane] = collections.deque()
                self._sizes[lane] = 0
            was = self._sizes[lane]
            dq.append([self._clock() if t_enqueue is None else t_enqueue,
                       lot, 0, size])
            self._sizes[lane] = was + size
            self._depth += size
            self.high_water = max(self.high_water, self._depth)
            # wake the dispatcher only when its wait target can change: a
            # lane starting its deadline clock, or crossing a full batch
            if was == 0 or (was < p.max_batch <= was + size):
                self._cond.notify_all()

    def _ready_lane(self, now: float):
        """(lane, deadline) of the dispatchable/oldest lane.

        (lane, None): dispatch NOW; (lane, t): sleep until t;
        (None, None): empty.  Priority order:

        1. lanes whose OLDEST request has passed its max_wait deadline
           (or draining after close), oldest head first — the bounded-
           delay contract: a flooded sibling lane that is perpetually
           full must not starve an expired partial batch;
        2. otherwise any full lane (costs no extra waiting, frees
           admission capacity fastest);
        3. otherwise sleep until the oldest head's deadline.
        """
        oldest_lane, oldest_t = None, None
        full_lane = None
        for lane, dq in self._lanes.items():
            if not dq:
                continue
            if oldest_t is None or dq[0][0] < oldest_t:
                oldest_lane, oldest_t = lane, dq[0][0]
            if full_lane is None and \
                    self._sizes[lane] >= self.policy.max_batch:
                full_lane = lane
        if oldest_lane is None:
            return None, None
        deadline = oldest_t + self.policy.max_wait_s
        if self._closed or now >= deadline:
            return oldest_lane, None
        if full_lane is not None:
            return full_lane, None
        return oldest_lane, deadline

    def next_batch(self, timeout: Optional[float] = None):
        """Block until a batch is due; return (lane, [Span, ...]) with
        span sizes summing to <= max_batch.

        Returns None when closed-and-drained, or when `timeout` elapses
        with nothing due (timeout=0 polls).
        """
        outer = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                now = self._clock()
                lane, deadline = self._ready_lane(now)
                if lane is not None and deadline is None:
                    dq = self._lanes[lane]
                    spans: list[Span] = []
                    room = self.policy.max_batch
                    while dq and room > 0:
                        entry = dq[0]
                        t, lot, lo, hi = entry
                        take = min(hi - lo, room)
                        spans.append(Span(t, lot, lo, lo + take))
                        room -= take
                        if lo + take == hi:
                            dq.popleft()
                        else:  # split: remainder keeps its deadline clock
                            entry[2] = lo + take
                    n = sum(s.n for s in spans)
                    self._sizes[lane] -= n
                    self._depth -= n
                    self._cond.notify_all()  # admission waiters
                    return lane, spans
                if lane is None and self._closed:
                    return None
                # sleep until the nearest wake-up: lane deadline, outer
                # timeout, or a notify
                targets = [t for t in (deadline, outer) if t is not None]
                if outer is not None and now >= outer:
                    return None
                self._cond.wait(
                    None if not targets else max(min(targets) - now, 0.0)
                )

    def close(self) -> None:
        """Stop admission; wake everyone.  Queued lots still drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
