"""One `torch.profiler` pass over a short steady stretch of the loop, reduced
to what the per-layer readers and the breakdown need: device time and
launches by operation, the device's busy time (the union of its
operations' intervals) over the traced window, and the idle gaps, each
named by the benchmark span that was open on the host when it began.

Only the device is traced (CUPTI): tracing the host's operators as well
costs some microseconds an operator, which would make the loop of a
cell with a short call wait on the host and read an idle device that the
untraced loop does not have.  The host's side comes from the loop's own
spans, placed on the trace's clock (the wall clock, as the profiler
keeps it) through one reading of both clocks; a launch's latency, some
microseconds, is the error of that placing.  The traced window runs from
the first device operation's start to the end of the last one (or of
the last span): the loop starts it with nothing in flight, and the
milliseconds before its first kernel are the profiler's own start.

A layer inside `run` is read from the same trace: while the stretch is
traced, the program's call into the layer (a per-layer metric's `wrap`)
is shadowed by a wrapper that keeps a host span of its own, and each
device operation counts for the layer whose span was open when the host
launched it (the launch's CUDA runtime call, matched to the operation by
its CUPTI correlation id).  A layer that `run` no longer calls, or that
launches nothing, reads nothing.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

import torch

NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length
PROFILE_SECONDS = 0.3  # the traced stretch, about; at least 3 calls


@dataclasses.dataclass
class Profile:
    """A traced stretch of `calls` calls."""

    calls: int
    window_s: float
    busy_s: float
    op_s: dict  # device seconds by operation name
    op_launches: dict  # launches by operation name
    gaps: list  # [(span name, seconds)] every idle gap, longest first
    layer_s: dict = dataclasses.field(default_factory=dict)  # by layer span
    layer_launches: dict = dataclasses.field(default_factory=dict)
    ops_matched: int = 0  # device operations whose launch is on record

    def layer(self, span: str) -> tuple[float, int]:
        """Device seconds and launches of the operations launched inside
        the layer span `span`."""
        return self.layer_s.get(span, 0.0), self.layer_launches.get(span, 0)

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        `fragment`."""
        names = [n for n in self.op_s if fragment in n]
        return (sum(self.op_s[n] for n in names),
                sum(self.op_launches[n] for n in names))

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten
        longest idle gaps."""
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


def _open_span(host: list, starts: list, t: float) -> str:
    """The span open at time t: the spans follow one another on one
    thread, so it is the last one begun by then, if it has not ended
    (`host` sorted by start, `starts` their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and host[i][2] >= t:
        return f"bench.{host[i][0]}"
    return "bench.none"


def _by_layer(device_ops: list, launches: dict, layers: list):
    """Device seconds and launches by the layer span open at each
    operation's launch, and how many operations had a launch on record.
    Layer spans do not nest one another."""
    layers = sorted(layers, key=lambda h: h[1])
    starts = [h[1] for h in layers]
    secs, n = collections.defaultdict(float), collections.Counter()
    matched = 0
    for _, s, e, corr in device_ops:
        t = launches.get(corr)
        if t is None:
            continue
        matched += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and layers[i][2] >= t:
            secs[layers[i][0]] += e - s
            n[layers[i][0]] += 1
    return dict(secs), dict(n), matched


def reduce(device_ops: list, host: list, calls: int,
           launches: dict | None = None, layers: tuple = ()) -> Profile:
    """A `Profile` from device operations [(name, start s, end s,
    correlation id)], host spans [(name, start s, end s)], the host's
    launches {correlation id: s} and layer spans [(name, start s, end
    s)], all on one clock."""
    if not device_ops or not host:
        raise RuntimeError("the profiler recorded no device operations")
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    t0 = min(d[1] for d in device_ops)
    t1 = max(max(d[2] for d in device_ops), max(h[2] for h in host))
    op_s, op_n = collections.defaultdict(float), collections.Counter()
    for name, s, e, _ in device_ops:
        op_s[name] += e - s
        op_n[name] += 1
    busy, gaps, cursor = 0.0, [], t0
    for _, s, e, _ in sorted(device_ops, key=lambda d: d[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((_open_span(host, starts, cursor), s - cursor))
        busy += e - max(s, cursor)
        cursor = e
    if t1 > cursor:
        gaps.append((_open_span(host, starts, cursor), t1 - cursor))
    gaps.sort(key=lambda g: -g[1])
    layer_s, layer_n, matched = _by_layer(device_ops, launches or {}, layers)
    return Profile(calls=calls, window_s=t1 - t0, busy_s=busy,
                   op_s=dict(op_s), op_launches=dict(op_n), gaps=gaps,
                   layer_s=layer_s, layer_launches=layer_n,
                   ops_matched=matched)


@contextlib.contextmanager
def layer_spans(hooks, record: list):
    """Shadow each program call `(span, owner, attr)` of `hooks` by a
    wrapper that appends `(span, start, end)` on the host clock to
    `record`; the calls are restored on exit."""
    installed = []

    def wrapped(span, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                record.append((span, t0, time.perf_counter()))
        return call

    try:
        for span, owner, attr in hooks:
            fn, own = getattr(owner, attr), attr in vars(owner)
            # object's own setter: the program's frozen dataclasses too
            object.__setattr__(owner, attr, wrapped(span, fn))
            installed.append((owner, attr, fn, own))
        yield
    finally:
        for owner, attr, fn, own in reversed(installed):
            if own:
                object.__setattr__(owner, attr, fn)
            else:
                object.__delattr__(owner, attr)


def profile_stretch(loop, calls: int, hooks=()) -> Profile:
    """Trace `calls` calls of `loop` (a `loop.ClosedLoop`) on the card,
    with a layer span around each program call of `hooks`
    (`layer_spans`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    spans, layers = loop.spans, []
    spans.timeline = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                layer_spans(hooks, layers):
            offset = time.time() - time.perf_counter()
            loop.run(calls=calls)
            torch.cuda.synchronize()
        host = [(n, s + offset, e + offset) for n, s, e in spans.timeline]
        layers = [(n, s + offset, e + offset) for n, s, e in layers]
    finally:
        spans.timeline = None
    events = prof.profiler.kineto_results.events()
    device_ops = [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9,
                   e.correlation_id())
                  for e in events if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()]
    # the host's CUDA runtime calls, each with its CUPTI correlation id
    launches = {e.correlation_id(): e.start_ns() / 1e9 for e in events
                if e.device_type() == DeviceType.CPU and e.correlation_id()}
    return reduce(device_ops, host, calls, launches, layers)
