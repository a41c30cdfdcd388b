"""Layers inside `run` read from the program's own spans (`repro_torch.obs`).

One `torch.profiler` pass (device only, as `bench/trace.py`'s) over a short
stretch of the cell's loop, run after the harness's own traced stretch
with the program's spans on.  Each device operation counts for the
innermost program span open on the loop's thread when the host launched
it (the launch's CUDA runtime call, matched to the operation by its CUPTI
correlation id).  The loop calls `run` on one thread, and that is
assumed: the profiler numbers the launching threads itself, not by their
native ids, so a launch cannot be matched to another thread's spans, and
program spans of other threads are left out (the log counts them).  The
program's spans and the loop's own spans
are placed on the profiler's clock through `obs`'s one conversion.  Each
idle gap is named by the loop's span open when it began and the
innermost program span then open on the loop's thread, e.g.
`bench.pipeline.run/sampler`.

The per-layer readers named `program.*` share one pass a run
(`profile(ctx)`).  Where the program has no spans (a checkout before
`repro_torch.obs`), or off the card, there is nothing to read: `profile`
returns None and so does every reader.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import sys

# device operations of the hand-written kernels: each has to be launched
# inside a program `run` span
KERNELS = ("mlp_votes_kernel", "fused_conv_kernel", "binary_gemm_hd")


@dataclasses.dataclass
class Program:
    """A traced stretch of `calls` calls, by program span."""

    calls: int
    span_s: dict  # device seconds by innermost program span
    span_launches: dict  # device operations by innermost program span
    gaps: list  # [(bench span[/program span], seconds)], longest first
    matched: int  # device operations whose launch is on record
    kernels: int  # operations of the hand-written kernels (KERNELS)
    kernels_in_run: int  # of them, launched inside a program `run` span

    def device_ms(self, span: str):
        """Device ms a call of the operations launched with `span` the
        innermost program span, or None where none was."""
        if not self.span_launches.get(span):
            return None
        return 1e3 * self.span_s[span] / self.calls


class _Nest:
    """The loop thread's program spans [(name, start, end, id, parent)]
    sorted by start; on one thread they nest."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]
        self.by_id = {s[3]: s for s in self.spans}

    def innermost(self, t: float):
        """The innermost span open at t: the last one begun by then, or
        the nearest of its ancestors still open."""
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s[2] < t:
            s = self.by_id.get(s[4])
        return s

    def within(self, s, name: str) -> bool:
        """Whether span `s` is, or lies inside, a span called `name`."""
        while s is not None and s[0] != name:
            s = self.by_id.get(s[4])
        return s is not None


def reduce(device_ops: list, host: list, calls: int, launches: dict,
           spans: list, loop_thread: int) -> Program:
    """A `Program` from device operations [(name, start s, end s,
    correlation id)], the loop's spans [(name, start s, end s)], the
    launches {correlation id: s} and the program's spans [(name, start s,
    end s, id, parent id, native thread id)], all on one clock.  Every
    launch counts for the spans of `loop_thread`; the others are left
    out.  The gaps are walked as `trace.reduce` walks them."""
    from bench import trace

    main = _Nest([sp[:5] for sp in spans if sp[5] == loop_thread])
    secs, n = collections.defaultdict(float), collections.Counter()
    matched = kernels = in_run = 0
    for name, s, e, corr in device_ops:
        kernel = any(k in name for k in KERNELS)
        kernels += kernel
        launch = launches.get(corr)
        if launch is None:
            continue
        matched += 1
        inner = main.innermost(launch)
        if inner is not None:
            secs[inner[0]] += e - s
            n[inner[0]] += 1
        in_run += kernel and main.within(inner, "run")

    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    t0 = min(d[1] for d in device_ops)
    t1 = max(max(d[2] for d in device_ops), max(h[2] for h in host))

    def gap(t: float, length: float):
        name, inner = trace._open_span(host, starts, t), main.innermost(t)
        return (name if inner is None else f"{name}/{inner[0]}", length)

    gaps, cursor = [], t0
    for _, s, e, _ in sorted(device_ops, key=lambda d: d[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append(gap(cursor, s - cursor))
        cursor = e
    if t1 > cursor:
        gaps.append(gap(cursor, t1 - cursor))
    gaps.sort(key=lambda g: -g[1])
    return Program(calls=calls, span_s=dict(secs), span_launches=dict(n),
                   gaps=gaps, matched=matched, kernels=kernels,
                   kernels_in_run=in_run)


def _stretch(ctx, obs) -> Program:
    """Trace the cell's loop for about `trace.PROFILE_SECONDS` with the
    program's spans on."""
    import threading

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from bench import harness, loop, trace

    setup = ctx.setup
    per_call = ctx.window.seconds / max(ctx.window.in_window, 1)
    calls = max(3, math.ceil(trace.PROFILE_SECONDS / per_call))
    spans = loop.Spans(enabled=True)
    spans.timeline = []
    output = setup.kind.output(setup)
    the_loop = loop.ClosedLoop(
        harness.program_call(setup), setup.rows, setup.keys,
        setup.traffic["in_flight"], output, spans,
        loop.Reservoir(0, 0, output, setup.device))
    torch.cuda.synchronize()
    obs.take()
    try:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            offset = obs.profiler_offset_ns()
            obs.enable()
            try:
                the_loop.run(calls=calls)
                torch.cuda.synchronize()
            finally:
                obs.disable()
    finally:
        records, dropped = obs.take()
    at = obs.on_profiler_clock
    host = [(n, at(round(s * 1e9), offset), at(round(e * 1e9), offset))
            for n, s, e in spans.timeline]
    program = [(r.name, at(r.start_ns, offset), at(r.end_ns, offset), r.id,
                r.parent, r.thread) for r in records]
    events = prof.profiler.kineto_results.events()
    device_ops = [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9,
                   e.correlation_id())
                  for e in events if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()]
    runtime = [e for e in events
               if e.device_type() == DeviceType.CPU and e.correlation_id()]
    launches = {e.correlation_id(): e.start_ns() / 1e9 for e in runtime}
    me = threading.get_native_id()
    p = reduce(device_ops, host, calls, launches, program, me)
    seen = collections.Counter(e.start_thread_id() for e in runtime)
    elsewhere = sum(r.thread != me for r in records)
    ms_by_span = {k: round(1e3 * v / calls, 4) for k, v in p.span_s.items()}
    print(f"program trace: {calls} calls, {len(records)} program spans "
          f"({dropped} dropped, {elsewhere} off the loop's thread), "
          f"{len(device_ops)} device operations, {p.matched} matched to "
          f"their launch; launches by the profiler's thread numbers "
          f"{dict(seen)}; hand-written kernels launched "
          f"inside a run span: {p.kernels_in_run} of {p.kernels}; device ms "
          f"a call by span {ms_by_span}; longest idle gaps {p.gaps[:5]}",
          file=sys.stderr, flush=True)
    return p


_last: list = [None, None]  # [the Context traced, its Program]


def profile(ctx):
    """The run's `Program` (traced once, on the first reader's call), or
    None off the card or where the program has no spans."""
    if ctx.profile is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if _last[0] is not ctx:
        _last[:] = [ctx, _stretch(ctx, obs)]
    return _last[1]


def device_ms(ctx, span: str):
    """Device ms a call of the operations launched inside the program
    span `span`, or None."""
    p = profile(ctx)
    return None if p is None else p.device_ms(span)
