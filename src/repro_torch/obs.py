"""Spans inside the port: where `run`'s time goes, and set-up's.

    from repro_torch import obs
    obs.enable()
    pipe = compile_pipeline(folded, noise=SILICON)   # physics.fit
    pipe.run(x, spec, keys=keys)                     # run, run.pack, ...
    records, dropped = obs.take()
    obs.disable()

`span(name)` is a context manager.  Off (the default) it is one check of
a module-level flag returning a shared no-op context: no allocation, no
clock read.  Counts are added inside the block with `count(**counts)`;
guard a call of it with `enabled()` where building the counts costs
anything while off.  On, each span appends a `Record` to an in-memory
buffer when it closes: its id, its parent's id (the span open
on the same thread when it began, None at the top), its call's id (the
outermost span open on the thread, so every span inside one `run` shares
the id of that `run`), its name, the thread's native id, its start and
end (`time.perf_counter_ns()`) and its counts.

The buffer holds `CAPACITY` records; when it is full the oldest are
dropped and counted.  `take()` returns the records, oldest first, and the
number dropped since the last `take()`, and empties the buffer.

The spans the port opens (PERF.md section 3 names the metric each feeds):

    run             one per public `CompiledPipeline.run` / `run_packed`
                    call; counts rows, bucket
    run.pack        the input packing of `run`; counts kernel (the
                    launches of `kernels/pack_input.py`'s kernel in it:
                    1 on the card, 0 on the CPU, for a bit-plane code or
                    a head-only MLP)
    run.bucket      bucket padding and the key checks
    run.program     the spec's program on the padded batch
    sampler         `SearchPhysics.sample` / `.sample_keyed`
    head_distances  the HD-once routes' head distances (kernel 4's stage
                    entry for a CNN, then `head_hd`)
    physics.fit     `SearchPhysics.for_head` (the Table-I fit)
    kernels.load    a CUDA library's first load, its build included;
                    counts built (libraries nvcc compiled)
    lm.prefill      one per `models.model.prefill` call
    lm.attention    an attention sublayer (`layers.attention`)
    lm.short_conv   a gated short-conv sublayer (`ssm.short_conv`)
    moe.route       the dropless MoE's router, biased top-k, sort by
                    expert and offsets; counts tokens, max_load,
                    min_load, experts_hit (reading them waits for the
                    card, so only while recording)
    moe.experts     its experts: the tokens' signs, the grouped kernel-1
                    launches (gate and up, then down), SwiGLU and the
                    down operands; counts launches (grouped launches,
                    2 a layer on the card, 0 on the CPU)
    moe.combine     the gate-weighted sum back in token order

`profiler_offset_ns()` is the one conversion from these stamps to the
clock of `torch.profiler`'s events (`on_profiler_clock`).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

CAPACITY = 1 << 16  # records the buffer holds before it drops the oldest

_on = False
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    """One closed span."""

    id: int
    parent: Optional[int]
    call: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    counts: dict


class _Noop:
    """The context `span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("id", "parent", "call", "name", "counts", "start", "stack",
                 "thread")

    def __init__(self, name: str):
        self.name, self.counts = name, {}

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:  # the thread's first span; its id is a syscall
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.call = stack[0].id if stack else self.id
        self.stack, self.thread = stack, _local.thread
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        _append(Record(self.id, self.parent, self.call, self.name,
                       self.thread, self.start, end, self.counts))
        return False


def _append(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == CAPACITY:
            _dropped += 1
        _buffer.append(rec)


def span(name: str):
    """A span named `name` around a `with` block; the shared no-op while
    recording is off."""
    if not _on:
        return NOOP
    return _Span(name)


def count(**counts) -> None:
    """Add `counts` (ints) to the innermost span open on this thread;
    nothing while recording is off."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].counts.update(counts)


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _on


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans open now still record when they close."""
    global _on
    _on = False


def take() -> tuple[list, int]:
    """(the buffer's records, oldest first; how many were dropped since
    the last take), emptying the buffer."""
    global _dropped
    with _lock:
        records, dropped = list(_buffer), _dropped
        _buffer.clear()
        _dropped = 0
    return records, dropped


def profiler_offset_ns() -> int:
    """What to add to a `perf_counter_ns` stamp, read now, to place it on
    the clock of `torch.profiler`'s events (the wall clock, ns since the
    epoch)."""
    return time.time_ns() - time.perf_counter_ns()


def on_profiler_clock(t_ns: int, offset_ns: int) -> float:
    """A `perf_counter_ns` stamp on the profiler's clock, in seconds."""
    return (t_ns + offset_ns) * 1e-9
