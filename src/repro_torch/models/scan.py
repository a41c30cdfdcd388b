"""Loops of equal chunks, rematerialised (the reference's `lax.scan` of a
`jax.checkpoint` body): the Mamba scan's time chunks and attention's key
chunks under autograd.

A cost counter (`launch.hlo_cost.CostCounter`) sets the trip hook while
it is entered.  On the tensors where the hook answers with a counter (a
dry-run's fakes) a loop runs one trip inside `trips(counter, n)`, which
charges it n times, and returns results of the whole loop's shapes; on
every other tensor each trip runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

# t -> the counter that charges one trip of a loop over t for all of
# them, or None (run every trip); set by a cost counter while entered
_trip_hook: Optional[Callable] = None


def set_trip_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install hook (None: none) and return the one it replaces."""
    global _trip_hook
    prev, _trip_hook = _trip_hook, hook
    return prev


def trip_counter(t: torch.Tensor):
    """The counter under which a loop of equal trips over t may run one
    trip inside `trips(counter, n)`, or None: every trip runs."""
    return None if _trip_hook is None else _trip_hook(t)


def trips(counter, n: int):
    """`counter.trip_region(n)`, or nothing without a counter."""
    return (contextlib.nullcontext() if counter is None
            else counter.trip_region(n))


def scan_chunks(body, carry: tuple, xs: tuple, consts: tuple, chunk: int):
    """The loop `carry, y_i = body(carry, x_i, consts)` over the chunks
    x_i = x[:, i*chunk:(i+1)*chunk] of each x in xs ([B, n*chunk, ...]),
    rematerialised, as the reference's `lax.scan` of a `jax.checkpoint`
    body: under autograd the forward keeps only the carry at each chunk
    boundary, and the backward recomputes one chunk at a time from its
    boundary carry, with every chunk's cotangents (carry, x_i and the
    floating consts) computed, so every chunk does the same work.  body
    returns (carry tuple, y_i [B, chunk, ...] or None); the result is
    (the last carry, the y_i joined along dim 1, or None).

    Where `trip_counter` gives a counter, the first chunk's body alone
    runs, forward and backward, charged n times, and the results have
    the whole loop's shapes.
    """
    n = xs[0].shape[1] // chunk
    out = _ChunkScan.apply(body, len(carry), len(xs), chunk, n,
                           trip_counter(xs[0]), *carry, *xs, *consts)
    return tuple(out[:len(carry)]), (out[len(carry)]
                                     if len(out) > len(carry) else None)


class _ChunkScan(torch.autograd.Function):
    """`scan_chunks`' loop: the forward without autograd, the backward a
    reverse loop of recomputed chunks (`counter` set: one trip charged
    `n` times)."""

    @staticmethod
    def forward(ctx, body, n_carry, n_xs, chunk, n, counter, *ts):
        carry = ts[:n_carry]
        xs = ts[n_carry:n_carry + n_xs]
        consts = ts[n_carry + n_xs:]
        runs = 1 if counter is not None else n
        keep = any(ctx.needs_input_grad)
        bounds, ys = [], []
        with trips(counter, n):
            for i in range(runs):
                if keep:
                    bounds.append(carry)
                carry, y = body(carry, [x[:, i * chunk:(i + 1) * chunk]
                                        for x in xs], consts)
                ys.append(y)
        ctx.body, ctx.chunk, ctx.n, ctx.counter = body, chunk, n, counter
        ctx.n_carry, ctx.n_xs, ctx.runs = n_carry, n_xs, runs
        ctx.save_for_backward(*(t for c in bounds for t in c), *xs, *consts)
        if ys[0] is None:
            return tuple(carry)
        return (*carry, torch.cat(ys * (n // runs), 1))

    @staticmethod
    def backward(ctx, *grads):
        nc, nx, chunk = ctx.n_carry, ctx.n_xs, ctx.chunk
        saved = ctx.saved_tensors
        bounds = [saved[i * nc:(i + 1) * nc] for i in range(ctx.runs)]
        xs = saved[ctx.runs * nc:ctx.runs * nc + nx]
        consts = saved[ctx.runs * nc + nx:]
        g_carry, g_ys = list(grads[:nc]), grads[nc:]  # zeros where unused
        g_consts = [torch.zeros_like(c) if c.is_floating_point() else None
                    for c in consts]
        g_xs = [[] for _ in xs]

        def leaf(t):
            t = t.detach()
            return t.requires_grad_() if t.is_floating_point() else t

        with trips(ctx.counter, ctx.n):
            for i in reversed(range(ctx.runs)):
                sl = slice(i * chunk, (i + 1) * chunk)
                with torch.enable_grad():
                    c_in = [leaf(c) for c in bounds[i]]
                    x_in = [leaf(x[:, sl]) for x in xs]
                    k_in = [leaf(k) for k in consts]
                    c_out, y = ctx.body(tuple(c_in), x_in, tuple(k_in))
                    ins = [t for t in (*c_in, *x_in, *k_in)
                           if t.requires_grad]
                    gs = iter(torch.autograd.grad(
                        (*c_out, *([] if y is None else [y])), ins,
                        (*g_carry, *(g[:, sl] for g in g_ys))))
                    gs = [next(gs) if t.requires_grad else None
                          for t in (*c_in, *x_in, *k_in)]
                g_carry = gs[:nc]
                for lst, g in zip(g_xs, gs[nc:nc + nx]):
                    lst.append(g)
                g_consts = [a if g is None else a + g
                            for a, g in zip(g_consts, gs[nc + nx:])]
        reps = ctx.n // ctx.runs
        g_xs = [None if lst[0] is None else torch.cat(lst[::-1] * reps, 1)
                for lst in g_xs]
        return (None,) * 6 + (*g_carry, *g_xs, *g_consts)
