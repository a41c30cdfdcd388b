"""Per-device cost of a step, counted op by op while it runs (port of
`repro/launch/hlo_cost.py`).

The reference walks the optimized, post-SPMD HLO of a compiled step.
Eager PyTorch has no HLO: `CostCounter` is a `TorchDispatchMode` that
sees every ATen op of the step as it runs (on real tensors, or on fake
ones under `FakeTensorMode` for a dry-run) and keeps the reference's
`CostTotals`:

  * per-device counts everywhere: an op on DTensors is let through to
    DTensor (the mode returns NotImplemented for it), which runs it as
    ops on the local shards and the collectives of its redistributions;
    those come back through the mode and are what it counts.  The ops
    DTensor's sharding propagation runs on global-shaped fakes to learn
    an output's shape are not the step's and are not counted;
  * matrix products and convolutions by `torch.utils.flop_counter`'s
    formulas; every other compute op one FLOP per output element, as the
    walker counts them (`hlo_cost.py:369-372` of the reference);
  * kernels 1 and 2 (`repro_torch::binary_gemm_hd`, `::cam_vote`) under
    their own key, `binary_ops`: 2 * M * N * 32 * Kw bit-operations (an
    AND or XOR and an add per bit pair), and kernel 2's B * C * P
    threshold compares.  They are not bf16 FLOPs;
  * trips: an eager loop runs every trip, so each is counted, except a
    loop of equal chunks run through `models.scan.scan_chunks` (the
    Mamba scan, and attention's key chunks under autograd).  While a
    counter is entered it is the trip hook of `models.scan`: on fake
    tensors that loop runs the first chunk's body alone, and the counter
    charges its FLOPs, bytes, op count and the storage it leaves alive
    n_chunks times (`trip_region`), as the walker multiplies a while
    body by its trip count (`hlo_cost.py:309-316` of the reference); the
    carry's set-up and its last value are charged once, outside the
    trips.  The steps inside a Mamba chunk follow the same rule.  On
    real tensors every chunk and step runs and is counted, and the two
    agree because the chunks are padded to the same work;
  * each `_c10d_functional` collective charged wire bytes by the walker's
    formulas, with n the size of the op's own group:
        all-gather       (n-1)/n * result
        reduce-scatter   (n-1)/n * operand
        all-reduce       2 (n-1)/n * operand   (RS + AG)
        all-to-all       (n-1)/n * operand
        broadcast        operand
    and split by link: a group within one node (ranks r // RANKS_PER_NODE
    alike) on NVLink, a group across nodes on the network;
  * HBM bytes: each op's operands plus results, as the walker charges a
    fusion boundary, with these rules.  Views and metadata ops charge
    nothing (the walker's `_SKIP_BYTES_OPS`), nor do scalars (its
    constants); a broadcast operand charges its bytes once.  `copy_` charges its source
    and the destination as viewed, so a write into a slice of the KV
    cache charges the slice only; a scatter-like in-place op (index_put_,
    index_copy_, ...) charges twice its operands besides the buffer (the
    walker's dynamic-update-slice rule).  A tensor made inside the step
    whose bytes are at most RESIDENT_BYTES is taken to stay in the L2
    between the op that writes it and those that read it, and charges
    nothing (the walker's `VMEM_RESIDENT_BYTES`); the step's arguments
    (parameters, optimizer state, cache, inputs) charge on every read.

The mode also keeps the live bytes of the storage made inside the step
and their peak (`temp` of the dry-run's memory analysis).  Every count
is per device: the fake group's rank 0 stands for every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models import scan

# The NVIDIA H100 SXM5's L2 is 50 MiB (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper).  A tensor of at most half of it leaves room
# for the other operand or the result of the op that reads it, so it is
# taken to stay on chip between two ops; a larger one goes to HBM.
L2_BYTES = 50 * 2**20
RESIDENT_BYTES = L2_BYTES // 2
RANKS_PER_NODE = 8  # an HGX H100 node: 8 cards on one NVLink switch fabric

# `_c10d_functional` op names -> the reference's collective kinds
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}
_FUNCOL_NS = ("_c10d_functional", "_c10d_functional_autograd")

# allocation without a write, and metadata: no bytes, no FLOPs
_NO_COST = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "set_", "resize_", "wait_tensor",
    "record_stream", "_unsafe_view",
}
# in place into part of a buffer: twice the operands besides the buffer
_SCATTER_INPLACE = {
    "index_put_", "_index_put_impl_", "index_copy_", "index_add_",
    "scatter_", "scatter_add_", "scatter_reduce_", "masked_scatter_",
}
_BINARY = ("binary_gemm_hd", "cam_vote")


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor as viewed (not of its whole storage), a
    broadcast dim (stride 0) once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _group(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name)


def _link(ranks) -> str:
    nodes = {r // RANKS_PER_NODE for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "network"


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_operand_bytes: float = 0.0
    by_collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    collective_count: int = 0
    # HBM attribution: "op@result shape" -> bytes
    hbm_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    # the port's own: kernels 1 and 2, and the wire bytes by link
    binary_ops: float = 0.0
    wire_by_link: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    n_ops: int = 0

    def top_hbm(self, n: int = 12) -> list:
        return sorted(self.hbm_by_op.items(), key=lambda kv: -kv[1])[:n]


class _Propagating(threading.local):
    depth = 0


_PROP = _Propagating()


def _not_counted(fn):
    """`fn` with the thread marked as inside DTensor's sharding
    propagation while it runs."""
    def wrapped(*args, **kwargs):
        _PROP.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PROP.depth -= 1

    return wrapped


@contextlib.contextmanager
def _propagation_marked():
    """DTensor's propagation entry points wrapped by `_not_counted` while
    the block runs (the C++ dispatcher's slow path in recent releases,
    the Python `propagate` in older ones)."""
    from torch.distributed.tensor import _dispatch, _sharding_prop

    sites = [(_dispatch.OpDispatcher, "_propagate_op_sharding_dispatch_slow_path"),
             (_sharding_prop.ShardingPropagator, "propagate"),
             (_sharding_prop.ShardingPropagator,
              "propagate_op_sharding_non_cached"),
             (_sharding_prop.ShardingPropagator,
              "_propagate_tensor_meta_non_cached")]
    saved = [(cls, name, cls.__dict__[name]) for cls, name in sites
             if name in cls.__dict__]
    if not saved:
        raise RuntimeError("this torch's DTensor has none of the sharding "
                           "propagation entry points the counter marks")
    for cls, name, fn in saved:
        setattr(cls, name, _not_counted(fn))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


class CostCounter(TorchDispatchMode):
    """Counts the step run inside it (see the module's docstring) into
    `totals`.  `live_bytes` / `peak_bytes`: storage made inside the step,
    now and at its peak.  `record=True` keeps one entry per counted op in
    `ops` (the dry-run's `--save-hlo` list)."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.totals = CostTotals()
        self.record = record
        self.ops: list = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._new: dict = {}  # id(storage) -> bytes, storage made inside
        self._marks = None
        self.trips = 1  # the charge of each op (`trip_region`)

    # ---------------------------------------------------------- lifetime
    def __enter__(self):
        self._marks = _propagation_marked()
        self._marks.__enter__()
        self._hook = scan.set_trip_hook(self._one_trip)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            scan.set_trip_hook(self._hook)
            self._marks.__exit__(*exc)

    def _one_trip(self, t: torch.Tensor):
        """The trip hook: self on a fake tensor (a dry-run's trace, where
        one trip of a loop of equal trips is charged for all), else None."""
        from torch._subclasses.fake_tensor import is_fake

        return self if is_fake(t) else None

    @contextlib.contextmanager
    def trip_region(self, n: int):
        """Inside, each op is charged n times (one trip run for n); the
        storage made inside and still alive at the end is charged n times
        from then on, until it is freed."""
        before = set(self._new)
        self.trips *= n
        try:
            yield
        finally:
            self.trips //= n
            for key in set(self._new) - before:
                extra = self._new[key] * (n - 1)
                self._new[key] += extra
                self.live_bytes += extra
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def made_here(self, t: torch.Tensor) -> bool:
        """Whether t's storage was made inside the step."""
        return id(t.untyped_storage()) in self._new

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._new:
            return
        n = st.nbytes()
        self._new[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        n = self._new.pop(key, None)
        if n is not None:
            self.live_bytes -= n

    # ------------------------------------------------------------ counts
    def _charge(self, t: torch.Tensor) -> int:
        """HBM bytes of reading or writing t: none for a scalar (a
        constant of the op, as the walker's `constant`), none for a
        resident tensor made in the step, else its bytes as viewed."""
        if t.dim() == 0:
            return 0
        n = _nbytes(t)
        return 0 if n <= RESIDENT_BYTES and self.made_here(t) else n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs it as local ops and collectives, which come
            # back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        if _PROP.depth:
            return out
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        # a result in a storage of its own is new; a view or an in-place
        # result shares an operand's
        held = {id(a.untyped_storage()) for a in ins}
        for o in outs:
            if id(o.untyped_storage()) not in held:
                self._track(o)
        self._count(func, ins, outs, args, kwargs)
        return out

    def _count(self, func, ins, outs, args, kwargs) -> None:
        ns = func.namespace
        name = func._opname
        if ns == "prim" or name in _NO_COST or func.is_view:
            return
        t = self.totals
        t.n_ops += self.trips
        flops = binary = 0.0
        key = f"{ns}.{name}@{list(outs[0].shape) if outs else []}"
        if ns in _FUNCOL_NS and name in COLLECTIVES:
            self._collective(COLLECTIVES[name], name, ins, outs, args, key)
            return
        if ns == "repro_torch" and name in _BINARY:
            binary = _binary_ops(name, ins)
        elif func._overloadpacket in _flop_registry():
            flops = float(_flop_registry()[func._overloadpacket](
                *args, **kwargs, out_val=outs[0] if len(outs) == 1 else outs))
        else:
            flops = float(sum(o.numel() for o in outs))
        if name == "copy_":
            hb = self._charge(ins[1]) + self._charge(outs[0])
        elif name in _SCATTER_INPLACE:
            hb = 2 * sum(self._charge(a) for a in ins[1:])
        else:  # an in-place op reads its operand and writes it back
            hb = sum(self._charge(a) for a in ins) + sum(
                self._charge(o) for o in outs)
        n = self.trips
        flops, binary, hb = flops * n, binary * n, hb * n
        t.flops += flops
        t.binary_ops += binary
        t.hbm_bytes += hb
        if hb:
            t.hbm_by_op[key] += hb
        if self.record:
            self.ops.append({"op": f"{ns}.{name}",
                             "in": [list(a.shape) for a in ins],
                             "out": [list(o.shape) for o in outs],
                             "flops": flops, "binary_ops": binary,
                             "hbm_bytes": hb, "trips": n})

    def _collective(self, kind, name, ins, outs, args, key) -> None:
        import torch.distributed as dist

        group_name = next(a for a in reversed(args) if isinstance(a, str))
        pg = _group(group_name)
        n = pg.size()
        opnd = float(sum(_nbytes(a) for a in ins))
        res = float(sum(_nbytes(o) for o in outs))
        frac = (n - 1) / n if n > 1 else 0.0
        if kind == "all-gather":
            wire = res * frac
        elif kind in ("reduce-scatter", "all-to-all"):
            wire = opnd * frac
        elif kind == "all-reduce":
            wire = 2.0 * opnd * frac
        else:
            wire = opnd if n > 1 else 0.0
        trips = self.trips
        wire, opnd, res = wire * trips, opnd * trips, res * trips
        t = self.totals
        t.collective_wire_bytes += wire
        t.collective_operand_bytes += opnd
        t.by_collective[kind] += wire
        t.wire_by_link[_link(dist.get_process_group_ranks(pg))] += wire
        t.collective_count += trips
        t.hbm_bytes += opnd + res
        t.hbm_by_op[key] += opnd + res
        if self.record:
            self.ops.append({"op": f"collective.{name}", "group_size": n,
                             "in": [list(a.shape) for a in ins],
                             "out": [list(o.shape) for o in outs],
                             "wire_bytes": wire, "hbm_bytes": opnd + res,
                             "trips": trips})


def _binary_ops(name: str, ins) -> float:
    """Kernels 1 and 2: 2 bit-operations per bit pair; kernel 2 adds its
    B * C * P threshold compares (thresholds [P] is its third operand)."""
    x, w = ins[0], ins[1]
    pairs = x.shape[0] * w.shape[0] * 32 * x.shape[1]
    if name == "cam_vote":
        return 2.0 * pairs + x.shape[0] * w.shape[0] * ins[2].shape[0]
    return 2.0 * pairs


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def cost_analysis_dict(flop_counter) -> dict:
    """`FlopCounterMode`'s figure in the reference's `cost_analysis()`
    shape: {"flops": total}.  It sees an op on DTensors at the DTensor's
    global shapes (and a plain op at its own), so over a mesh it counts
    the global op, not one device's share: the role XLA's built-in
    numbers play in the reference, with their own caveat."""
    return {"flops": float(flop_counter.get_total_flops())}


def analyze(fn, *args, record: bool = False, **kwargs):
    """(fn's result, its `CostTotals`, the counter) for one call."""
    with CostCounter(record=record) as counter:
        out = fn(*args, **kwargs)
    counter.totals.by_collective = dict(counter.totals.by_collective)
    counter.totals.hbm_by_op = dict(counter.totals.hbm_by_op)
    counter.totals.wire_by_link = dict(counter.totals.wire_by_link)
    return out, counter.totals, counter

