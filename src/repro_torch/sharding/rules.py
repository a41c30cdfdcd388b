"""Logical-axis -> physical-mesh-axis rules (port of
`repro/sharding/rules.py`).

Models never name physical mesh axes; they annotate tensors with logical
axes ("batch", "embed", "heads", "mlp", "expert", "vocab", "kv_seq", ...).
A rule set maps logical names to physical mesh axes (or None = replicate).
This keeps one model definition valid across every parallelism layout:
swap the rules, not the model.

Physical mesh axes (launch/mesh.py), the names of a
`torch.distributed.device_mesh.DeviceMesh`'s dims:
  pod    -- slowest axis across hosts; data-parallel only
  data   -- the axis used for DP + FSDP (+ sequence sharding in
            long-context serving)
  model  -- the tensor-parallel axis (heads / mlp / vocab / experts)

A spec is a `PartitionSpec`: a tuple with one entry per tensor dim,
each None, a mesh axis name or a tuple of them.  `placements` turns a
spec into DTensor placements over a mesh, and `shard` is the reference's
sharding constraint: on a DTensor inside a `use_rules(rules, mesh)`
context it redistributes to the (sanitised) spec; anywhere else it is
the identity.

Baseline rule sets:
  TRAIN_RULES        -- DP+FSDP over ('pod','data'), Megatron TP over 'model'
  SERVE_RULES        -- batch over ('pod','data'), TP over 'model'
  LONG_CONTEXT_RULES -- batch=1: KV sequence sharded over 'data' (sequence
                        parallelism for the half-meg context), TP otherwise
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Optional, Union

import torch

Axis = Union[str, None, tuple]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names (one dim split over several axes, major first).  A plain tuple,
    so it compares equal to `tuple()` of the reference's spec; entries
    are canonical as there (a 1-tuple is its name, an empty one None)."""

    def __new__(cls, *entries: Axis):
        def canon(e):
            if isinstance(e, tuple):
                return e[0] if len(e) == 1 else (e or None)
            return e

        return super().__new__(cls, (canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, a `ServeMesh`, or anything with
    `axis_names` and a `devices` array (the reference's Mesh shape)."""
    if isinstance(mesh, ServeMesh):
        return mesh.sizes
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to physical mesh axes."""

    name: str
    rules: dict[str, Axis]

    def resolve(self, mesh) -> "AxisRules":
        """Drop physical axes that don't exist in `mesh` (e.g. 'pod' on a
        single-pod mesh) so one rule set serves both mesh shapes."""
        sizes = _mesh_sizes(mesh)

        def filt(ax: Axis) -> Axis:
            if ax is None:
                return None
            if isinstance(ax, tuple):
                keep = tuple(a for a in ax if a in sizes)
                return keep if keep else None
            return ax if ax in sizes else None

        return AxisRules(
            name=f"{self.name}@{'x'.join(map(str, sizes.values()))}",
            rules={k: filt(v) for k, v in self.rules.items()},
        )

    def physical(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        phys = []
        used: set[str] = set()
        for ax in logical_axes:
            p = self.physical(ax)
            # one physical axis may appear at most once per spec; later
            # logical axes that map to an already-used physical axis
            # degrade to replication
            if p is None:
                phys.append(None)
            elif isinstance(p, tuple):
                keep = tuple(a for a in p if a not in used)
                used.update(keep)
                phys.append(keep if keep else None)
            else:
                if p in used:
                    phys.append(None)
                else:
                    used.add(p)
                    phys.append(p)
        return P(*phys)


# ---------------------------------------------------------------------------
# Baseline rule sets
# ---------------------------------------------------------------------------
TRAIN_RULES = AxisRules(
    name="train",
    rules={
        # activations
        "batch": ("pod", "data"),
        "seq": None,
        "act_seq": None,  # residual-carry sequence dim (SP variant)
        "kv_seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        # second sharding dim of the [E, C, D] dispatch buffers: when the
        # expert count doesn't divide the model axis the expert dim
        # degrades to replication and the capacity dim carries the
        # sharding instead
        "capacity": "data",
        # parameters: TP on one dim, FSDP ('data') on another
        "p_embed_v": "model",  # embedding table rows (vocab)
        "p_embed_d": "data",  # embedding table cols (FSDP)
        "p_attn_d": "data",  # attention proj d_model dim (FSDP)
        "p_attn_heads": "model",  # attention heads dim (TP)
        "p_mlp_d": "data",  # mlp d_model dim (FSDP)
        "p_mlp_f": "model",  # mlp hidden dim (TP)
        "p_expert": None,  # expert dim of MoE weight stacks
        "p_vocab": "model",  # lm head vocab dim (TP)
        "p_ssm_inner": "model",  # mamba d_inner dim (TP)
        "p_ssm_d": "data",  # mamba d_model dim (FSDP)
    },
)

SERVE_RULES = AxisRules(
    name="serve",
    rules={
        "batch": ("pod", "data"),
        "seq": None,
        "kv_seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "capacity": "data",  # see TRAIN_RULES note
        # 2D weight sharding: TP on 'model' plus a second shard over
        # 'data' (weight-gathered serving)
        "p_embed_v": "model",
        "p_embed_d": "data",
        "p_attn_d": "data",
        "p_attn_heads": "model",
        "p_mlp_d": "data",
        "p_mlp_f": "model",
        "p_expert": "data",  # expert-parallel over the batch axis
        "p_vocab": "model",
        "p_ssm_inner": "model",
        "p_ssm_d": "data",
    },
)

LONG_CONTEXT_RULES = AxisRules(
    name="long_context",
    rules={
        **SERVE_RULES.rules,
        # batch == 1: spend the 'data' axis on the KV sequence instead
        "batch": "pod",
        "kv_seq": "data",
    },
)

# Megatron-style sequence parallelism: the residual carries between blocks
# sharded over 'model' along the sequence.
TRAIN_SP_RULES = AxisRules(
    name="train_sp",
    rules={**TRAIN_RULES.rules, "act_seq": "model"},
)

# ZeRO-1: optimizer state sharded over 'data' (as in TRAIN_RULES) but the
# working parameters replicated across 'data'.
ZERO1_PARAM_RULES = AxisRules(
    name="zero1_params",
    rules={
        **TRAIN_RULES.rules,
        "p_embed_d": None,
        "p_attn_d": None,
        "p_mlp_d": None,
        "p_ssm_d": None,
    },
)

# Sequence-sharded decode cache: for archs whose kv-head count doesn't
# divide the TP axis, shard the cache sequence over 'model' instead.
SERVE_SEQCACHE_RULES = AxisRules(
    name="serve_seqcache",
    rules={**SERVE_RULES.rules, "kv_seq": "model"},
)

# PiC-BNN classification serving (serve/picbnn.py, fanout="spmd"): pure
# data parallelism over one local 'data' axis -- the micro-batch splits
# across devices, everything else (packed weights, folded constants,
# thresholds) replicates.  The round-robin fan-out needs no rules at all:
# each batch runs whole on one device.
PICBNN_SERVE_RULES = AxisRules(
    name="picbnn_serve",
    rules={"batch": "data", "features": None, "classes": None},
)


# ---------------------------------------------------------------------------
# Local serving placements (the classifier server's devices)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A 1-axis ('data') mesh over a list of local devices: the server is
    one process driving each device itself, so no process group is
    involved.  `axis_names` / `devices` have the reference Mesh's shape."""

    devices: tuple
    axis_names: tuple = ("data",)

    @property
    def sizes(self) -> dict:
        return {"data": len(self.devices)}


@dataclasses.dataclass(frozen=True)
class LocalSharding:
    """A placement over a `ServeMesh`: `spec` None everywhere = every
    device holds the whole tensor; "data" on dim d = dim d split into
    equal contiguous slices, slice i on device i."""

    mesh: ServeMesh
    spec: PartitionSpec

    def split(self, x: torch.Tensor) -> list:
        """The per-device pieces of x (views), one per device, in order."""
        n = len(self.mesh.devices)
        for d, ax in enumerate(self.spec):
            if ax is not None:
                if x.shape[d] % n:
                    raise ValueError(f"dim {d} of size {x.shape[d]} does not"
                                     f" split evenly over {n} devices")
                return list(torch.chunk(x, n, dim=d))
        return [x] * n


def serve_mesh(devices) -> ServeMesh:
    """A 1-axis ('data') mesh over the serving devices (local fan-out)."""
    return ServeMesh(tuple(torch.device(d) for d in devices))


def replicated_sharding(mesh: ServeMesh) -> LocalSharding:
    """Fully-replicated placement (every device holds the full tensor) --
    the serve-time contract for the folded weights."""
    return LocalSharding(mesh, P())


def batch_sharding(mesh: ServeMesh,
                   rules: AxisRules = PICBNN_SERVE_RULES) -> LocalSharding:
    """Leading-axis data-parallel placement for a served micro-batch
    (trailing dims replicated), derived through the logical rules."""
    return LocalSharding(mesh, rules.spec("batch"))


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------
def sanitize_spec(spec, shape, mesh) -> PartitionSpec:
    """Drop partitioned dims that don't divide evenly (they degrade to
    replication, e.g. KV heads when tp > n_kv_heads)."""
    sizes = _mesh_sizes(mesh)
    spec = tuple(spec)
    out = []
    for dim, ax in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        factor = 1
        for a in axes:
            factor *= sizes.get(a, 1)
        out.append(ax if factor and dim % factor == 0 else None)
    return P(*out)


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` over a DeviceMesh: for each mesh dim,
    `Shard(d)` where that axis names tensor dim d, else `Replicate()`.
    A dim split over several axes keeps them in mesh order (major
    first), the order GSPMD tiles in; a spec naming them otherwise
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(tuple(spec)):
        if ax is None:
            continue
        axes = [a for a in (ax if isinstance(ax, tuple) else (ax,))
                if a in names]
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} lists mesh axes against the"
                             f" mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def layout(spec, shape, mesh) -> tuple:
    """The placements a tensor of `shape` takes for `spec`: sanitised,
    and replicated along mesh dims of size 1 (one shard is the whole
    tensor, and DTensor's view rules treat any Shard as split)."""
    from torch.distributed.tensor import Replicate

    pl = placements(sanitize_spec(spec, shape, mesh), mesh)
    return tuple(Replicate() if n == 1 else q
                 for q, n in zip(pl, mesh.shape))


def place(x: torch.Tensor, mesh, placements):
    """`x` (the same full tensor on every rank) as a DTensor with
    `placements`: this rank's shard cut from it by its mesh coordinate,
    with no collective and no device query, so the same code places
    fake tensors on a fake group (`launch/specs.py`).  A shard is a copy
    of its slice (it must not keep the whole tensor alive); a tensor
    replicated everywhere is its own local tensor.  Each split must be
    even, as `sanitize_spec` leaves it."""
    from torch.distributed.tensor import DTensor

    local, coord = x, mesh.get_coordinate()
    for i, q in enumerate(placements):
        if q.is_shard():
            n = mesh.size(i)
            if local.shape[q.dim] % n:
                raise ValueError(f"dim {q.dim} of {tuple(x.shape)} does not "
                                 f"split evenly over {n} ranks")
            local = local.chunk(n, q.dim)[coord[i]]
    if local is not x:
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def filled(shape, value, dtype, spec, mesh):
    """A DTensor of `shape` holding `value` everywhere, laid out by the
    sanitised `spec` on the mesh's device type: each rank makes its own
    shard only (no rank ever holds the whole tensor)."""
    from torch.distributed.tensor import full

    return full(shape, value, dtype=dtype, device_mesh=mesh,
                placements=layout(spec, shape, mesh))


def distribute(x: torch.Tensor, spec, mesh):
    """`x` (the same full tensor on every rank) as a DTensor laid out by
    the sanitised `spec`."""
    return place(x, mesh, layout(spec, x.shape, mesh))


@dataclasses.dataclass(frozen=True)
class MeshPlacement:
    """Where a tensor goes: a DeviceMesh and one placement per mesh dim
    (the port's NamedSharding)."""

    mesh: object
    placements: tuple

    def put(self, x: torch.Tensor):
        """x laid out here: a plain tensor (the same full tensor on every
        rank) distributed, a DTensor redistributed (gathered whole first
        when it lives on another mesh)."""
        if is_dtensor(x):
            if x.device_mesh == self.mesh:
                return x.redistribute(self.mesh, self.placements)
            x = x.full_tensor()
        return place(x.detach().contiguous(), self.mesh, self.placements)


class _Ctx(threading.local):
    def __init__(self):
        self.rules: Optional[AxisRules] = None
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(rules: AxisRules, mesh=None):
    """Activate a rule set (and optionally a DeviceMesh) for the model
    code run inside."""
    prev = (_CTX.rules, _CTX.mesh)
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev


def current_rules() -> Optional[AxisRules]:
    return _CTX.rules


def current_mesh():
    return _CTX.mesh


def logical_axis_size(logical: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 outside a
    rules+mesh context) -- used for shard-local algorithm layouts (e.g.
    the MoE dispatch groups tokens by data shard)."""
    rules, mesh = _CTX.rules, _CTX.mesh
    if rules is None or mesh is None:
        return 1
    ax = rules.physical(logical)
    if ax is None:
        return 1
    sizes = _mesh_sizes(mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes.get(a, 1)
    return n


def logical_to_spec(*logical_axes: Optional[str]) -> PartitionSpec:
    rules = _CTX.rules
    if rules is None:
        return P(*([None] * len(logical_axes)))
    return rules.spec(*logical_axes)


def is_dtensor(x) -> bool:
    """Whether x is a DTensor.  No DTensor exists before
    `torch.distributed.tensor` is imported, and importing it takes a
    second or more, so an unsharded run never pays for it here."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def replicated_plain(tensors) -> contextlib.AbstractContextManager:
    """A context in which plain tensors meeting a DTensor count as
    replicated (DTensor's implicit replication), when any of `tensors`
    is a DTensor; else one that changes nothing."""
    if any(is_dtensor(t) for t in tensors):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The sharding constraint by logical axis names: a DTensor inside a
    rules+mesh context is redistributed to the spec (indivisible dims
    degrade to replication via sanitize_spec); a plain tensor, or any
    tensor outside such a context, is returned as it is."""
    rules, mesh = _CTX.rules, _CTX.mesh
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    target = layout(rules.spec(*logical_axes), x.shape, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


# ---------------------------------------------------------------------------
# Products on local shards
# ---------------------------------------------------------------------------
def as_dtensor(x: torch.Tensor, mesh):
    """x as a DTensor on `mesh`: a plain tensor (the same on every rank)
    counts as replicated."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_plan(x, w, k_dim: int, n_dim: int):
    """Placements under which `x` [..., K] meets the weight `w` (K on dim
    k_dim, N on n_dim) shard by shard, for each mesh dim: where x's
    leading (batch) dims are split, the split is kept and w gathered
    (weight-gathered serving, FSDP in training); else w's split along K
    pairs with x split along K (each rank a partial sum), and w's split
    along N with x whole (each rank its own output columns).  Returns (x
    placements, w placements, the [..., N] output's placements, with
    `Partial` where K is split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    nd = x.ndim
    xt, wt, out = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_shard() and not xp.is_shard(nd - 1):
            xt.append(xp), wt.append(Replicate()), out.append(xp)
        elif wp.is_shard(k_dim):
            xt.append(Shard(nd - 1)), wt.append(wp), out.append(Partial())
        elif wp.is_shard(n_dim):
            xt.append(Replicate()), wt.append(wp), out.append(Shard(nd - 1))
        else:
            xt.append(Replicate()), wt.append(Replicate())
            out.append(Replicate())
    return xt, wt, out


def local(x, placements, grad_placements=None) -> torch.Tensor:
    """x's local shard once laid out by `placements`; `grad_placements`
    say how the local gradients add up to x's (default: as laid out)."""
    return x.redistribute(x.device_mesh, placements).to_local(
        grad_placements=grad_placements)


def keep(placements, pred) -> list:
    """Each placement kept where pred(it), else Replicate."""
    from torch.distributed.tensor import Replicate

    return [q if pred(q) else Replicate() for q in placements]


def summed(placements) -> list:
    """`placements` with each Partial summed (made Replicate)."""
    return keep(placements, lambda q: not q.is_partial())


def shard_range(x, dim: int) -> tuple:
    """(start, size) of this rank's slice of a DTensor's dim `dim`, split
    over the mesh dims where x is `Shard(dim)`, major first (the split
    even, as `sanitize_spec` leaves it)."""
    mesh = x.device_mesh
    coord, start, size = mesh.get_coordinate(), 0, x.shape[dim]
    for i, q in enumerate(x.placements):
        if q.is_shard(dim):
            size //= mesh.size(i)
            start += coord[i] * size
    return start, size


def cut(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's local part of `x` laid out by `placements`: a plain x
    (the same on every rank) sliced by the rank's mesh coordinate, with
    no collective; a DTensor redistributed."""
    if is_dtensor(x):
        return x.redistribute(mesh, placements).to_local()
    return place(x, mesh, placements).to_local()


def masked_ids(ids: torch.Tensor, start: int, size: int) -> tuple:
    """(ids - start with those outside [0, size) set to 0, the mask of
    those): the rows a rank holding rows [start, start + size) looks up,
    and the ones it must zero."""
    idx = ids.long() - start
    miss = (idx < 0) | (idx >= size)
    return idx.masked_fill(miss, 0), miss


def sharded_embedding(tokens: torch.Tensor, table) -> torch.Tensor:
    """Rows of a DTensor `table` [V, D] at `tokens` [B, ...] (plain, the
    same on every rank, or a DTensor), on the local shards: each rank
    looks up its batch rows (the mesh dims that the active rules'
    "batch" maps to, where they do not split V) on the rows of V it
    holds, zeros elsewhere.  The output [B, ..., D] is `Shard(0)` over
    the batch's mesh dims, a partial sum over V's, summed over those at
    once, and split along D where the table's D is split and the batch
    is not.  Where one mesh dim of n ranks splits both the batch and the
    table's D, a rank needs either the table's other columns or the
    other ranks' tokens, and takes the cheaper: the table's D gathered
    (each rank receives (n - 1) * its rows * D / n) where the tokens
    number at least n times the table's local rows (training, prefill);
    else the tokens, all B rows looked up on the rank's own columns and
    moved to their batch shards by one all-to-all ((n - 1) / n * B * S *
    D / n) (decode).  Where a rank looks up only its batch rows on the
    gathered table, the table's gradient comes back as a partial sum.
    Returns a DTensor.  (DTensor's own embedding masks its ids with a
    boolean index, which a fake CUDA tensor cannot run without a card.)"""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    batch = layout(logical_to_spec("batch", *[None] * (tokens.ndim - 1)),
                   tokens.shape, mesh)
    start, rows = shard_range(table, 0)
    tok, tab, grad, out, final = [], [], [], [], []
    for i, (q, b) in enumerate(zip(table.placements, batch)):
        if q.is_shard(0):  # V split: this rank's rows, a partial sum
            tok.append(Replicate()), tab.append(q), grad.append(q)
            out.append(Partial()), final.append(Replicate())
        elif b.is_shard(0) and not (
                q.is_shard(1) and tokens.numel() < rows * mesh.size(i)):
            # batch split: this rank's tokens, the table whole on this dim
            tok.append(b), tab.append(Replicate()), grad.append(Partial())
            out.append(b), final.append(b)
        else:  # every token here; the table's columns as they lie
            tok.append(Replicate()), tab.append(q), grad.append(q)
            out.append(Shard(tokens.ndim) if q.is_shard(1) else Replicate())
            final.append(b if b.is_shard(0) else out[-1])
    ids, miss = masked_ids(cut(tokens, mesh, tok), start, rows)
    y = F.embedding(ids, local(table, tab, grad))
    y = y.masked_fill(miss[..., None], 0)
    return DTensor.from_local(y, mesh, out, run_check=False).redistribute(
        mesh, final)


def sharded_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w [K, N] (w a DTensor) by `local_plan`: the library
    product of the local shards, partial sums over a K split summed at
    once (the row-parallel all-reduce).  Returns a DTensor.  Under
    autograd, x's local gradient is a partial sum where w's N is split,
    and w's where x's batch is (summed on the way back)."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = w.device_mesh
    x = as_dtensor(x, mesh)
    xt, wt, out = local_plan(x, w, 0, 1)
    lead = [q.is_shard() and not q.is_shard(x.ndim - 1) for q in xt]
    xg = [Partial() if q.is_shard(1) else p for p, q in zip(xt, wt)]
    wg = [Partial() if b else q for b, q in zip(lead, wt)]
    y = torch.matmul(local(x, xt, xg), local(w, wt, wg))
    return DTensor.from_local(y, mesh, out).redistribute(mesh, summed(out))

