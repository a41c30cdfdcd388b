"""Multi-pod dry-run: prove the distribution config is coherent (port of
`repro/launch/dryrun.py`).

For every (architecture x input-shape x mesh) cell this program:
  1. starts a fake process group of 256 (or 512) ranks and builds the
     production mesh on it (launch/mesh.py) -- the counterpart of the
     reference's 512 forced host devices; this rank stands for each,
  2. constructs fake-tensor stand-ins, placed as DTensors by the cell's
     rules (launch/specs.py) -- nothing is allocated,
  3. runs the step once (train_step / prefill_step / decode_step) on the
     fakes, inside the per-device cost counter (launch/hlo_cost.py),
     `CommDebugMode` and `FlopCounterMode` -- sharding mismatches and
     unsupported layouts surface HERE as exceptions, as compile errors
     do in the reference,
  4. reports the memory analysis (bytes a device: the placed arguments,
     the results, the peak of the storage made inside the step),
  5. derives the roofline (launch/roofline.py) from the counter,
  6. writes results/torch/dryrun/<cell>.json.

The fake group starts only when this module runs as a program (or in a
caller's `fake_group`), never at import.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint.ckpt import leaf_paths
from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.launch import hlo_cost, roofline, specs
from repro_torch.launch.mesh import make_mesh, validate_mesh
from repro_torch.serve.steps import decode_step, prefill_step
from repro_torch.sharding import (
    LONG_CONTEXT_RULES,
    SERVE_RULES,
    SERVE_SEQCACHE_RULES,
    TRAIN_RULES,
    TRAIN_SP_RULES,
    ZERO1_PARAM_RULES,
    use_rules,
)
from repro_torch.sharding.rules import _mesh_sizes, is_dtensor
from repro_torch.train import TrainConfig
from repro_torch.train.train_step import train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch" / \
    "dryrun"
POD_MESH = ((16, 16), ("data", "model"))
MULTIPOD_MESH = ((2, 16, 16), ("pod", "data", "model"))


def rules_for(shape, variant: str = "baseline"):
    if shape.kind == "train":
        return TRAIN_SP_RULES if "sp" in variant.split("-") else TRAIN_RULES
    if shape.name == "long_500k":
        return LONG_CONTEXT_RULES
    if "seqcache" in variant.split("-"):
        return SERVE_SEQCACHE_RULES
    return SERVE_RULES


def auto_microbatches(cfg, shape, mesh, target_gib: float = 12.0) -> int:
    """Gradient-accumulation factor targeting ~target_gib of per-device
    residual carries (the block stack keeps h [B/mb/dp, S, D] per block
    -- the dominant training activation term under full remat).

    This is exactly the knob a production framework config would set; the
    chosen value is recorded in the cell's JSON so the baseline is
    reproducible."""
    if shape.kind != "train":
        return 1
    sizes = _mesh_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if shape.global_batch % dp:
        return 1
    per_dev_batch = shape.global_batch // dp
    carries = cfg.blocks * shape.seq_len * cfg.d_model * 2 * per_dev_batch
    mb = 1
    while carries / mb > target_gib * 2**30 and mb < per_dev_batch:
        mb *= 2
    return min(mb, per_dev_batch)


def cell_id(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}"


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of `world_size` ranks (this process
    is rank 0 and stands for every rank; collectives move nothing),
    destroyed on exit.  The counterpart of the reference's forced host
    devices; it cannot share a process with a real default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the fake "
                           "group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape, axes):
    """A DeviceMesh over the fake group (`fake_group` of prod(shape))."""
    return make_mesh(shape, axes, specs.fake_device())


def production_mesh(multi_pod: bool):
    return fake_mesh(*(MULTIPOD_MESH if multi_pod else POD_MESH))


@dataclasses.dataclass
class Traced:
    """One traced cell: the counter's totals, the global FlopCounterMode
    figure, CommDebugMode's collective counts, the memory analysis, the
    counted ops (when recorded) and the trace's seconds."""

    totals: hlo_cost.CostTotals
    raw: dict
    comm_counts: dict
    memory: dict
    ops: list
    seconds: float
    microbatches: int


def local_bytes(tree) -> dict:
    """{id(storage): bytes} of the tree's local tensors (a DTensor's
    local shard), each storage once."""
    out = {}
    for _, t in leaf_paths(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if is_dtensor(t) else t
            out[id(loc.untyped_storage())] = loc.untyped_storage().nbytes()
    return out


@contextlib.contextmanager
def instruments(record: bool = False):
    """The counters a cell's step runs in: the cost counter, then
    `CommDebugMode` and `FlopCounterMode` above it (the same stack on
    real tensors and on fakes, so both see the same ops).  Yields
    (counter, comm, flops)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    with hlo_cost.CostCounter(record=record) as counter, \
            CommDebugMode() as comm, \
            FlopCounterMode(display=False) as flops:
        yield counter, comm, flops


def lower_cell(cfg, shape, mesh, *, tcfg=None, variant: str = "baseline",
               microbatches=None, remat=None, record: bool = False) -> Traced:
    """Trace one cell on fakes and count it (see the module's docstring).

    variant: '-'-separated levers: sp (sequence-parallel carries),
    zero1 (replicated params + data-sharded optimizer), seqcache
    (sequence-sharded decode cache); remat/microbatches override config.
    The port's decode takes the position as an int (`models.model.
    decode`): the cell decodes at seq_len - 1, a full cache's step; the
    `pos` spec's 4 bytes stay among the arguments.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    rules = rules_for(shape, variant).resolve(mesh)
    param_rules = (
        ZERO1_PARAM_RULES.resolve(mesh)
        if "zero1" in variant.split("-") else None
    )
    mb = 1
    with FakeTensorMode() as mode:
        if shape.kind == "train":
            mb = microbatches or auto_microbatches(cfg, shape, mesh)
            tcfg = tcfg or TrainConfig(microbatches=mb)
            args = specs.train_cell_args(cfg, shape, mesh, rules, tcfg,
                                         param_rules=param_rules, mode=mode)

            def step():
                return train_step(cfg, tcfg, *args)
        elif shape.kind == "prefill":
            args = specs.prefill_cell_args(cfg, shape, mesh, rules, mode)

            def step():
                return prefill_step(cfg, *args)
        else:
            args = specs.decode_cell_args(cfg, shape, mesh, rules, mode)

            def step():
                return decode_step(cfg, *args[:3], shape.seq_len - 1)
        arg_bytes = local_bytes(args)
        t0 = time.perf_counter()
        with use_rules(rules, mesh), \
                instruments(record) as (counter, comm, flops):
            out = step()
        seconds = time.perf_counter() - t0
        out_bytes = local_bytes(out)
    alias = sum(n for k, n in out_bytes.items() if k in arg_bytes)
    made = sum(n for k, n in out_bytes.items() if k in counter._new)
    temp = max(counter.peak_bytes - made, 0)
    args_n, outs_n = sum(arg_bytes.values()), sum(out_bytes.values())
    memory = {
        "argument_bytes_per_device": args_n,
        "output_bytes_per_device": outs_n,
        "temp_bytes_per_device": temp,
        "alias_bytes_per_device": alias,
        "peak_estimate_gib": round((args_n + outs_n + temp - alias) / 2**30,
                                   3),
    }
    totals = counter.totals
    totals.by_collective = dict(totals.by_collective)
    totals.hbm_by_op = dict(totals.hbm_by_op)
    totals.wire_by_link = dict(totals.wire_by_link)
    return Traced(totals=totals, raw=hlo_cost.cost_analysis_dict(flops),
                  comm_counts={str(k): v for k, v in
                               comm.get_comm_counts().items()},
                  memory=memory, ops=counter.ops, seconds=seconds,
                  microbatches=mb)


def measure(cfg, shape, mesh, **kw) -> dict:
    """The record's measured fields of one traced cell (`lower_cell`)."""
    tr = lower_cell(cfg, shape, mesh, **kw)
    w = tr.totals
    rep = roofline.derive(
        cfg, shape, mesh.size(),
        device_flops=w.flops,
        device_hbm_bytes=w.hbm_bytes,
        device_wire_bytes=w.collective_wire_bytes,
        device_binary_ops=w.binary_ops,
        device_nvlink_bytes=w.wire_by_link.get("nvlink", 0.0),
    )
    return dict(
        compile_s=round(tr.seconds, 1),
        memory_analysis=tr.memory,
        cost_analysis_raw={
            "flops": tr.raw["flops"],
            "bytes_accessed": None,
            "note": "FlopCounterMode: DTensor ops at their global shapes, "
                    "plain ops at theirs (see hlo_walker for per-device)",
        },
        hlo_walker={
            "device_flops": w.flops,
            "device_hbm_bytes": w.hbm_bytes,
            "device_wire_bytes": w.collective_wire_bytes,
            "device_collective_operand_bytes": w.collective_operand_bytes,
            "by_collective": w.by_collective,
            "collective_count": w.collective_count,
            "top_hbm": w.top_hbm(12),
            "device_binary_ops": w.binary_ops,
            "wire_by_link": w.wire_by_link,
            "comm_debug_counts": tr.comm_counts,
            "n_ops": w.n_ops,
        },
        roofline=rep.to_dict(),
        hlo_size_bytes=len(json.dumps(tr.ops)) if tr.ops else 0,
        microbatches=tr.microbatches,
        fake_device=specs.fake_device(),
        ops=tr.ops,
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             save_hlo: bool = False, variant: str = "baseline",
             microbatches=None, remat=None, tag: str = "") -> dict:
    """Trace, count and record one cell (the fake group of its mesh must
    be running)."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    record = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "variant": variant,
        "status": "running",
    }
    try:
        mesh = production_mesh(multi_pod)
        record["mesh"] = validate_mesh(mesh)
        if shape.kind == "train":
            record["microbatches"] = (
                microbatches or auto_microbatches(cfg, shape, mesh)
            )
            record["remat"] = remat or cfg.remat
        got = measure(cfg, shape, mesh, variant=variant,
                      microbatches=microbatches, remat=remat,
                      record=save_hlo)
        ops = got.pop("ops")
        got.pop("microbatches")
        record.update(status="ok", **got)
        if save_hlo:
            (out_dir / (cell_id(arch, shape_name, multi_pod) + tag
                        + ".ops.json")).write_text(json.dumps(ops))
        rep = record["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x "
              f"{'multipod' if multi_pod else 'pod'}: OK "
              f"({record['compile_s']}s trace, "
              f"peak {record['memory_analysis']['peak_estimate_gib']} GiB/dev,"
              f" bottleneck={rep['bottleneck']})")
        print("  memory_analysis:", record["memory_analysis"])
        print("  cost_analysis:", record["cost_analysis_raw"])
    except Exception as e:  # noqa: BLE001 — each cell must fail in isolation
        record.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-4000:],
            compile_s=round(time.time() - t0, 1),
        )
        print(f"[dryrun] {arch} x {shape_name}: FAILED — {e}")
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / (cell_id(arch, shape_name, multi_pod) + tag + ".json")
    out_path.write_text(json.dumps(record, indent=2, default=str))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="architecture id, ids joined by ',', or 'all'")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k (joined "
                    "by ',') or all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (pod,data,model) mesh instead of 16x16")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod for each cell")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the counted op list (there is no HLO)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="'-'-joined levers: sp, zero1, seqcache")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots",
                                                      "none"])
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (perf experiments)")
    args = ap.parse_args(argv)

    archs = (configs.list_archs() if args.arch == "all"
             else args.arch.split(","))
    out_dir = Path(args.out)

    if args.list:
        for a in archs:
            cfg = configs.get_config(a)
            names = [s.name for s in applicable_shapes(cfg)]
            skipped = [s for s in SHAPES if s not in names]
            print(f"{a}: {names}  (skipped: {skipped or 'none'})")
        return

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_err = n_skip = 0
    for mp in meshes:
        shape_mesh = (MULTIPOD_MESH if mp else POD_MESH)[0]
        with fake_group(math.prod(shape_mesh)):
            for arch in archs:
                cfg = configs.get_config(arch)
                app = {s.name for s in applicable_shapes(cfg)}
                shape_names = (
                    list(SHAPES) if args.shape == "all"
                    else args.shape.split(",")
                )
                for sn in shape_names:
                    if sn not in app:
                        print(f"[dryrun] {arch} x {sn}: SKIPPED "
                              f"(long-context inapplicable: full attention)")
                        out_dir.mkdir(parents=True, exist_ok=True)
                        (out_dir / (cell_id(arch, sn, mp) + ".json")
                         ).write_text(json.dumps({
                             "arch": arch, "shape": sn, "multi_pod": mp,
                             "status": "skipped",
                             "reason": "pure full-attention arch at 512k "
                                       "context (assignment exemption)",
                         }, indent=2))
                        n_skip += 1
                        continue
                    if args.skip_existing:
                        p = out_dir / (cell_id(arch, sn, mp) + ".json")
                        if p.exists():
                            st = json.loads(p.read_text()).get("status")
                            if st == "ok":
                                n_skip += 1
                                continue
                    rec = run_cell(arch, sn, mp, out_dir,
                                   save_hlo=args.save_hlo,
                                   variant=args.variant,
                                   microbatches=args.microbatches,
                                   remat=args.remat,
                                   tag=args.tag)
                    if rec["status"] == "ok":
                        n_ok += 1
                    else:
                        n_err += 1
    print(f"[dryrun] done: {n_ok} ok, {n_err} failed, {n_skip} skipped")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
