"""The benchmark's harness: one cell, one seed, one run.

Everything that belongs to a cell is found by name: the workload's
entry in `BENCHMARK.json` names its configuration (`bench/configs/`) and
its traffic; `bench/workloads/<cell>.json` holds the traffic's parameters;
the configuration's `model` names its kind, `bench/kinds/<model>.py`,
which makes the inputs and the system under test, gives the timed call,
its output and the units it counts, and checks the outputs against the
plain reference; each per-layer metric is read by
`bench/metrics/<metric>.py`, a module with `read(ctx) -> float | None`.
Nothing here knows a cell or a kind of model by name.

A run: make the weights and the input pool from the seed, and build the
system under test through its normal entry point (the kind's `make`);
warm the cell's calls (`setup_s` ends here, counted from the process's
start); run the closed loop for the window; with `--trace 1`, trace a
short stretch of the same loop and run the per-layer readers; read the
memory peak; free the program; check a sample of the window's outputs
against the plain reference (the kind's `compare`); refuse to report if
JAX was loaded.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The run needs CUDA cards this machine does not have."""


def load_benchmark(root: Path = ROOT) -> dict:
    """`BENCHMARK.json` of the checkout at `root`."""
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    """One workload of the benchmark, with its data files read and its
    model kind loaded."""

    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    kind: object  # the module bench/kinds/<cfg["model"]>.py


def _for(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of `bench`, its configuration, traffic and
    kind."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    return Cell(
        name=name, chips=entry["chips"], cfg=cfg,
        traffic=json.loads(
            (root / "bench" / "workloads" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _for(m, name)],
        per_layer=[m for m in bench["per_layer"] if _for(m, name)],
        kind=load_kind(cfg["model"], root),
    )


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: Path = ROOT):
    """The module `bench/metrics/<name>.py`: its `read(ctx)`, and where
    the metric reads a layer inside `run`, its `wrap(setup)`, which names
    the program's call into that layer as `(span, owner, attribute)` or
    gives None."""
    return _load(root / "bench" / "metrics" / f"{name}.py",
                 f"bench_metric_{name.replace('.', '_')}")


def load_kind(name: str, root: Path = ROOT):
    """The module `bench/kinds/<name>.py`, `name` a configuration's
    `model`.  It gives:

    - `make(cfg, traffic, gen, device, log)`: the `Setup` fields `net`,
      `rows` (the input pool [pool, B, ...]), `keys` (or None), `noise`,
      `spec` and `pipe` (the system under test, built through its normal
      entry point), drawn from the generator `gen`;
    - `call(setup)`: the timed call `(inputs, keys) -> out`;
    - `output(setup)`: (shape, dtype) of one call's `out`;
    - `units(setup)`: what one call counts toward `inf_per_s`,
      `attempted` and `failed`;
    - `compare(setup, kept)`: the numbers compared, `{name: {"value",
      "limit", "rule"}}`, limits from the workload's `limits`
      (`check.compare` adds `calls_compared`);
    - `control_call(setup, control)`: the reference with one departure,
      shaped as the call, to stand in its place;
    - `step_work(setup)`: `roofline.Work` of one call's whole step."""
    return _load(root / "bench" / "kinds" / f"{name}.py",
                 f"bench_kind_{name.replace('.', '_')}")


@dataclasses.dataclass
class Setup:
    """What a run made from its seed, and the system built from it; the
    fields from `net` to `pipe` are the kind's (`load_kind`)."""

    cfg: dict
    traffic: dict
    device: object  # torch.device
    net: object  # the weights the reference reads
    rows: object  # the input pool [pool, B, ...] on the device
    keys: object  # [key batches, B, ...] per-row key words, or None
    noise: object  # the noise model the reference follows, or None
    spec: object  # what the timed call asks of the system
    pipe: object  # the system under test
    kind: object  # the module bench/kinds/<model>.py


@dataclasses.dataclass
class Context:
    """What a per-layer reader may read."""

    setup: Setup
    spans: dict  # the window's host-clock spans: {name: [seconds]}
    window: object  # loop.Stats of the window
    profile: object  # trace.Profile, or None off the card
    units: int  # what one call counts toward inf_per_s (`kind.units`)

    @property
    def batch(self) -> int:
        return self.setup.rows.shape[1]


def make_setup(cell: Cell, seed: int, device, log) -> Setup:
    """Weights and inputs from the seed, and the system built on them:
    the cell's kind draws them from one generator on `device`."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)
    made = cell.kind.make(cell.cfg, cell.traffic, gen, device, log)
    return Setup(cell.cfg, cell.traffic, torch.device(device),
                 kind=cell.kind, **made)


def program_call(setup: Setup):
    """The timed call through the system's entry point (`kind.call`)."""
    return setup.kind.call(setup)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: str = "cuda", root: Path = ROOT,
             substitute=None, log=None) -> dict:
    """One run of `cell`; returns the result line's object.

    device "cpu" is a rehearsal of the control flow: it reports no
    timing and no device metric.  `substitute(setup)`, when given, makes
    the call that stands in the program's place in the loop (the checks
    that the comparison can fail).
    """
    import torch

    from bench import check, loop, trace as tracing

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        raise NoCard(f"{cell.name} needs {cell.chips} CUDA card(s); "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                     " available")
    torch.set_num_threads(2)
    t = cell.traffic
    log(f"set-up: interpreter and torch {time.perf_counter() - t_process:.3f} s")
    setup = make_setup(cell, seed, "cuda:0" if on_card else "cpu", log)
    call = (substitute or program_call)(setup)
    spans = loop.Spans(enabled=trace)
    output, units = setup.kind.output(setup), setup.kind.units(setup)
    keep = loop.Reservoir(t["check_batches"], seed, output, setup.device)
    the_loop = loop.ClosedLoop(call, setup.rows, setup.keys, t["in_flight"],
                               output, spans, keep)
    for i in range(t["in_flight"]):  # warm the shapes the window runs
        t0 = time.perf_counter()
        call(*the_loop.inputs(i))
        if on_card:
            torch.cuda.synchronize()
        log(f"set-up: warm call {i} {time.perf_counter() - t0:.3f} s")
    setup_s = time.perf_counter() - t_process
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")

    window = the_loop.run(seconds=seconds)
    log(f"window: {window.in_window} of {window.dispatched} calls done in "
        f"{window.seconds} s")
    metrics, device_info, breakdown = {}, {}, None
    if trace:
        window_spans = {k: list(v) for k, v in spans.seconds.items()}
        readers = {m["name"]: load_metric(m["name"], root)
                   for m in cell.per_layer}
        profile = None
        if on_card:
            hooks = {}
            for mod in readers.values():
                hook = getattr(mod, "wrap", lambda s: None)(setup)
                if hook is not None and hasattr(hook[1], hook[2]):
                    hooks.setdefault(hook[0], hook)
            per_call = window.seconds / max(window.in_window, 1)
            profile = tracing.profile_stretch(
                the_loop,
                max(3, math.ceil(tracing.PROFILE_SECONDS / per_call)),
                list(hooks.values()))
            log(f"trace: {profile.calls} calls, "
                f"{sum(profile.op_launches.values())} device operations, "
                f"{profile.ops_matched} matched to their launch; layers "
                f"{profile.layer_launches}")
            device_info = {"busy_s": profile.busy_s,
                           "window_s": profile.window_s}
            breakdown = profile.breakdown()
        ctx = Context(setup, window_spans, window, profile, units)
        for m in cell.per_layer:
            if not on_card and m["source"] != "program_counter":
                continue  # a CPU run writes no timing
            try:
                value = readers[m["name"]].read(ctx)
            except (ImportError, AttributeError) as e:
                log(f"metric {m['name']}: nothing to read ({e!r})")
                value = None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif on_card:
        units_per_s = window.in_window * units / window.seconds
        for m in cell.end_to_end:
            value = {"inf_per_s": units_per_s, "setup_s": setup_s}.get(
                m["name"])
            if value is None:
                raise KeyError(f"no measurement for end-to-end metric "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if on_card:
        peak = torch.cuda.max_memory_allocated()
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips, "memory_peak_bytes": peak,
                       **device_info}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                       "memory_peak_bytes": 0}
    setup.pipe = None  # free the program before the reference runs
    call = the_loop = None
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check.compare(setup, keep.kept)
    log(f"reference check of {len(keep.kept)} calls: "
        f"{time.perf_counter() - t0:.3f} s")
    correct = check.passed(checks)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {bad}")
    result = {"correct": correct, "attempted": window.dispatched * units,
              "failed": (window.dispatched - window.completed) * units,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} = {c['value']} (limit {c['rule']} {c['limit']})")
    return result


def main(argv=None, t_process: float | None = None) -> int:
    """`run.py --workload NAME --seed N --seconds S --trace 0|1`."""
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(load_benchmark(), args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_process=t_process)
    except NoCard as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
