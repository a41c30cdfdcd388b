"""PiC-BNN classification serving engine (port of `repro/serve/picbnn.py`,
round-robin fan-out): async micro-batching over compiled pipelines on
CUDA devices.

    server = PicBnnServer(BatchingPolicy(max_batch=256, max_wait_us=500))
    server.register("mnist", compile_pipeline(folded, cfg))
    server.start()                       # or: with PicBnnServer(...) as s:
    h = server.submit("mnist", image)    # image: [n_in], the model's domain
    res = h.result()                     # .pred, .votes, .latency_ms, ...
    server.close()
    print(server.stats().summary())

Threads:

  submit()/submit_many() --> MicroBatcher (serve/scheduler.py): requests
      are enqueued as contiguous lots, one lane per model, dispatched on a
      full `max_batch` or the `max_wait_us` deadline.
  dispatch thread: assembles a lane batch into a bucket-sized pinned host
      buffer, copies it to the next device round-robin with a
      non-blocking copy on that device's serving stream (inside
      `torch.cuda.device(dev)`: streams are per device and per thread),
      launches the pipeline there, starts a non-blocking copy of the votes
      into pinned host memory and records a CUDA event after it.
  completion thread: waits on each batch's event in dispatch order (never
      on the stream itself), publishes the votes and records metrics.

A request is one row of what the model's `CompiledPipeline.run` takes:
[n_in] ±1 activations for an MLP, [side*side] raw [0,1] pixels for a CNN.
A model is a `CompiledPipeline`, a `deploy.Deployment` or a saved
deployment directory.  A silicon model (its pipeline's physics is not
noiseless) serves `InferenceSpec(noise="per_request")` (with
`mc_samples=S, reduction="sum"` when registered with `mc_samples`): each
request carries its own raw uint32 [2] key words, and a bucket's pad
rows get zero keys.  Results equal a direct `CompiledPipeline.run` on the
same rows (and keys): bucketing is padding-invariant and every row is
computed independently.

`stats()` reports each model's served rate beside its Table-II
silicon-equivalent rate (`layer_sizes=` or `silicon_cost=` at
registration; `core/mapping.py`'s model of the 65 nm macro, not of the
card).

Fan-out over `devices`: "round_robin" runs each micro-batch whole on
the next device; "spmd" splits each bucket-padded micro-batch along
`PICBNN_SERVE_RULES`' batch axis (`sharding.batch_sharding` over
`sharding.serve_mesh(devices)`: equal contiguous slices, so every
bucket must divide by the device count), runs slice i on device i's
pipeline and stream (kernels 3/4 as for any batch), gathers the votes
on devices[0] and reads them back from there; its results carry
device -1.  The server is one process driving each local device itself,
so no process group is involved.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import mapping
from repro_torch.deploy import Deployment
from repro_torch.pipeline import CompiledPipeline, next_bucket, resolve_device
from repro_torch.sharding import rules as shrules
from repro_torch.serve.scheduler import (
    BatchingPolicy,
    LatencySummary,
    MicroBatcher,
    QueueFullError,
    latency_summary,
)
from repro_torch.spec import InferenceSpec

__all__ = [
    "BatchingPolicy",
    "ClassifyResult",
    "GroupHandle",
    "ModelStats",
    "PicBnnServer",
    "QueueFullError",
    "ServerStats",
]


@dataclasses.dataclass(frozen=True)
class ClassifyResult:
    """One served classification + its per-request timing."""

    uid: int
    model_id: str
    pred: int
    votes: np.ndarray  # [C] int32
    queue_ms: float  # submit -> batch dispatch (coalescing + queueing)
    service_ms: float  # dispatch -> readback complete (staging + compute)
    latency_ms: float  # submit -> readback complete
    batch_size: int  # logical requests in the micro-batch served with
    bucket: int  # padded bucket the batch dispatched into
    device: int  # ring index of the device that served it (-1: spmd)


class _Slab:
    """One admitted burst: contiguous request rows + placement map.

    `spans` is appended by the dispatch thread as the batcher carves the
    slab into micro-batches: (batch, slab_lo, batch_lo, k) means slab rows
    [slab_lo, slab_lo+k) became rows [batch_lo, batch_lo+k) of `batch`.
    """

    __slots__ = ("uid0", "model_id", "x", "keys", "t_submit", "n", "placed",
                 "spans")

    def __init__(self, uid0: int, model_id: str, x: np.ndarray,
                 keys: Optional[np.ndarray], t_submit: float):
        self.uid0 = uid0
        self.model_id = model_id
        self.x = x
        self.keys = keys  # [n, 2] uint32 for silicon models, else None
        self.t_submit = t_submit
        self.n = len(x)
        self.placed = 0
        self.spans: list = []


class _Batch:
    __slots__ = ("model_id", "n", "bucket", "device", "t_dispatch", "t_done",
                 "t_submits", "votes", "preds", "error", "event")

    def __init__(self, model_id: str, n: int, bucket: int, device: int,
                 t_dispatch: float, t_submits: np.ndarray):
        self.model_id = model_id
        self.n = n
        self.bucket = bucket
        self.device = device
        self.t_dispatch = t_dispatch
        self.t_done = 0.0
        self.t_submits = t_submits
        self.votes: Optional[np.ndarray] = None
        self.preds: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


class GroupHandle:
    """Result handle for one submitted burst (single requests use the
    `_Handle` subclass: a burst of one)."""

    __slots__ = ("_slab", "_srv")

    def __init__(self, slab: _Slab, srv: "PicBnnServer"):
        self._slab = slab
        self._srv = srv

    def __len__(self) -> int:
        return self._slab.n

    def done(self) -> bool:
        """True once every request in the burst has a published result."""
        slab = self._slab
        return slab.placed >= slab.n and all(
            b.event.is_set() for (b, _lo, _bp, _k) in slab.spans
        )

    def _wait_placed(self, deadline: Optional[float]) -> None:
        slab = self._slab
        if slab.placed >= slab.n:
            return
        cv = self._srv._dispatch_cv
        with cv:
            while slab.placed < slab.n:
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("request(s) not dispatched in time")
                cv.wait(remaining)

    def _wait_batches(self, timeout: Optional[float]) -> list:
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        self._wait_placed(deadline)
        spans = self._slab.spans
        for batch, _lo, _bp, _k in spans:
            if not batch.event.is_set() and not batch.event.wait(
                None if deadline is None
                else max(deadline - time.perf_counter(), 0.0)
            ):
                raise TimeoutError("batch not completed in time")
            if batch.error is not None:
                raise batch.error
        return spans

    def wait_all(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until every request is served; return preds [n] int."""
        spans = self._wait_batches(timeout)
        slab = self._slab
        preds = np.empty(slab.n, np.int64)
        for batch, lo, bp, k in spans:
            preds[lo:lo + k] = batch.preds[bp:bp + k]
        return preds

    def votes_all(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until served; return vote counts [n, C] int32."""
        spans = self._wait_batches(timeout)
        slab = self._slab
        out = None
        for batch, lo, bp, k in spans:
            if out is None:
                out = np.empty((slab.n, batch.votes.shape[1]),
                               batch.votes.dtype)
            out[lo:lo + k] = batch.votes[bp:bp + k]
        return out

    def _result_at(self, i: int) -> ClassifyResult:
        slab = self._slab
        for batch, lo, bp, k in slab.spans:
            if lo <= i < lo + k:
                j = bp + (i - lo)
                return ClassifyResult(
                    uid=slab.uid0 + i,
                    model_id=batch.model_id,
                    pred=int(batch.preds[j]),
                    votes=batch.votes[j],
                    queue_ms=(batch.t_dispatch - slab.t_submit) * 1e3,
                    service_ms=(batch.t_done - batch.t_dispatch) * 1e3,
                    latency_ms=(batch.t_done - slab.t_submit) * 1e3,
                    batch_size=batch.n,
                    bucket=batch.bucket,
                    device=batch.device,
                )
        raise IndexError(i)  # unreachable after _wait_batches

    def results(self, timeout: Optional[float] = None) -> list:
        """Block until served; return per-request ClassifyResults."""
        self._wait_batches(timeout)
        return [self._result_at(i) for i in range(self._slab.n)]


class _Handle(GroupHandle):
    """Single-request handle (a burst of exactly one)."""

    __slots__ = ()

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until served; return just the predicted class."""
        return int(self.wait_all(timeout)[0])

    def result(self, timeout: Optional[float] = None) -> ClassifyResult:
        """Block until served; return the full ClassifyResult."""
        self._wait_batches(timeout)
        return self._result_at(0)


@dataclasses.dataclass
class _Model:
    """Registry entry: one pipeline per serving device + its spec."""

    model_id: str
    pipes: list  # pipes[i] lives on the server's devices[i]
    silicon: bool  # per-request keyed draws (physics not noiseless)
    spec: InferenceSpec  # the ONE spec every dispatch for this model runs
    silicon_cost: Optional[mapping.InferenceCost]  # Table-II equivalent

    @property
    def pipe(self) -> CompiledPipeline:
        return self.pipes[0]


@dataclasses.dataclass(frozen=True)
class ModelStats:
    """Per-model serving report."""

    model_id: str
    n_requests: int
    n_batches: int
    mean_batch: float
    mean_occupancy: float  # logical batch / padded bucket (1 = no waste)
    inf_per_s: float  # over this model's active window
    latency: LatencySummary
    queue: LatencySummary
    service: LatencySummary
    silicon_inf_per_s: Optional[float]  # mapping.model_inference_cost
    vs_silicon: Optional[float]  # achieved / silicon-equivalent


@dataclasses.dataclass(frozen=True)
class ServerStats:
    """Aggregate serving report (see summary())."""

    n_requests: int
    n_batches: int
    wall_s: float  # first dispatch -> last completion
    inf_per_s: float
    mean_batch: float
    mean_occupancy: float
    queue_high_water: int
    latency: LatencySummary
    queue: LatencySummary
    service: LatencySummary
    per_model: dict[str, ModelStats]

    def summary(self) -> str:
        """Human-readable multi-line serving report."""
        lines = [
            f"served {self.n_requests} requests in {self.n_batches} "
            f"batches over {self.wall_s:.3f}s -> {self.inf_per_s:,.0f} "
            f"inf/s (mean batch {self.mean_batch:.1f}, occupancy "
            f"{self.mean_occupancy:.2f}, queue high-water "
            f"{self.queue_high_water})",
            f"  latency  {self.latency}",
            f"  queue    {self.queue}",
            f"  service  {self.service}",
        ]
        for ms in self.per_model.values():
            line = (f"  [{ms.model_id}] {ms.n_requests} reqs @ "
                    f"{ms.inf_per_s:,.0f} inf/s, p99 "
                    f"{ms.latency.p99_ms:.3f} ms")
            if ms.silicon_inf_per_s:
                line += (f" — silicon-equivalent {ms.silicon_inf_per_s:,.0f}"
                         f" inf/s (x{ms.vs_silicon:.3f} of Table II)")
            lines.append(line)
        return "\n".join(lines)


class PicBnnServer:
    """Async micro-batching classification server over compiled pipelines.

    devices : where batches run; None means every CUDA device (raises
        without CUDA), ["cpu"] runs the plain kernel versions.
    fanout : "round_robin" (each batch whole on the next device) or
        "spmd" (each batch split over all of them; see the module
        docstring).
    Thread model: N client threads call submit()/submit_many(); one
    dispatch thread coalesces, stages and launches; one completion thread
    waits on each batch's CUDA event and publishes results.  `close()`
    drains everything already admitted, then joins both threads.
    """

    def __init__(self, policy: BatchingPolicy = BatchingPolicy(), *,
                 devices: Optional[Sequence] = None,
                 fanout: str = "round_robin",
                 stats_window: int = 4096):
        if fanout not in ("round_robin", "spmd"):
            raise ValueError(f"unknown fanout {fanout!r}")
        if devices:
            self.devices = [resolve_device(d) for d in devices]
        else:
            resolve_device(None)  # raises without CUDA
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        self.policy = policy
        self.stats_window = stats_window
        self.fanout = fanout
        self._mesh = None
        self._batch_sharding = None
        if fanout == "spmd":
            self._mesh = shrules.serve_mesh(self.devices)
            self._batch_sharding = shrules.batch_sharding(self._mesh)
        self._streams: list = []
        self._models: dict[str, _Model] = {}
        self._batcher = MicroBatcher(policy)
        self._inflight: list = []
        self._inflight_cond = threading.Condition()
        # percentiles come from a BOUNDED window of recent batch records;
        # counts and throughput are running totals
        self._records: "collections.deque[_Batch]" = collections.deque(
            maxlen=stats_window
        )
        self._totals: dict[str, list] = {}  # model -> [n, batches, t0, t1]
        self._records_lock = threading.Lock()
        self._dispatch_cv = threading.Condition()
        self._uid = 0
        self._uid_lock = threading.Lock()
        self._next_dev = 0
        self._started = False
        self._closed = False
        self._dispatch_t: Optional[threading.Thread] = None
        self._complete_t: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------
    def register(self, model_id: str, model, *,
                 layer_sizes: Optional[Sequence[int]] = None,
                 silicon_cost: Optional[mapping.InferenceCost] = None,
                 mc_samples: int = 0, warmup: bool = False) -> None:
        """Add a model to the registry.

        model : a `CompiledPipeline` (MLP or CNN), a `deploy.Deployment`
            (compiled here on the first serving device), or a str/Path to
            a saved deployment directory (`Deployment.save` output, from
            either package).  The pipeline, conv operands and physics
            included, is copied onto every serving device
            (`CompiledPipeline.to`).
        layer_sizes : optional (n_in, ..., n_classes) of a deployed MLP
            — enables the Table-II silicon-equivalent throughput in
            stats() via `mapping.model_inference_cost`.  Derived from a
            pure-MLP Deployment.
        silicon_cost : alternative to layer_sizes for other graphs — a
            precomputed `mapping.InferenceCost` (e.g.
            `convnet.cnn_inference_cost` for a CNN).
        mc_samples : > 0 serves a silicon model's requests through the
            per-request Monte-Carlo spec, the prediction of the summed
            votes; 0 serves one realization per request.
        warmup : run the model's whole bucket grid on every device now.

        The model's dispatch spec is fixed here: `InferenceSpec()` for a
        noiseless model, `InferenceSpec(noise="per_request"[,
        mc_samples=S, reduction="sum"])` for a silicon one.
        """
        if self._started:
            raise RuntimeError("register() before start()")
        if model_id in self._models:
            raise ValueError(f"model {model_id!r} already registered")
        if isinstance(model, (str, Path)):
            model = Deployment.load(model)
        if isinstance(model, Deployment):
            if layer_sizes is None and silicon_cost is None:
                layer_sizes = model.layer_sizes  # None for conv graphs
            model = model.pipeline(self.devices[0])
        if not isinstance(model, CompiledPipeline):
            raise TypeError(
                "register() takes a CompiledPipeline, a Deployment or a "
                f"saved deployment directory, got {type(model).__name__}"
            )
        phys = model.physics
        silicon = phys is not None and not phys.is_noiseless
        if mc_samples and not silicon:
            raise ValueError("mc_samples needs a silicon-mode pipeline")
        if layer_sizes is not None and silicon_cost is not None:
            raise ValueError("pass layer_sizes OR silicon_cost, not both")
        cost = silicon_cost
        if layer_sizes is not None:
            if (int(layer_sizes[0]), int(layer_sizes[-1])) != \
                    (model.n_in, model.n_classes):
                raise ValueError(
                    f"layer_sizes {tuple(layer_sizes)} disagree with the "
                    f"pipeline ({model.n_in} -> {model.n_classes})"
                )
            plans = [
                mapping.plan_layer(int(n_out), int(n_in),
                                   model.head.bias_cells)
                for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:])
            ]
            cost = mapping.model_inference_cost(
                plans, int(model.head.thresholds.shape[0])
            )
        if silicon:
            spec = (InferenceSpec(noise="per_request",
                                  mc_samples=int(mc_samples),
                                  reduction="sum")
                    if mc_samples else InferenceSpec(noise="per_request"))
        else:
            spec = InferenceSpec()
        m = _Model(model_id=model_id,
                   pipes=[model.to(d) for d in self.devices],
                   silicon=silicon, spec=spec, silicon_cost=cost)
        self._models[model_id] = m
        if warmup:
            self._warm_model(m)

    def _warm_model(self, m: _Model) -> dict:
        times: dict = {}
        if self.fanout == "spmd":
            # the split placement dispatch uses: each bucket cut over the
            # devices, every slice through its device's pipeline
            for b in m.pipe.buckets_for(self.policy.max_batch):
                x = np.ones((b, m.pipe.n_in), np.float32)
                keys = np.zeros((b, 2), np.uint32) if m.silicon else None
                t0 = time.perf_counter()
                _, event, parts = self._launch_spmd(m, x, keys)
                if event is not None:
                    event.synchronize()
                del parts
                times[(m.spec, b)] = time.perf_counter() - t0
            return times
        for pipe in m.pipes:
            for key, s in pipe.warmup(self.policy.max_batch,
                                      specs=(m.spec,)).items():
                times[key] = times.get(key, 0.0) + s
        return times

    def warmup(self) -> dict[str, dict]:
        """Run every (model, bucket, device) shape once.

        Returns {model_id: {(spec, bucket): seconds}}, summed over devices.
        """
        return {mid: self._warm_model(m) for mid, m in self._models.items()}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "PicBnnServer":
        """Validate the registry and launch the dispatch/completion
        threads; idempotent.  Returns self (context-manager entry)."""
        if self._started:
            return self
        if not self._models:
            raise RuntimeError("no models registered")
        n_dev = len(self.devices)
        for m in self._models.values():
            if self.fanout == "spmd":
                odd = [b for b in m.pipe.buckets_for(self.policy.max_batch)
                       if b % n_dev]
                if odd:
                    raise ValueError(
                        f'fanout="spmd" splits each bucket over {n_dev} '
                        f"devices; {m.model_id!r}'s buckets {odd} do not "
                        "divide")
            if m.pipe.max_bucket is None:
                continue
            need = next_bucket(self.policy.max_batch, m.pipe.min_bucket)
            if need > m.pipe.max_bucket:
                raise ValueError(
                    f"policy.max_batch {self.policy.max_batch} needs "
                    f"bucket {need} > {m.model_id!r}'s pipeline "
                    f"max_bucket {m.pipe.max_bucket}"
                )
        self._streams = []
        self._ensure_streams()
        self._started = True
        self._dispatch_t = threading.Thread(
            target=self._dispatch_loop, name="picbnn-dispatch", daemon=True
        )
        self._complete_t = threading.Thread(
            target=self._complete_loop, name="picbnn-complete", daemon=True
        )
        self._dispatch_t.start()
        self._complete_t.start()
        return self

    def _ensure_streams(self) -> None:
        """One serving stream per device entry (None on the CPU), made
        once."""
        if self._streams:
            return
        for dev in self.devices:
            if dev.type == "cuda":
                # the weights were copied on the default stream: finish
                # that before the serving stream reads them
                torch.cuda.synchronize(dev)
                self._streams.append(torch.cuda.Stream(device=dev))
            else:
                self._streams.append(None)

    def close(self) -> None:
        """Drain admitted requests, complete in-flight batches, join."""
        if self._closed:
            return
        self._closed = True
        self._batcher.close()
        if self._started:
            self._dispatch_t.join()
            self._complete_t.join()
        else:
            # never started: fail anything queued so no handle hangs
            while True:
                got = self._batcher.next_batch(timeout=0)
                if got is None:
                    break
                self._fail_batch(got[0], got[1],
                                 RuntimeError("server closed before start"))

    def __enter__(self) -> "PicBnnServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _admit(self, model_id: str, images, keys, single: bool,
               block: bool, timeout: Optional[float]):
        t_submit = time.perf_counter()
        m = self._models.get(model_id)
        if m is None:
            raise KeyError(f"unknown model {model_id!r}; registered: "
                           f"{sorted(self._models)}")
        if self._closed:
            raise RuntimeError("server is closed")
        x = np.asarray(images, np.float32)
        if single:
            x = x.reshape(1, -1) if x.ndim == 1 else x
        # reject bad shapes HERE: inside the dispatch thread they would
        # fail a whole coalesced batch of innocent neighbors
        if x.ndim != 2 or x.shape[1] != m.pipe.n_in:
            raise ValueError(
                f"expected image(s) [{'' if single else 'W, '}"
                f"{m.pipe.n_in}] for model {model_id!r}, got shape "
                f"{np.shape(images)}"
            )
        if m.silicon:
            if keys is None:
                raise ValueError(
                    f"model {model_id!r} is silicon-mode: each request "
                    "must carry its own PRNG key (key(s)=...)"
                )
            keys = np.asarray(keys, np.uint32)
            if single:
                keys = keys.reshape(1, -1) if keys.ndim == 1 else keys
            if keys.shape != (len(x), 2):
                raise ValueError(
                    f"keys must be raw uint32 [{len(x)}, 2] PRNG keys, "
                    f"got {keys.shape}"
                )
        elif keys is not None:
            raise ValueError(
                f"model {model_id!r} is noiseless: key(s)= not accepted"
            )
        with self._uid_lock:
            uid0 = self._uid
            self._uid += len(x)
        slab = _Slab(uid0, model_id, x, keys, t_submit)
        self._batcher.put(model_id, slab, size=slab.n, t_enqueue=t_submit,
                          block=block, timeout=timeout)
        return slab

    def submit(self, model_id: str, image, key=None, *,
               block: bool = True,
               timeout: Optional[float] = None) -> _Handle:
        """Enqueue one single-image request; returns a result handle.

        image : [n_in] ±1 activations for an MLP, [side*side] [0,1]
            pixels for a CNN (anything np.asarray-able).
        key   : the request's raw uint32 [2] key words — required for a
            silicon model (its draw depends on nothing else), rejected
            for a noiseless one.
        block/timeout : admission behavior when `max_queue` is bounded;
            block=False raises QueueFullError instead of waiting.
        """
        slab = self._admit(model_id, image, key, True, block, timeout)
        return _Handle(slab, self)

    def submit_many(self, model_id: str, images, keys=None, *,
                    block: bool = True,
                    timeout: Optional[float] = None) -> GroupHandle:
        """Enqueue a burst of single-image requests in one admission
        round; returns a GroupHandle over all of them.

        Each image is still an independent request (own uid, free to be
        coalesced with other traffic and split across micro-batches), but
        the burst is admitted and queued as ONE contiguous slab.
        `images`: [W, n_in]; `keys`: [W, 2] uint32 for silicon models.
        """
        slab = self._admit(model_id, images, keys, False, block, timeout)
        return GroupHandle(slab, self)

    def _fail_batch(self, model_id: str, spans, err: BaseException) -> None:
        n = sum(s.n for s in spans)
        batch = _Batch(model_id, n, 0, -1, time.perf_counter(),
                       np.full(n, time.perf_counter()))
        batch.error = err
        pos = 0
        for s in spans:
            s.lot.spans.append((batch, s.lo, pos, s.n))
            s.lot.placed += s.n
            pos += s.n
        with self._dispatch_cv:
            self._dispatch_cv.notify_all()
        batch.t_done = time.perf_counter()
        batch.event.set()
        with self._records_lock:
            self._records.append(batch)

    def _dispatch_loop(self) -> None:
        while True:
            got = self._batcher.next_batch()
            if got is None:
                break
            model_id, spans = got
            try:
                self._dispatch(self._models[model_id], spans)
            except BaseException as e:  # resolve, don't hang clients
                self._fail_batch(model_id, spans, e)
        with self._inflight_cond:
            self._inflight.append(None)  # completion sentinel
            self._inflight_cond.notify_all()

    def _launch(self, pipe: CompiledPipeline, spec: InferenceSpec,
                x: np.ndarray, keys: Optional[np.ndarray], stream):
        """Stage `x` (and a silicon model's key words) on the pipeline's
        device, run it, start the readback.

        Returns (votes, event): on a CUDA device `votes` is a pinned host
        tensor filled by a non-blocking copy that `event` (recorded after
        it) marks complete; on the CPU the votes are final and event None.
        """
        votes = self._run_staged(pipe, spec, x, keys, stream)
        return self._readback(votes, pipe.device, stream)

    def _launch_spmd(self, m: _Model, x: np.ndarray,
                     keys: Optional[np.ndarray]):
        """`_launch` with the batch split over the devices: slice i
        through device i's pipeline on its stream, the votes gathered on
        devices[0] (its stream waiting for every other slice's) and read
        back from there.

        Returns (votes, event, parts): each slice's votes were allocated
        on its own stream and are read on devices[0]'s, so the caller
        holds `parts` until `event` completes; freed earlier, the caching
        allocator could hand a block to the next batch on that stream
        while this gather is still queued."""
        self._ensure_streams()
        split = self._batch_sharding.split
        xs = split(torch.from_numpy(x))
        ks = split(torch.from_numpy(keys)) if keys is not None \
            else [None] * len(xs)
        parts = [self._run_staged(pipe, m.spec, xi.numpy(),
                                  None if ki is None else ki.numpy(), st)
                 for pipe, st, xi, ki in zip(m.pipes, self._streams, xs, ks)]
        dev0, st0 = self.devices[0], self._streams[0]
        if dev0.type != "cuda":
            return torch.cat([v.to(dev0) for v in parts]), None, None
        for dev, st in zip(self.devices, self._streams):
            if st is not None and st is not st0:
                with torch.cuda.device(dev):
                    done = torch.cuda.Event()
                    done.record(st)
                st0.wait_event(done)
        with torch.cuda.device(dev0), torch.cuda.stream(st0):
            votes = torch.cat([v.to(dev0, non_blocking=True) for v in parts])
        return (*self._readback(votes, dev0, st0), parts)

    def _run_staged(self, pipe: CompiledPipeline, spec: InferenceSpec,
                    x: np.ndarray, keys: Optional[np.ndarray], stream):
        """`x` (and key words) staged on the pipeline's device through
        pinned host memory, then run on `stream`; returns the votes on
        the device (final on the CPU)."""
        dev = pipe.device
        if dev.type != "cuda":
            return pipe.run(torch.from_numpy(x), spec, keys=keys)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            # pinned blocks come from PyTorch's caching host allocator,
            # which holds a block back until the copies that used it have
            # completed on their stream
            xh = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
            xh.numpy()[...] = x
            xd = xh.to(dev, non_blocking=True)
            kd = None
            if keys is not None:
                kh = torch.empty(keys.shape, dtype=torch.int64,
                                 pin_memory=True)
                kh.numpy()[...] = keys
                kd = kh.to(dev, non_blocking=True)
            return pipe.run(xd, spec, keys=kd)

    @staticmethod
    def _readback(votes: torch.Tensor, dev: torch.device, stream):
        """(votes, None) on the CPU; on a card the pinned host copy and
        the event recorded after it on `stream`."""
        if dev.type != "cuda":
            return votes, None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            vh = torch.empty(votes.shape, dtype=votes.dtype, pin_memory=True)
            vh.copy_(votes, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return vh, event

    def _dispatch(self, m: _Model, spans) -> None:
        t_dispatch = time.perf_counter()
        n = sum(s.n for s in spans)
        pipe = m.pipe
        bucket = next_bucket(n, pipe.min_bucket, pipe.max_bucket)
        # assemble straight into a bucket-sized host buffer (pad rows are
        # zeros with zero keys, dropped at readback), one vectorized copy
        # per span
        x = np.zeros((bucket, pipe.n_in), np.float32)
        keys = np.zeros((bucket, 2), np.uint32) if m.silicon else None
        t_subs = np.empty(n)
        placed = []
        pos = 0
        for s in spans:
            k, slab = s.n, s.lot
            x[pos:pos + k] = slab.x[s.lo:s.hi]
            if m.silicon:
                keys[pos:pos + k] = slab.keys[s.lo:s.hi]
            t_subs[pos:pos + k] = slab.t_submit
            placed.append((slab, s.lo, pos, k))
            pos += k
        if self.fanout == "spmd":
            dev_idx = -1
            votes, event, hold = self._launch_spmd(m, x, keys)
        else:
            dev_idx = self._next_dev
            self._next_dev = (self._next_dev + 1) % len(self.devices)
            votes, event = self._launch(m.pipes[dev_idx], m.spec, x, keys,
                                        self._streams[dev_idx])
            hold = None
        batch = _Batch(m.model_id, n, bucket, dev_idx, t_dispatch, t_subs)
        for slab, lo, bpos, k in placed:
            slab.spans.append((batch, lo, bpos, k))
            slab.placed += k
        with self._dispatch_cv:
            self._dispatch_cv.notify_all()
        with self._inflight_cond:
            while len(self._inflight) >= self.policy.max_inflight:
                self._inflight_cond.wait()
            self._inflight.append((batch, votes, event, hold))
            self._inflight_cond.notify_all()

    def _complete_loop(self) -> None:
        while True:
            with self._inflight_cond:
                while not self._inflight:
                    self._inflight_cond.wait()
                item = self._inflight.pop(0)
                self._inflight_cond.notify_all()
            if item is None:
                break
            batch, votes, event, hold = item
            try:
                if event is not None:
                    event.synchronize()
                del hold  # the gather that read these has completed
                votes_np = votes[:batch.n].numpy().copy()  # drop pad rows
                batch.votes = votes_np
                batch.preds = votes_np.argmax(-1)
            except BaseException as e:
                batch.error = e
            batch.t_done = time.perf_counter()
            batch.event.set()
            with self._records_lock:
                self._records.append(batch)
                if batch.error is None:
                    tot = self._totals.setdefault(
                        batch.model_id,
                        [0, 0, batch.t_dispatch, batch.t_done],
                    )
                    tot[0] += batch.n
                    tot[1] += 1
                    tot[2] = min(tot[2], batch.t_dispatch)
                    tot[3] = max(tot[3], batch.t_done)

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def stats(self) -> ServerStats:
        """Aggregate ServerStats: lifetime-accurate counts/throughput
        (running totals), percentiles over the last `stats_window`
        completed batches."""
        with self._records_lock:
            records = [b for b in self._records if b.error is None]
            totals = {k: list(v) for k, v in self._totals.items()}
        if not totals:
            empty = latency_summary([])
            return ServerStats(0, 0, 0.0, 0.0, 0.0, 0.0,
                               self._batcher.high_water, empty, empty,
                               empty, {})

        def _summaries(rs):
            if not rs:
                e = latency_summary([])
                return e, e, e, 0.0
            lat = np.concatenate([b.t_done - b.t_submits for b in rs])
            que = np.concatenate([b.t_dispatch - b.t_submits for b in rs])
            svc = np.concatenate(
                [np.full(b.n, b.t_done - b.t_dispatch) for b in rs]
            )
            occ = float(np.mean([b.n / b.bucket for b in rs]))
            return (latency_summary(lat * 1e3), latency_summary(que * 1e3),
                    latency_summary(svc * 1e3), occ)

        n_req = sum(t[0] for t in totals.values())
        n_batches = sum(t[1] for t in totals.values())
        wall = (max(t[3] for t in totals.values())
                - min(t[2] for t in totals.values()))
        lat, que, svc, occ = _summaries(records)
        per_model = {}
        for mid, tot in totals.items():
            m = self._models[mid]
            mlat, mque, msvc, mocc = _summaries(
                [b for b in records if b.model_id == mid]
            )
            mwall = tot[3] - tot[2]
            si = (m.silicon_cost.inferences_per_s
                  if m.silicon_cost else None)
            rate = tot[0] / mwall if mwall > 0 else float("inf")
            per_model[mid] = ModelStats(
                model_id=mid,
                n_requests=tot[0],
                n_batches=tot[1],
                mean_batch=tot[0] / tot[1],
                mean_occupancy=mocc,
                inf_per_s=rate,
                latency=mlat,
                queue=mque,
                service=msvc,
                silicon_inf_per_s=si,
                vs_silicon=(rate / si if si else None),
            )
        return ServerStats(
            n_requests=n_req,
            n_batches=n_batches,
            wall_s=wall,
            inf_per_s=n_req / wall if wall > 0 else float("inf"),
            mean_batch=n_req / n_batches,
            mean_occupancy=occ,
            queue_high_water=self._batcher.high_water,
            latency=lat,
            queue=que,
            service=svc,
            per_model=per_model,
        )
