"""End-to-end deployed-BNN inference pipeline (port of `repro/pipeline.py`).

`compile_pipeline(folded, ens_cfg)` turns a folded binary MLP (a list of
`bnn.FoldedLayer`), or a binary CNN (a prefix of
`convnet.FoldedConvLayer` before them), plus an Algorithm-1 ensemble
config into a batch classifier on one device, driven by a declarative
request spec (`repro_torch.spec.InferenceSpec`):

    pipe = compile_pipeline(folded, EnsembleConfig())          # on the card
    votes = pipe.run(x_pm1, InferenceSpec())                    # [B, C] int32
    pred  = pipe.run(x_pm1, InferenceSpec(reduction="argmax"))  # [B] int32
    cum   = pipe.run(x_pm1, InferenceSpec(cumulative=True))     # [P, B, C]

The pipeline runs on the card unless asked otherwise: `device=None`
means CUDA, and without CUDA it raises; pass `device="cpu"` to run the
plain PyTorch versions of the kernels on the CPU.

An MLP takes ±1 activations [B, n_in].  Votes and argmax go through
`kernels.fused_mlp.fused_mlp_votes`: one launch of kernel 3 per batch,
hidden activations resident in shared memory.  The noiseless cumulative
staircase needs the head distances [B, C], so it takes `head_hd`, the
twin of the reference's `_head_hd_xla`: kernel 1
(`kernels.ops.binary_gemm_hd`) once per hidden layer and once for the
head, with sign and repack as PyTorch elementwise ops between them.

A CNN (`image_side=`) takes raw [0,1] pixels [B, side*side], which the
binary input layer (`image_encoding`, thermometer by default) packs
into channel words.  Votes and argmax go through
`kernels.fused_conv.fused_conv_votes` (kernel 4: conv stack, flatten,
FC layers and vote in one launch); the routes that need the head
distances run `kernels.fused_conv.conv_stage_packed` (kernel 4 stopped
after the flatten) and then `head_hd`.  Every noiseless path is
bit-exact equal to the JAX reference.

Silicon mode: `compile_pipeline(folded, cfg, noise=SILICON)` builds the
head's `physics.SearchPhysics` (the pipeline's `physics`): per-pass
effective thresholds are sampled as float32 and only the head compare
changes.  The spec's `noise` axis selects the draw:

  "batch"       — one realization for the whole (bucket-padded) batch
                  from `key=`, a `torch.Generator` on the pipeline's
                  device: exactly what one `physics.sample(key, (Bp,), C)`
                  draws (with `mc_samples=S`, one
                  `physics.sample(key, (S, Bp), C)`).  Votes and argmax
                  launch kernel 3 (MLP) or 4 (CNN) with the samples as
                  its [B, C, P] `thr_samples` operand.
  "per_request" — row i's draws from its own raw uint32 key words
                  `keys[i]` ([B, 2]) through a counter-based generator
                  (`physics.SearchPhysics.sample_keyed`), so results do
                  not depend on how requests are coalesced or padded (the
                  serving determinism contract); pad rows get zero keys.

Monte-Carlo (`mc_samples`), per-request and noisy cumulative specs
compute the head distances once (`head_hd`, after `conv_stage_packed`
for a CNN) and compare them against the samples in PyTorch, as the
reference does in plain XLA.  With `noise=NOISELESS` every noisy spec
is bit-identical to the noiseless votes.  The draws agree with the
reference's in distribution: a torch generator does not reproduce
`jax.random`.

Batch-size bucketing: inputs are zero-padded to the next power-of-two
bucket (floor `min_bucket`), and results are trimmed back; rows are
independent, so results do not depend on the padding, and a serving loop
meets O(log B) distinct shapes (`warmup` covers them).

`donate=` is accepted and has no effect: the reference documents that
donation never changes results and that a backend which cannot reuse the
buffer ignores it; the port's eager calls have no buffer to hand over.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import binarize
from repro_torch.core import keys as _keys
from repro_torch.core.cam import query_with_bias
from repro_torch.core.convnet import is_conv_layer
from repro_torch.core.device_model import AnalogParams, NoiseModel
from repro_torch.core.ensemble import CAMEnsembleHead, EnsembleConfig, build_head
from repro_torch.core.physics import SearchPhysics
from repro_torch.kernels import fused_conv, fused_mlp, ops, pack_input
from repro_torch.spec import InferenceSpec, legacy_entry_spec


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    None (and "cuda" without an index) mean the current CUDA device; with
    no CUDA available that raises rather than running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA card by default and CUDA is "
                "not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def next_bucket(n: int, min_bucket: int = 64,
                max_bucket: Optional[int] = None) -> int:
    """Smallest power-of-two bucket >= n (floored at min_bucket).

    n == 0 is rejected (an empty batch has no bucket), as is exceeding the
    explicit `max_bucket` cap: a serving loop sets the cap to its max batch
    so the set of batch shapes is closed and warmup covers every bucket.
    """
    if n <= 0:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = min_bucket
    while b < n:
        b *= 2
    if max_bucket is not None and b > max_bucket:
        raise ValueError(
            f"batch {n} needs bucket {b} > max_bucket {max_bucket}; "
            "split the batch or recompile with a larger cap"
        )
    return b


def bucket_grid(max_batch: int, min_bucket: int = 64) -> tuple[int, ...]:
    """Every bucket a batch in 1..max_batch can land on (ascending)."""
    out = [min_bucket]
    while out[-1] < max_batch:
        out.append(out[-1] * 2)
    return tuple(out)


def head_hd(x_packed, layer_ws, layer_cs, layer_n_bits, head_rows,
            bias_cells: int) -> torch.Tensor:
    """Packed-domain forward up to the head Hamming distances [B, C].

    The twin of the reference's `_head_hd_xla`: per hidden layer the
    distances from `ops.binary_gemm_hd` (kernel 1 on the card), then
    y = n_bits - 2*HD + C, sign (0 -> +1) and repack; the last hidden
    layer appends the bias drive bits for the head query.
    """
    q = x_packed
    n_layers = len(layer_ws)
    for i, (w, c, n_bits) in enumerate(zip(layer_ws, layer_cs, layer_n_bits)):
        hd = ops.binary_gemm_hd(q, w)
        bits = ((n_bits - 2 * hd) + c[None, :] >= 0).to(torch.uint8)
        if i + 1 == n_layers:  # head query: append bias drive bits
            ones = torch.ones((bits.shape[0], bias_cells), dtype=torch.uint8,
                              device=bits.device)
            bits = torch.cat([bits, ones], dim=-1)
        q = binarize.pack_bits(bits)
        kw_next = (head_rows if i + 1 == n_layers
                   else layer_ws[i + 1]).shape[1]
        if q.shape[1] < kw_next:  # align with the next operand (zero words)
            q = torch.nn.functional.pad(q, (0, kw_next - q.shape[1]))
    return ops.binary_gemm_hd(q, head_rows)


@dataclasses.dataclass(frozen=True)
class ConvFront:
    """The conv stack of a CNN pipeline: the binary input layer and the
    packed conv operands on the pipeline's device."""

    encoding: binarize.InputEncoding
    side: int  # square input image side
    metas: tuple  # fused_conv.ConvMeta per conv layer
    ws: tuple  # per conv layer [c_out, k*k*Cw] int32 tap-major rows
    cs: tuple  # per conv layer [c_out] int32 folded constants
    head_direct: bool  # no FC hidden layer: the flatten feeds the head

    def pack(self, x01: torch.Tensor) -> torch.Tensor:
        """[B, side*side] pixels -> [B, side*side*Cw0] packed words: the
        packing kernel on the card for a thermometer or sign code
        (`pack_input.threshold_words`), else `InputEncoding.pack`."""
        if self.encoding.kind == "bitplane":
            words = self.encoding.pack(x01)
        else:
            words = pack_input.threshold_words(x01, self.encoding)
        return words.reshape(words.shape[0], -1)

    def maps(self, x_packed: torch.Tensor) -> torch.Tensor:
        """[B, side*side*Cw0] -> the NHWC maps [B, side, side, Cw0]."""
        return x_packed.reshape(-1, self.side, self.side,
                                self.metas[0].cw_in)

    def to(self, device) -> "ConvFront":
        """The same stack with its operands on `device`."""
        return dataclasses.replace(
            self, ws=tuple(w.to(device) for w in self.ws),
            cs=tuple(c.to(device) for c in self.cs))


_LEGACY_WARNED: set = set()


def _warn_legacy(name: str) -> None:
    """One DeprecationWarning per legacy entry point per process."""
    if name in _LEGACY_WARNED:
        return
    _LEGACY_WARNED.add(name)
    warnings.warn(
        f"CompiledPipeline.{name}() is a deprecated shim over "
        f"run(x, InferenceSpec(...)) -- see repro_torch.spec."
        "legacy_entry_spec and the README migration table",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclasses.dataclass
class CompiledPipeline:
    """A batch classifier for one deployed binary MLP or CNN on one device.

    The execution surface is `run(x, spec)` / `run_packed(x_packed,
    spec)`: one program is built and cached per distinct `InferenceSpec`
    (`program(spec)`), and all bucketing / padding / trimming lives in
    `run_packed`, once, for every spec.
    """

    head: CAMEnsembleHead
    layer_ws: tuple  # per hidden layer [N_l, Kw_l] int32 packed rows
    layer_cs: tuple  # per hidden layer [N_l] int32 folded constants
    layer_n_bits: tuple  # per hidden layer logical input bits
    n_in: int
    n_classes: int
    device: torch.device
    min_bucket: int
    head_only: bool  # MLP with no hidden layers: input feeds the CAM head
    max_bucket: Optional[int] = None  # serving cap on the bucket grid
    conv: Optional[ConvFront] = None  # the conv stack of a CNN
    physics: Optional[SearchPhysics] = None  # None <=> compiled without noise=
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    # the compiled-request API
    # ------------------------------------------------------------------
    def program(self, spec: InferenceSpec) -> Callable:
        """The program for `spec` (built and cached on first use), on a
        bucket-shaped packed batch: `f(x_packed)` for noise "off",
        `f(x_packed, generator)` for "batch", `f(x_packed, key_words)`
        for "per_request" (`run_packed` dispatches accordingly)."""
        prog = self._programs.get(spec)
        if prog is None:
            if spec.needs_physics and self.physics is None:
                raise ValueError(
                    f"{spec.describe()} needs a silicon-mode pipeline: "
                    "recompile with compile_pipeline(..., noise=<NoiseModel>)"
                )
            prog = self._make_program(spec)
            self._programs[spec] = prog
        return prog

    def run(self, x, spec: InferenceSpec, *, key=None,
            keys=None) -> torch.Tensor:
        """Execute one declarative inference request on a raw batch.

        x    : [B, n_in] ±1 activations for an MLP, [B, side*side] raw
               [0,1] pixels for a CNN (a tensor, on any device, or an
               array); moved to the pipeline's device.
        spec : what to run.
        key  : a `torch.Generator` on the pipeline's device — required iff
               spec.noise == "batch" (each call is one realization).
        keys : per-request raw uint32 key words [B, 2] (numpy, or an
               integer tensor) — required iff spec.noise == "per_request".

        Returns int32 votes/predictions shaped per the spec, trimmed to the
        logical batch, on the pipeline's device.
        """
        with obs.span("run"):
            x = torch.as_tensor(x).to(self.device, torch.float32)
            if x.ndim != 2 or x.shape[1] != self.n_in:
                raise ValueError(f"expected x [B, {self.n_in}], got "
                                 f"{tuple(x.shape)}")
            with obs.span("run.pack"):
                n0 = pack_input.launched()
                x_packed = self._pack_input(x)
                if obs.enabled():
                    obs.count(kernel=pack_input.launched() - n0)
            return self._run_packed(x_packed, spec, key, keys)

    def run_packed(self, x_packed: torch.Tensor, spec: InferenceSpec, *,
                   key=None, keys=None) -> torch.Tensor:
        """`run` for an already-packed input batch [B, Kw0] (int32; a CNN's
        is [B, side*side*Cw0], the channel-packed pixels).  The one place
        bucket padding, key validation and result trimming happen."""
        with obs.span("run"):
            return self._run_packed(x_packed, spec, key, keys)

    def _run_packed(self, x_packed: torch.Tensor, spec: InferenceSpec,
                    key, keys) -> torch.Tensor:
        prog = self.program(spec)  # physics capability check happens here
        with obs.span("run.bucket"):
            x_packed, b = self._bucketed(x_packed)
            rng = self._rng(spec, key, keys, b, x_packed.shape[0])
        if obs.enabled():
            obs.count(rows=b, bucket=x_packed.shape[0])
        with obs.span("run.program"):
            out = prog(x_packed, *rng)
        return self._trim(out, b, spec.batch_axis)

    def _rng(self, spec: InferenceSpec, key, keys, b: int,
             bp: int) -> tuple:
        # the program's randomness argument after the checks: (), a batch
        # generator, or the padded per-row key words
        if spec.needs_keys:
            if key is not None:
                raise ValueError(
                    f"{spec.describe()} takes per-request keys=, not a "
                    "batch-level key="
                )
            if keys is None:
                raise ValueError(
                    f"{spec.describe()} needs per-request keys= "
                    "([B, 2] raw uint32 PRNG keys)"
                )
            return (self._each_keys(keys, b, bp),)
        if spec.needs_key:
            if keys is not None:
                raise ValueError(
                    f"{spec.describe()} takes one batch-level key=, not "
                    "per-request keys="
                )
            if key is None:
                raise ValueError(
                    f"{spec.describe()} needs an explicit key= (each call "
                    "is one silicon realization)"
                )
            return (self._generator(key),)
        if key is not None or keys is not None:
            raise ValueError(
                f'{spec.describe()} is deterministic (noise="off"): '
                "it accepts neither key= nor keys="
            )
        return ()

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    def _votes(self, x_packed: torch.Tensor,
               thr_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the kernel-eligible vote producer: kernel 3 or 4, one [B, C] block
        head, conv = self.head, self.conv
        if conv is not None:
            return fused_conv.fused_conv_votes(
                conv.maps(x_packed), conv.ws, conv.cs, conv.metas,
                self.layer_ws, self.layer_cs, self.layer_n_bits,
                head.cam.rows_packed, head.thresholds,
                bias_cells=head.bias_cells, head_direct=conv.head_direct,
                thr_samples=thr_samples,
            )
        return fused_mlp.fused_mlp_votes(
            x_packed, self.layer_ws, self.layer_cs, self.layer_n_bits,
            head.cam.rows_packed, head.thresholds,
            bias_cells=head.bias_cells, thr_samples=thr_samples,
        )

    def _head_distances(self, x_packed: torch.Tensor) -> torch.Tensor:
        # [B, C] int32: the one quantity every HD-once route compares
        with obs.span("head_distances"):
            conv = self.conv
            if conv is not None:  # the flattened conv features, then FC/head
                x_packed = fused_conv.conv_stage_packed(
                    conv.maps(x_packed), conv.ws, conv.cs, conv.metas,
                    bias_cells=self.head.bias_cells if conv.head_direct else 0,
                    kw_q=(self.layer_ws[0] if self.layer_ws
                          else self.head.cam.rows_packed).shape[1])
            return head_hd(x_packed, self.layer_ws, self.layer_cs,
                           self.layer_n_bits, self.head.cam.rows_packed,
                           self.head.bias_cells)

    def _staircase(self, x_packed: torch.Tensor) -> torch.Tensor:
        # the exact noiseless staircase: per-pass match indicators of the
        # deterministic compare, summed cumulatively over passes
        hd = self._head_distances(x_packed)
        thr = self.head.thresholds
        if thr.is_floating_point():
            hd = hd.to(torch.float32)
        per = hd[None, :, :] <= thr[:, None, None]
        return torch.cumsum(per, dim=0, dtype=torch.int32)

    def _votes_batch(self, x_packed: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
        # one batch draw [P, Bp, C] -> the kernel's [Bp, C, P] operand
        t = self.physics.sample(gen, (x_packed.shape[0],), self.n_classes)
        return self._votes(x_packed,
                           thr_samples=t.movedim(0, -1).contiguous())

    def _make_program(self, spec: InferenceSpec) -> Callable:
        phys, n_cls, mc = self.physics, self.n_classes, spec.mc_samples

        def compare(x_packed, t):  # HD once against [P, ..., Bp, C] samples
            hd = self._head_distances(x_packed).to(torch.float32)
            return hd <= t

        if spec.cumulative:
            if spec.noise == "off":
                return self._staircase

            def fn(x_packed, gen):
                t = phys.sample(gen, (x_packed.shape[0],), n_cls)
                return torch.cumsum(compare(x_packed, t), dim=0,
                                    dtype=torch.int32)
            return fn
        if spec.noise == "off":
            fn = self._votes
        elif spec.noise == "batch" and mc is None:
            fn = self._votes_batch
        else:
            def fn(x_packed, rng):
                if spec.noise == "batch":  # S realizations, one draw
                    t = phys.sample(rng, (mc, x_packed.shape[0]), n_cls)
                else:  # [P, S, Bp, C] from each row's own key
                    t = phys.sample_keyed(rng, n_cls, mc or 1)
                out = compare(x_packed, t).sum(0, dtype=torch.int32)
                if mc is None:
                    return out[0]
                if spec.reduction == "sum":
                    return out.sum(0, dtype=torch.int32)
                return out  # [S, Bp, C]
        if spec.reduction == "argmax":
            base = fn

            def fn(x_packed, *rng):
                return torch.argmax(base(x_packed, *rng), dim=-1).to(
                    torch.int32)
        return fn

    # ------------------------------------------------------------------
    # shared glue (packing / bucketing / trimming)
    # ------------------------------------------------------------------
    def _pack_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            return self.conv.pack(x)
        if self.head_only:
            return query_with_bias(x, self.head.bias_cells)
        return pack_input.sign_words(x)

    def _bucketed(self, x_packed: torch.Tensor):
        b = x_packed.shape[0]
        bp = next_bucket(b, self.min_bucket, self.max_bucket)
        if bp != b:
            x_packed = torch.nn.functional.pad(x_packed, (0, 0, 0, bp - b))
        return x_packed, b

    @staticmethod
    def _trim(out: torch.Tensor, b: int, axis: int) -> torch.Tensor:
        if out.shape[axis] == b:
            return out
        return out[:b] if axis == 0 else out[:, :b]

    def _generator(self, key) -> torch.Generator:
        if not isinstance(key, torch.Generator):
            raise TypeError(
                "key= must be a torch.Generator on the pipeline's device "
                f"({self.device}), got {type(key).__name__}"
            )
        dev = torch.device(key.device)
        if dev.type != self.device.type or (
                dev.type == "cuda"
                and (dev.index or 0) != (self.device.index or 0)):
            raise ValueError(f"key= is a generator on {dev}; the pipeline "
                             f"runs on {self.device}")
        return key

    def _each_keys(self, keys, b: int, bp: int) -> torch.Tensor:
        words = _keys.as_key_words(keys, self.device)
        if words.ndim != 2 or words.shape[0] != b or words.shape[1] != 2:
            raise ValueError(
                f"keys must be [B, 2] raw uint32 PRNG keys with B == batch "
                f"({b}), got shape {tuple(words.shape)}"
            )
        if bp != b:  # pad rows get (valid) zero keys; results are sliced
            words = torch.nn.functional.pad(words, (0, 0, 0, bp - b))
        return words

    def buckets_for(self, max_batch: int) -> tuple[int, ...]:
        """The bucket grid batches 1..max_batch dispatch into."""
        return bucket_grid(max_batch, self.min_bucket)

    def default_warmup_specs(self, mc_samples: Optional[int] = None
                             ) -> tuple[InferenceSpec, ...]:
        """Every spec this pipeline supports out of the box: the plain
        votes, plus for a silicon-mode pipeline the batch-draw and
        per-request programs, and the Monte-Carlo family when
        `mc_samples` is given."""
        if self.physics is None:
            return (InferenceSpec(),)
        specs = [InferenceSpec(), InferenceSpec(noise="batch"),
                 InferenceSpec(noise="per_request")]
        if mc_samples:
            specs += [
                InferenceSpec(noise="batch", mc_samples=mc_samples),
                InferenceSpec(noise="per_request", mc_samples=mc_samples),
                InferenceSpec(noise="per_request", mc_samples=mc_samples,
                              reduction="sum"),
            ]
        return tuple(specs)

    #: legacy entry names accepted by warmup(entries=) (deprecated --
    #: pass specs= instead; see repro_torch.spec.legacy_entry_spec)
    WARMUP_ENTRIES = ("votes", "votes_noisy", "votes_each", "votes_mc",
                      "votes_mc_each", "votes_mc_each_sum")

    def warmup(self, max_batch: int, *,
               specs: Optional[Sequence[InferenceSpec]] = None,
               key: Optional[torch.Generator] = None,
               mc_samples: Optional[int] = None,
               entries: Optional[Sequence[str]] = None
               ) -> dict[tuple[InferenceSpec, int], float]:
        """Run one dummy batch per (spec, bucket) a serving loop can meet.

        The first call builds the CUDA kernels (from source, once per
        source hash) and loads them, and the caching allocator sizes its
        blocks, so none of that lands in served latencies.  Returns
        {(spec, bucket): seconds}, each ended by a device synchronise.
        specs defaults to `default_warmup_specs(mc_samples)`.  The dummy
        batches are all ones (±1 activations for an MLP, full-intensity
        pixels for a CNN); batch draws come from `key` (default a
        generator seeded 0), per-request keys are (0, row).  `entries`:
        DEPRECATED legacy entry names, translated through
        `spec.legacy_entry_spec` (the `votes_mc*` ones with
        `mc_samples`); mutually exclusive with specs.
        """
        if entries is not None:
            if specs is not None:
                raise ValueError("pass specs= or legacy entries=, not both")
            _warn_legacy("warmup(entries=)")
            unknown = set(entries) - set(self.WARMUP_ENTRIES)
            if unknown:
                raise ValueError(f"unknown warmup entries {sorted(unknown)}")
            specs = tuple(
                legacy_entry_spec(
                    e, mc_samples if e.startswith("votes_mc") else None)
                for e in entries)
        specs = self.default_warmup_specs(mc_samples) if specs is None \
            else specs
        for spec in specs:  # capability check before any work
            if spec.needs_physics and self.physics is None:
                raise ValueError(
                    f"warmup of {spec.describe()} needs a silicon-mode "
                    "pipeline: recompile with compile_pipeline(..., "
                    "noise=<NoiseModel>)"
                )
        gen = key if key is not None else \
            torch.Generator(self.device).manual_seed(0)
        times: dict[tuple[InferenceSpec, int], float] = {}
        for b in self.buckets_for(max_batch):
            x = torch.ones((b, self.n_in), dtype=torch.float32,
                           device=self.device)
            ks = torch.stack([torch.zeros(b, dtype=torch.int64),
                              torch.arange(b, dtype=torch.int64)], dim=1)
            for spec in specs:
                t0 = time.perf_counter()
                self.run(x, spec, key=gen if spec.needs_key else None,
                         keys=ks if spec.needs_keys else None)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                times[(spec, b)] = time.perf_counter() - t0
        return times

    # ------------------------------------------------------------------
    # DEPRECATED legacy entry points -- thin shims over run()
    # ------------------------------------------------------------------
    def votes(self, x_pm1, key: Optional[torch.Generator] = None):
        """DEPRECATED shim: `run(x, InferenceSpec())`, or with `key` (a
        generator) one batch-level silicon draw (`noise="batch"`)."""
        _warn_legacy("votes")
        if key is None:
            return self.run(x_pm1, InferenceSpec())
        return self.run(x_pm1, InferenceSpec(noise="batch"), key=key)

    def votes_packed(self, x_packed: torch.Tensor,
                     key: Optional[torch.Generator] = None) -> torch.Tensor:
        """DEPRECATED shim: `run_packed` with the `votes` specs."""
        _warn_legacy("votes_packed")
        if key is None:
            return self.run_packed(x_packed, InferenceSpec())
        return self.run_packed(x_packed, InferenceSpec(noise="batch"),
                               key=key)

    def votes_mc(self, x_pm1, key: torch.Generator,
                 n_samples: int) -> torch.Tensor:
        """DEPRECATED shim: `InferenceSpec(noise="batch", mc_samples=S)`
        -> [S, B, C] Monte-Carlo silicon votes (HD computed once)."""
        _warn_legacy("votes_mc")
        return self.run(x_pm1, InferenceSpec(noise="batch",
                                             mc_samples=int(n_samples)),
                        key=key)

    def votes_each(self, x_pm1, keys) -> torch.Tensor:
        """DEPRECATED shim: `InferenceSpec(noise="per_request")`, row i
        drawn from its own key words keys[i]."""
        _warn_legacy("votes_each")
        return self.run(x_pm1, InferenceSpec(noise="per_request"),
                        keys=keys)

    def votes_mc_each(self, x_pm1, keys, n_samples: int) -> torch.Tensor:
        """DEPRECATED shim: `InferenceSpec(noise="per_request",
        mc_samples=S)` -> [S, B, C]."""
        _warn_legacy("votes_mc_each")
        return self.run(x_pm1, InferenceSpec(noise="per_request",
                                             mc_samples=int(n_samples)),
                        keys=keys)

    def votes_mc_each_sum(self, x_pm1, keys, n_samples: int) -> torch.Tensor:
        """DEPRECATED shim: the per-request MC spec with
        reduction="sum"."""
        _warn_legacy("votes_mc_each_sum")
        return self.run(x_pm1, InferenceSpec(noise="per_request",
                                             mc_samples=int(n_samples),
                                             reduction="sum"),
                        keys=keys)

    def predict_each(self, x_pm1, keys) -> torch.Tensor:
        """DEPRECATED shim: `InferenceSpec(noise="per_request",
        reduction="argmax")`."""
        _warn_legacy("predict_each")
        return self.run(x_pm1, InferenceSpec(noise="per_request",
                                             reduction="argmax"),
                        keys=keys)

    def cum_votes(self, x_pm1,
                  key: Optional[torch.Generator] = None) -> torch.Tensor:
        """DEPRECATED shim: per-pass cumulative votes [P, B, C].

        key given -> `InferenceSpec(noise="batch", cumulative=True)`, one
        silicon realization's staircase; key None ->
        `InferenceSpec(cumulative=True)`, the exact noiseless staircase.
        A noise-compiled pipeline must be given a key (each call is one
        silicon realization)."""
        _warn_legacy("cum_votes")
        if key is None:
            if self.physics is not None and not self.physics.is_noiseless:
                raise ValueError(
                    "cum_votes on a noise-compiled pipeline needs an "
                    "explicit key (each call is one silicon realization); "
                    "for the deterministic staircase run the explicit "
                    'spec InferenceSpec(noise="off", cumulative=True) on '
                    "a noiseless pipeline"
                )
            return self.run(x_pm1, InferenceSpec(cumulative=True))
        return self.run(x_pm1, InferenceSpec(noise="batch", cumulative=True),
                        key=key)

    def predict(self, x_pm1,
                key: Optional[torch.Generator] = None) -> torch.Tensor:
        """DEPRECATED shim: `InferenceSpec(reduction="argmax")` (with
        `key`, one batch-level silicon draw)."""
        _warn_legacy("predict")
        return self._predict(x_pm1, key)

    def __call__(self, x_pm1,
                 key: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sugar for the deprecated `predict` shim (warns as it does)."""
        _warn_legacy("predict")
        return self._predict(x_pm1, key)

    def _predict(self, x_pm1, key: Optional[torch.Generator]):
        """The body `predict` and `__call__` share."""
        if key is None:
            return self.run(x_pm1, InferenceSpec(reduction="argmax"))
        return self.run(x_pm1, InferenceSpec(noise="batch",
                                             reduction="argmax"), key=key)

    def to(self, device) -> "CompiledPipeline":
        """The same pipeline with every operand on `device` (self if it is
        already there); the program cache starts empty."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return dataclasses.replace(
            self,
            head=self.head.to(dev),
            layer_ws=tuple(w.to(dev) for w in self.layer_ws),
            layer_cs=tuple(c.to(dev) for c in self.layer_cs),
            conv=None if self.conv is None else self.conv.to(dev),
            physics=None if self.physics is None else self.physics.to(dev),
            device=dev,
            _programs={},
        )


def compile_pipeline(
    folded: Sequence,
    ens_cfg: EnsembleConfig | None = None,
    *,
    min_bucket: int = 64,
    max_bucket: int | None = None,
    device=None,
    noise: NoiseModel | None = None,
    params: AnalogParams | None = None,
    donate: bool = False,
    image_side: int | None = None,
    image_encoding: binarize.InputEncoding | None = None,
) -> CompiledPipeline:
    """Compile a folded binary MLP or CNN + ensemble head into a batch
    classifier.

    folded  : `bnn.fold` output (or any layers with `.weights_pm1` [out,
              in] ±1 and `.c` [out]) — hidden layers + the output layer.
              May start with a prefix of conv layers
              (`convnet.FoldedConvLayer`: [c_out, k, k, c_in] filters,
              `.c`, `.stride`; `convnet.fold_cnn` output): the pipeline
              then runs the end-to-end binary CNN and takes raw [0,1]
              pixels [B, image_side**2].
    ens_cfg : Algorithm-1 config (thresholds / bias cells); default paper's.
    device  : None -> the CUDA card (raises without CUDA); "cpu" runs the
              kernels' plain versions.
    max_bucket : optional cap on the bucket grid (see next_bucket).
    noise   : optional `device_model.NoiseModel` — enables the silicon
              specs (noise="batch"/"per_request", Monte-Carlo, noisy
              cumulative) through `physics.SearchPhysics.for_head` of the
              head's schedule; `params` overrides the AnalogParams.
              noise=None keeps the pipeline noiseless-only.
    image_side : required for conv graphs — the square input image side.
              Rejected for MLP graphs.
    image_encoding : the binary input layer of a conv graph
              (`binarize.InputEncoding`); its width must equal the first
              conv layer's c_in.  Default: thermometer of that width.

    donate  : accepted for the reference's signature; no effect (the
              reference's backends that cannot reuse the buffer ignore
              it too, and results never depend on it).
    """
    del donate
    ens_cfg = ens_cfg or EnsembleConfig()
    if len(folded) < 1:
        raise ValueError("need at least the output layer")
    rest = list(folded)
    conv_layers = []
    while rest and is_conv_layer(rest[0]):
        conv_layers.append(rest.pop(0))
    if any(is_conv_layer(l) for l in rest):
        raise ValueError("conv layers must form a prefix of `folded`")
    if not rest:
        raise ValueError("need an output FC layer after the conv stack")
    if conv_layers and image_side is None:
        raise ValueError("conv graphs need image_side=")
    if not conv_layers and (image_side is not None
                            or image_encoding is not None):
        raise ValueError("image_side/image_encoding are conv-only options")
    dev = resolve_device(device)

    hidden, out_layer = rest[:-1], rest[-1]
    head = build_head(out_layer, ens_cfg)
    # the knob-schedule inversion runs on the host, then moves
    phys = (None if noise is None
            else SearchPhysics.for_head(head, noise, params).to(dev))
    head = head.to(dev)
    w_bits = [(np.asarray(l.weights_pm1) > 0).astype(np.uint8)
              for l in hidden]
    layer_ws = [binarize.words_to_torch(binarize.np_pack_bits(b), dev)
                for b in w_bits]
    layer_cs = tuple(
        torch.as_tensor(np.asarray(l.c), dtype=torch.int32).to(dev)
        for l in hidden
    )
    n_in = int(np.shape((hidden[0] if hidden else out_layer).weights_pm1)[1])
    conv = None
    if conv_layers:
        enc = image_encoding or binarize.InputEncoding(
            "thermometer", conv_layers[0].c_in
        )
        if enc.width != conv_layers[0].c_in:
            raise ValueError(
                f"encoding width {enc.width} != first conv c_in "
                f"{conv_layers[0].c_in}"
            )
        metas = fused_conv.conv_metas_for(conv_layers, image_side)
        n_pos, c_f = metas[-1].out_side ** 2, metas[-1].c_out
        if n_in != n_pos * c_f:
            raise ValueError(
                f"first FC layer n_in {n_in} != flattened conv features "
                f"{n_pos}*{c_f}"
            )
        if not hidden and c_f % binarize.WORD:
            raise ValueError(
                "conv -> head-direct needs last conv c_out % 32 == 0 "
                f"(word-aligned flatten), got {c_f}"
            )
        if hidden:
            # the flatten keeps per-position word padding: the first FC
            # layer's rows are packed with the matching alignment
            layer_ws[0] = fused_conv.pack_fc_rows_positionwise(
                w_bits[0], n_pos, c_f, dev)
        conv = ConvFront(
            encoding=enc, side=image_side, metas=metas,
            ws=tuple(fused_conv.pack_conv_rows(l, dev) for l in conv_layers),
            cs=tuple(torch.as_tensor(np.asarray(l.c), dtype=torch.int32)
                     .to(dev) for l in conv_layers),
            head_direct=not hidden,
        )
        n_in = image_side * image_side
    return CompiledPipeline(
        head=head,
        layer_ws=tuple(layer_ws),
        layer_cs=layer_cs,
        layer_n_bits=tuple(int(np.shape(l.weights_pm1)[1]) for l in hidden),
        n_in=n_in,
        n_classes=head.n_classes,
        device=dev,
        min_bucket=min_bucket,
        head_only=not hidden and conv is None,
        max_bucket=max_bucket,
        conv=conv,
        physics=phys,
    )
