"""End-to-end deployed-BNN inference pipeline, MLP branch (port of
`repro/pipeline.py`).

`compile_pipeline(folded, ens_cfg)` turns a folded binary MLP (a list of
`bnn.FoldedLayer`) plus an Algorithm-1 ensemble config into a batch
classifier on one device, driven by a declarative request spec
(`repro_torch.spec.InferenceSpec`):

    pipe = compile_pipeline(folded, EnsembleConfig())          # on the card
    votes = pipe.run(x_pm1, InferenceSpec())                    # [B, C] int32
    pred  = pipe.run(x_pm1, InferenceSpec(reduction="argmax"))  # [B] int32
    cum   = pipe.run(x_pm1, InferenceSpec(cumulative=True))     # [P, B, C]

The pipeline runs on the card unless asked otherwise: `device=None`
means CUDA, and without CUDA it raises; pass `device="cpu"` to run the
plain PyTorch versions of the kernels on the CPU.

Votes and argmax go through `kernels.fused_mlp.fused_mlp_votes`: one
launch of kernel 3 per batch, hidden activations resident in shared
memory.  The noiseless cumulative staircase needs the head distances
[B, C], so it takes `head_hd`, the twin of the reference's
`_head_hd_xla`: kernel 1 (`kernels.ops.binary_gemm_hd`) once per hidden
layer and once for the head, with sign and repack as PyTorch elementwise
ops between them.  Both are bit-exact equal to the JAX reference.

Batch-size bucketing: inputs are zero-padded to the next power-of-two
bucket (floor `min_bucket`), and results are trimmed back; rows are
independent, so results do not depend on the padding, and a serving loop
meets O(log B) distinct shapes (`warmup` covers them).

What waits for later slices, and how it fails: the silicon-noise specs
raise ValueError (as the reference does for a pipeline compiled without
noise); `compile_pipeline(noise=...)`, convolutional graphs
(`image_side=`, conv layers) and `donate=` raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import binarize
from repro_torch.core.cam import query_with_bias
from repro_torch.core.ensemble import CAMEnsembleHead, EnsembleConfig, build_head
from repro_torch.kernels import fused_mlp, ops
from repro_torch.spec import InferenceSpec


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


@dataclasses.dataclass
class CompiledPipeline:
    """A batch classifier for one deployed binary MLP on one device.

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
    head_only: bool  # no hidden layers: input feeds the CAM head directly
    max_bucket: Optional[int] = None  # serving cap on the bucket grid
    _programs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    # the compiled-request API
    # ------------------------------------------------------------------
    def program(self, spec: InferenceSpec) -> Callable:
        """The program for `spec` (built and cached on first use):
        `f(x_packed)` for a bucket-shaped packed batch."""
        prog = self._programs.get(spec)
        if prog is None:
            if spec.needs_physics:  # the noise slice brings silicon mode
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

        x    : [B, n_in] ±1 activations (a tensor, on any device, or an
               array); moved to the pipeline's device.
        spec : what to run.  key / keys belong to the noisy specs and are
               rejected here.

        Returns int32 votes/predictions shaped per the spec, trimmed to the
        logical batch, on the pipeline's device.
        """
        x = torch.as_tensor(x).to(self.device, torch.float32)
        if x.ndim != 2 or x.shape[1] != self.n_in:
            raise ValueError(f"expected x [B, {self.n_in}], got "
                             f"{tuple(x.shape)}")
        return self.run_packed(self._pack_input(x), spec, key=key, keys=keys)

    def run_packed(self, x_packed: torch.Tensor, spec: InferenceSpec, *,
                   key=None, keys=None) -> torch.Tensor:
        """`run` for an already-packed input batch [B, Kw0] (int32)."""
        prog = self.program(spec)  # noise capability check happens here
        if key is not None or keys is not None:
            raise ValueError(
                f'{spec.describe()} is deterministic (noise="off"): '
                "it accepts neither key= nor keys="
            )
        x_packed, b = self._bucketed(x_packed)
        return self._trim(prog(x_packed), b, spec.batch_axis)

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    def _votes(self, x_packed: torch.Tensor) -> torch.Tensor:
        return fused_mlp.fused_mlp_votes(
            x_packed, self.layer_ws, self.layer_cs, self.layer_n_bits,
            self.head.cam.rows_packed, self.head.thresholds,
            bias_cells=self.head.bias_cells,
        )

    def _staircase(self, x_packed: torch.Tensor) -> torch.Tensor:
        # the exact noiseless staircase: per-pass match indicators of the
        # deterministic compare, summed cumulatively over passes
        hd = head_hd(x_packed, self.layer_ws, self.layer_cs,
                     self.layer_n_bits, self.head.cam.rows_packed,
                     self.head.bias_cells)
        thr = self.head.thresholds
        if thr.is_floating_point():
            hd = hd.to(torch.float32)
        per = hd[None, :, :] <= thr[:, None, None]
        return torch.cumsum(per, dim=0, dtype=torch.int32)

    def _make_program(self, spec: InferenceSpec) -> Callable:
        if spec.cumulative:
            return self._staircase
        if spec.reduction == "argmax":
            def fn(x_packed):
                return torch.argmax(self._votes(x_packed), dim=-1).to(
                    torch.int32)
            return fn
        return self._votes

    # ------------------------------------------------------------------
    # shared glue (packing / bucketing / trimming)
    # ------------------------------------------------------------------
    def _pack_input(self, x_pm1: torch.Tensor) -> torch.Tensor:
        if self.head_only:
            return query_with_bias(x_pm1, self.head.bias_cells)
        return binarize.pack_pm1(x_pm1)

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

    def buckets_for(self, max_batch: int) -> tuple[int, ...]:
        """The bucket grid batches 1..max_batch dispatch into."""
        return bucket_grid(max_batch, self.min_bucket)

    def warmup(self, max_batch: int, *,
               specs: Optional[Sequence[InferenceSpec]] = None
               ) -> dict[tuple[InferenceSpec, int], float]:
        """Run one dummy batch per (spec, bucket) a serving loop can meet.

        The first call builds the CUDA kernels (from source, once per
        source hash) and loads them, and the caching allocator sizes its
        blocks, so none of that lands in served latencies.  Returns
        {(spec, bucket): seconds}, each ended by a device synchronise.
        specs defaults to the plain vote program.
        """
        specs = (InferenceSpec(),) if specs is None else specs
        for spec in specs:  # capability check before any work
            if spec.needs_physics:
                raise ValueError(
                    f"warmup of {spec.describe()} needs a silicon-mode "
                    "pipeline: recompile with compile_pipeline(..., "
                    "noise=<NoiseModel>)"
                )
        times: dict[tuple[InferenceSpec, int], float] = {}
        for b in self.buckets_for(max_batch):
            x = torch.ones((b, self.n_in), dtype=torch.float32,
                           device=self.device)
            for spec in specs:
                t0 = time.perf_counter()
                self.run(x, spec)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                times[(spec, b)] = time.perf_counter() - t0
        return times

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
    noise=None,
    params=None,
    donate: bool = False,
    image_side: int | None = None,
    image_encoding=None,
) -> CompiledPipeline:
    """Compile a folded binary MLP + ensemble head into a batch classifier.

    folded  : `bnn.fold` output (or any layers with `.weights_pm1` [out,
              in] ±1 and `.c` [out]) — hidden layers + the output layer.
    ens_cfg : Algorithm-1 config (thresholds / bias cells); default paper's.
    device  : None -> the CUDA card (raises without CUDA); "cpu" runs the
              kernels' plain versions.
    max_bucket : optional cap on the bucket grid (see next_bucket).

    noise / params (silicon noise), image_side / image_encoding and conv
    layers (the CNN workload) and donate= raise NotImplementedError.
    """
    if noise is not None or params is not None:
        raise NotImplementedError(
            "compile_pipeline(noise=/params=) waits for the silicon-noise "
            "slice of the port"
        )
    if image_side is not None or image_encoding is not None:
        raise NotImplementedError(
            "convolutional graphs (image_side=/image_encoding=) wait for "
            "the CNN slice of the port"
        )
    if donate:
        raise NotImplementedError("donate= has no counterpart in the port yet")
    ens_cfg = ens_cfg or EnsembleConfig()
    if len(folded) < 1:
        raise ValueError("need at least the output layer")
    if any(np.ndim(l.weights_pm1) != 2 for l in folded):
        raise NotImplementedError(
            "conv layers wait for the CNN slice of the port"
        )
    dev = resolve_device(device)

    hidden, out_layer = list(folded[:-1]), folded[-1]
    head = build_head(out_layer, ens_cfg).to(dev)
    layer_ws = tuple(
        binarize.words_to_torch(binarize.np_pack_bits(
            (np.asarray(l.weights_pm1) > 0).astype(np.uint8)), dev)
        for l in hidden
    )
    layer_cs = tuple(
        torch.as_tensor(np.asarray(l.c), dtype=torch.int32).to(dev)
        for l in hidden
    )
    n_in = int(np.shape((hidden[0] if hidden else out_layer).weights_pm1)[1])
    return CompiledPipeline(
        head=head,
        layer_ws=layer_ws,
        layer_cs=layer_cs,
        layer_n_bits=tuple(int(np.shape(l.weights_pm1)[1]) for l in hidden),
        n_in=n_in,
        n_classes=head.n_classes,
        device=dev,
        min_bucket=min_bucket,
        head_only=not hidden,
        max_bucket=max_bucket,
    )
