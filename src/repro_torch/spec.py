"""Declarative inference request spec for the compiled PiC-BNN pipeline.

The port's own copy of `repro/spec.py` (pure Python): the same specs
key the same program caches in both packages, and the port's pipeline
runs every one of them, noiseless and silicon.

The paper's deployment contract is ONE search primitive — Algorithm 1
with knob-configured noise.  :class:`InferenceSpec` says *what to run*
as a value, and `CompiledPipeline.run(x, spec, ...)` builds and caches
exactly one program per distinct spec.

The four axes:

    noise      — "off":        deterministic compare (no key accepted)
                 "batch":      ONE silicon draw for the whole batch
                               (`key=`; row realizations depend on batch
                               composition and bucket padding — a
                               measurement-style draw)
                 "per_request":one draw per row from `keys[i]` with
                               batch_shape=() (`keys=`; invariant to how
                               requests are coalesced — the serving
                               determinism contract)
    mc_samples — None: one realization; S >= 1: S Monte-Carlo draws with
                 the Hamming distances computed ONCE (needs a noise
                 source, so `noise != "off"`)
    reduction  — "none":   raw vote counts
                 "sum":    sum over the MC sample axis (requires
                           mc_samples — there is nothing else to sum)
                 "argmax": predicted class per row (single-realization
                           specs only)
    cumulative — per-pass cumulative votes [P, B, C] under one draw
                 (`noise="batch"`), or the exact noiseless staircase
                 (`noise="off"`)

Every future axis (a new noise mode, a new reduction, a new workload)
is a spec field, not a new method.

Output shapes (B = logical batch, C = classes, P = passes, S = samples):

    ===========================  =============
    spec                         run() returns
    ===========================  =============
    reduction="none", no MC      [B, C] int32
    mc_samples=S                 [S, B, C] int32
    mc_samples=S, "sum"          [B, C] int32
    reduction="argmax"           [B] int32
    cumulative=True              [P, B, C] int32
    ===========================  =============

Specs are frozen, hashable values: they key the pipeline's program cache
and the per-(spec, bucket) warmup report.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

NOISE_MODES = ("off", "batch", "per_request")
REDUCTIONS = ("none", "sum", "argmax")


@dataclasses.dataclass(frozen=True)
class InferenceSpec:
    """Declares *what to run* against a compiled pipeline (see module doc).

    Validation happens at construction: an unsupported combination is a
    `ValueError` here, never a silently-wrong program later.  Instances
    are immutable and hashable — `CompiledPipeline` keys its compiled
    program cache on them.
    """

    noise: str = "off"
    mc_samples: Optional[int] = None
    reduction: str = "none"
    cumulative: bool = False

    def __post_init__(self):
        if self.noise not in NOISE_MODES:
            raise ValueError(
                f"spec.noise must be one of {NOISE_MODES}, got "
                f"{self.noise!r}"
            )
        if self.reduction not in REDUCTIONS:
            raise ValueError(
                f"spec.reduction must be one of {REDUCTIONS}, got "
                f"{self.reduction!r}"
            )
        if self.mc_samples is not None:
            if int(self.mc_samples) < 1:
                raise ValueError(
                    f"spec.mc_samples must be >= 1, got {self.mc_samples}"
                )
            object.__setattr__(self, "mc_samples", int(self.mc_samples))
            if self.noise == "off":
                raise ValueError(
                    "mc_samples needs a noise source: Monte-Carlo over a "
                    'deterministic compare is meaningless (noise="off")'
                )
        if self.reduction == "sum" and self.mc_samples is None:
            raise ValueError(
                'reduction="sum" sums over the Monte-Carlo sample axis; '
                "it requires mc_samples"
            )
        if self.reduction == "argmax" and self.mc_samples is not None:
            raise ValueError(
                'reduction="argmax" is single-realization only; for the '
                'MC serving aggregate use reduction="sum" and argmax the '
                "summed votes"
            )
        if self.cumulative:
            if self.mc_samples is not None or self.reduction != "none":
                raise ValueError(
                    "cumulative=True exposes the raw per-pass staircase "
                    "[P, B, C]; it composes with neither mc_samples nor "
                    "a reduction"
                )
            if self.noise == "per_request":
                raise ValueError(
                    'cumulative=True supports noise="off" (the exact '
                    'noiseless staircase) or noise="batch" (one silicon '
                    "realization); there is no per-request cumulative "
                    "entry"
                )

    # -- derived request/response contract ------------------------------
    @property
    def needs_physics(self) -> bool:
        """True when the compiled pipeline must carry a SearchPhysics."""
        return self.noise != "off"

    @property
    def needs_key(self) -> bool:
        """True when run() requires the batch-level `key=` operand."""
        return self.noise == "batch"

    @property
    def needs_keys(self) -> bool:
        """True when run() requires the per-request `keys=` operand."""
        return self.noise == "per_request"

    @property
    def batch_axis(self) -> int:
        """Axis of the program output that carries the logical batch.

        0 for [B, C] / [B] outputs; 1 when a samples or passes axis
        leads ([S, B, C] Monte-Carlo, [P, B, C] cumulative).  This is
        what lets `run()` centralize the bucket-padding trim for every
        spec.
        """
        if self.cumulative:
            return 1
        if self.mc_samples is not None and self.reduction == "none":
            return 1
        return 0

    def describe(self) -> str:
        """Compact human-readable tag (used in warmup/serving reports)."""
        parts = [f"noise={self.noise}"]
        if self.mc_samples is not None:
            parts.append(f"mc={self.mc_samples}")
        if self.reduction != "none":
            parts.append(self.reduction)
        if self.cumulative:
            parts.append("cumulative")
        return "spec(" + ",".join(parts) + ")"


#: common request shapes, by name (also the shims' targets)
VOTES = InferenceSpec()
PREDICT = InferenceSpec(reduction="argmax")
CUM_VOTES = InferenceSpec(cumulative=True)


def legacy_entry_spec(name: str,
                      mc_samples: Optional[int] = None) -> InferenceSpec:
    """The `InferenceSpec` equivalent of a legacy entry-point name.

    The eight-method family collapses onto the spec axes as follows
    (`predict`/`predict_each` are the argmax reductions of `votes` /
    `votes_each`):

        votes             -> InferenceSpec()
        votes_noisy       -> InferenceSpec(noise="batch")        # votes(key=)
        votes_each        -> InferenceSpec(noise="per_request")
        votes_mc          -> InferenceSpec(noise="batch", mc_samples=S)
        votes_mc_each     -> InferenceSpec(noise="per_request", mc_samples=S)
        votes_mc_each_sum -> ... mc_samples=S, reduction="sum"
        cum_votes         -> InferenceSpec(noise="batch", cumulative=True)
        predict           -> InferenceSpec(reduction="argmax")
        predict_each      -> InferenceSpec(noise="per_request",
                                           reduction="argmax")

    `mc_samples` is required for the `votes_mc*` names and rejected
    otherwise.  The reference's deprecated warmup `entries=` translation
    uses it; the port carries it so both packages map the names alike.
    """
    table = {
        "votes": dict(),
        "votes_noisy": dict(noise="batch"),
        "votes_each": dict(noise="per_request"),
        "votes_mc": dict(noise="batch", mc=True),
        "votes_mc_each": dict(noise="per_request", mc=True),
        "votes_mc_each_sum": dict(noise="per_request", mc=True,
                                  reduction="sum"),
        "cum_votes": dict(noise="batch", cumulative=True),
        "predict": dict(reduction="argmax"),
        "predict_each": dict(noise="per_request", reduction="argmax"),
    }
    entry = table.get(name)
    if entry is None:
        raise ValueError(
            f"unknown legacy entry {name!r}; known: {sorted(table)}"
        )
    wants_mc = entry.pop("mc", False)
    if wants_mc and mc_samples is None:
        raise ValueError(f"legacy entry {name!r} needs mc_samples=")
    if not wants_mc and mc_samples is not None:
        raise ValueError(f"legacy entry {name!r} takes no mc_samples")
    return InferenceSpec(
        noise=entry.get("noise", "off"),
        mc_samples=mc_samples if wants_mc else None,
        reduction=entry.get("reduction", "none"),
        cumulative=entry.get("cumulative", False),
    )
