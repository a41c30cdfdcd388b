"""Batched LM serving engine: request queue -> prefill -> decode loop
(port of `repro/serve/engine.py`).

Static batching: requests are grouped into generation batches of
`max_batch`, left-padded with `pad_id` to the batch's longest prompt (the
pads sit at positions 0.. and are attended to, as in the reference), run
through one prefill with a cache of prompt + max_new slots, and decoded
step by step, greedily, until every request has met its EOS or its
`max_new_tokens`.  A request's service time ends at its own last token.

The reference's engine feeds its prefill `{"tokens": ...}` only, so an
`embeds_input` architecture cannot be served by it; this engine raises
for one (serve those through `serve.steps` with embeds).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.pipeline import resolve_device
from repro_torch.serve.steps import (greedy_sample, make_decode_step,
                                     make_prefill_step)
from repro_torch.sharding.rules import is_dtensor


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [S] int32 token ids
    max_new_tokens: int = 32
    t_submit: Optional[float] = None  # stamped at generate() if unset


@dataclasses.dataclass
class Result:
    """One generation + per-request timing.

    queue_ms / service_ms / latency_ms are per request: queue = submit ->
    this request's batch started; service = batch start -> this request's
    last token.  prefill_ms / decode_ms are batch-level phase timings
    (every Result of a batch reports the same values).
    """

    uid: int
    tokens: list
    prefill_ms: float  # batch-level: the shared prefill step
    decode_ms: float  # batch-level: the shared decode loop
    queue_ms: float = 0.0
    service_ms: float = 0.0

    @property
    def latency_ms(self) -> float:
        return self.queue_ms + self.service_ms


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 256
    eos_id: int = 0
    greedy: bool = True
    temperature: float = 0.0
    pad_id: int = 0


class Engine:
    """Serves `params` (a `models.model.CausalLM`) under `cfg`.

    `device` None means the CUDA card (raising when there is none); the
    parameters must already live on the engine's device.  With DTensor
    parameters (`models.model.shard_params`), `generate` runs under
    `sharding.use_rules(rules, mesh)` and every rank submits the same
    requests; the logits are gathered whole for sampling.
    """

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 device=None):
        if cfg.embeds_input:
            raise ValueError(
                f"{cfg.name} takes embeddings, and the engine serves token "
                "prompts; drive serve.steps.prefill_step/decode_step with "
                "{'embeds': ...} instead")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params on {params.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self._decode = make_decode_step(cfg, donate=True)

    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        s = max(len(r.prompt) for r in reqs)
        batch = np.full((len(reqs), s), self.ecfg.pad_id, np.int32)
        for i, r in enumerate(reqs):
            batch[i, s - len(r.prompt):] = r.prompt  # left-pad
        return batch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, requests: Iterable[Request]) -> list[Result]:
        reqs = list(requests)
        now = time.perf_counter()
        for r in reqs:  # batch-mode callers get queue time measured from
            if r.t_submit is None:  # entry; streaming callers pre-stamp
                r.t_submit = now
        out: list[Result] = []
        for i in range(0, len(reqs), self.ecfg.max_batch):
            out.extend(self._run_batch(reqs[i:i + self.ecfg.max_batch]))
        return out

    def _next(self, logits: torch.Tensor) -> np.ndarray:
        if is_dtensor(logits):  # sharded logits (a mesh): gathered whole
            logits = logits.full_tensor()
        return greedy_sample(logits).cpu().numpy()

    def _run_batch(self, reqs: list[Request]) -> list[Result]:
        prompts = self._pad_prompts(reqs)
        b, s = prompts.shape
        max_new = max(r.max_new_tokens for r in reqs)
        t0 = time.perf_counter()
        prefill = make_prefill_step(self.cfg, max_len=s + max_new)
        logits, cache = prefill(self.params, {
            "tokens": torch.from_numpy(prompts).to(self.device)})
        self._sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3

        tokens = self._next(logits)
        generated = [[int(t)] for t in tokens]
        done = np.zeros(b, bool)
        # per-request completion stamps: a request's service time ends at
        # ITS last token, not at the end of the batch's decode loop
        t_finish = np.full(b, time.perf_counter())
        for i, r in enumerate(reqs):
            if tokens[i] == self.ecfg.eos_id or r.max_new_tokens <= 1:
                done[i] = True
        t1 = time.perf_counter()
        pos = s
        cur = tokens[:, None]
        for _ in range(max_new - 1 if not done.all() else 0):
            lg, cache = self._decode(
                self.params, cache, torch.from_numpy(cur).to(self.device),
                pos)
            nxt = self._next(lg)
            t_step = time.perf_counter()
            for i in range(b):
                if not done[i]:
                    generated[i].append(int(nxt[i]))
                    if nxt[i] == self.ecfg.eos_id:
                        done[i] = True
                    if len(generated[i]) >= reqs[i].max_new_tokens:
                        done[i] = True
                    t_finish[i] = t_step
            pos += 1
            cur = nxt[:, None]
            if done.all():
                break
        decode_ms = (time.perf_counter() - t1) * 1e3
        return [
            Result(uid=r.uid, tokens=generated[i], prefill_ms=prefill_ms,
                   decode_ms=decode_ms, queue_ms=(t0 - r.t_submit) * 1e3,
                   service_ms=(t_finish[i] - t0) * 1e3)
            for i, r in enumerate(reqs)
        ]
