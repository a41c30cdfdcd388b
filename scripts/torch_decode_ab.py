"""Decode ms a token of the LM serving path, for comparing two trees.

    python scripts/torch_decode_ab.py [--src DIR] [--label NAME] [--reps 3]

Imports `repro_torch` from `--src` (default: this checkout's `src/`),
builds its kernels, and times `Engine.generate` on `chip_smoke.py`
phase 7's workload (8 requests of 16 prompt tokens, 16 new tokens each,
in batches of 4) for llama3.2-1b at full width and depth three ways:
plain, +binary-ffn (BitLinear FFN on kernel 1) and +cam-head (the CAM
decode head on kernel 2).  Each model is generated once untimed, then
`--reps` times; each time gives the mean of its batches' decode ms over
the 15 decode steps.  Then the host time of one BitLinear projection
at the decode shape (+binary-ffn's first w_gate, x [4, 1, 2048] bf16), of its sign bits
and of its kernel-1 call alone, each the mean µs of 2,000 calls
(`--reps` times).  Prints the card's name and power limit, then one line
`DECODE-AB {"label": ..., "decode_ms": {model: [ms, ...]},
"bitlinear_us": {part: [µs, ...]}}`.

To compare a commit with the working tree on one card, unpack the
commit into a directory that `.gitignore` lists and run the trees in
turn, parent, change, change, parent, each in a process of its own:

    git archive HEAD | tar -x -C ab/parent
    for t in ab/parent/src src src ab/parent/src; do
        python scripts/torch_decode_ab.py --src $t --label $t; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
REQUESTS, PROMPT, NEW, BATCH = 8, 16, 16, 4
MODELS = ("llama3.2-1b", "llama3.2-1b+binary-ffn", "llama3.2-1b+cam-head")


def call_us(fn, n: int) -> float:
    """Mean wall µs a call of `fn` over n calls after 50 untimed ones
    (host-bound calls: the card keeps up)."""
    with torch.no_grad():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="src")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import configs
    from repro_torch.kernels import _build, ops
    from repro_torch.models import binary_lm
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; repro_torch from {args.src}", flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    out = {}
    for i, name in enumerate(MODELS):
        cfg = configs.get_config(name)
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(i))
        eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, eos_id=-1))
        rng = np.random.default_rng(22)
        prompts = [rng.integers(1, cfg.vocab_size, PROMPT).astype(np.int32)
                   for _ in range(REQUESTS)]

        def requests():
            return [Request(uid=j, prompt=p, max_new_tokens=NEW)
                    for j, p in enumerate(prompts)]

        eng.generate(requests())
        ms = []
        for _ in range(args.reps):
            torch.cuda.synchronize(dev)
            res = eng.generate(requests())
            torch.cuda.synchronize(dev)
            ms.append(float(np.mean([r.decode_ms / (NEW - 1)
                                     for r in res[::BATCH]])))
        out[name] = ms
        print(f"  {name}: decode ms/token {ms}", flush=True)
        if cfg.binary_ffn:
            ffn = params.blocks[0].sub0.ffn
            x = torch.randn((BATCH, 1, cfg.d_model), device=dev,
                            dtype=torch.bfloat16)
            rows = binary_lm.bitlinear_weights(ffn, "w_gate")[0]
            q = binary_lm.sign_bits(x.reshape(BATCH, -1))
            calls = {
                "projection": lambda: binary_lm._bit_matmul_packed(
                    ffn, "w_gate", x),
                "sign_bits": lambda: binary_lm.sign_bits(
                    x.reshape(BATCH, -1)),
                "kernel1": lambda: ops.binary_gemm_hd(q, rows)}
            us = {k: [call_us(f, 2000) for _ in range(args.reps)]
                  for k, f in calls.items()}
            print(f"  BitLinear w_gate, µs a call: {us}", flush=True)
        del eng, params
        torch.cuda.empty_cache()
    print("DECODE-AB " + json.dumps({"label": args.label, "card": smi,
                                     "time": time.time(), "decode_ms": out,
                                     "bitlinear_us": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
