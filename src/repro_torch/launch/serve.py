"""Serving launcher: init params, start the batched engine, run a
synthetic request workload, report throughput (port of
`repro/launch/serve.py`).

Usage (on the CUDA card unless --device says otherwise):
  python -m repro_torch.launch.serve --arch llama3.2-1b+smoke --requests 16
  python -m repro_torch.launch.serve --arch llama3.2-1b --cam-head
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.pipeline import resolve_device
from repro_torch.serve.engine import Engine, EngineConfig, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b+smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cam-head", action="store_true",
                    help="use the PiC-BNN CAM-ensemble head for decode")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the sharding layer, which the port "
            "does not have yet; one card serves the whole model")
    name = args.arch + ("+cam-head" if args.cam_head else "")
    cfg = configs.get_config(name)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    engine = Engine(cfg, params, EngineConfig(max_batch=args.batch,
                                              eos_id=-1), device=dev)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(1, cfg.vocab_size,
                                    args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    results = engine.generate(reqs)
    wall = time.time() - t0

    n_tokens = sum(len(r.tokens) for r in results)
    print(f"[serve] arch={cfg.name} requests={len(results)} "
          f"new_tokens={n_tokens} wall={wall:.2f}s "
          f"({n_tokens / wall:.1f} tok/s) device={dev}")
    for r in results[:3]:
        print(f"  uid={r.uid} prefill={r.prefill_ms:.1f}ms "
              f"decode={r.decode_ms:.1f}ms tokens={r.tokens[:8]}...")
    return results


if __name__ == "__main__":
    main()
