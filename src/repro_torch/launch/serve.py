"""Serving launcher: init params, start the batched engine, run a
synthetic request workload, report throughput (port of
`repro/launch/serve.py`).

Usage (on the CUDA card unless --device says otherwise):
  python -m repro_torch.launch.serve --arch llama3.2-1b+smoke --requests 16
  python -m repro_torch.launch.serve --arch llama3.2-1b --cam-head
  python -m repro_torch.launch.serve --arch llama3.2-1b --model-parallel 1
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch llama3.2-1b --model-parallel 2

`--model-parallel N` serves on a (world/N, N) (data, model) DeviceMesh
over the process group's ranks (one card each; a single process starts
a group of one): the parameters become DTensors laid out by
`param_pspecs` under SERVE_RULES, and the engine runs under
`use_rules(rules, mesh)`.  Without it one device holds the whole model.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.launch.mesh import group_scope, host_mesh, validate_mesh
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.sharding import SERVE_RULES, use_rules


def run(argv=None) -> dict:
    """The launcher's run: {"results" (the engine's `Result`s), "params"
    (the served model), "cfg", "mesh" (None without --model-parallel),
    "wall_s"}; `main` returns the results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b+smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cam-head", action="store_true",
                    help="use the PiC-BNN CAM-ensemble head for decode")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="serve on a (data, model) mesh with this many "
                    "ranks along 'model' (default: no mesh)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    name = args.arch + ("+cam-head" if args.cam_head else "")
    cfg = configs.get_config(name)
    with group_scope():
        mesh, rules, dev = host_mesh(args.model_parallel, args.device,
                                     SERVE_RULES)
        rng = np.random.default_rng(0)
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if mesh is not None:
            M.shard_params(params, mesh, rules)
        engine = Engine(cfg, params, EngineConfig(max_batch=args.batch,
                                                  eos_id=-1), device=dev)
        reqs = [
            Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)
        ]
        with use_rules(rules, mesh):
            t0 = time.time()
            results = engine.generate(reqs)
            wall = time.time() - t0

    n_tokens = sum(len(r.tokens) for r in results)
    print(f"[serve] arch={cfg.name} requests={len(results)} "
          f"new_tokens={n_tokens} wall={wall:.2f}s "
          f"({n_tokens / wall:.1f} tok/s) device={dev}"
          + (f" mesh={validate_mesh(mesh)['axes']}" if mesh is not None
             else ""))
    for r in results[:3]:
        print(f"  uid={r.uid} prefill={r.prefill_ms:.1f}ms "
              f"decode={r.decode_ms:.1f}ms tokens={r.tokens[:8]}...")
    return {"results": results, "params": params, "cfg": cfg, "mesh": mesh,
            "wall_s": wall}


def main(argv=None):
    return run(argv)["results"]


if __name__ == "__main__":
    main()
