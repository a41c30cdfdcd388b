"""Training launcher (port of `repro/launch/train.py`).

Wires together: config registry -> data pipeline -> train step ->
fault-tolerant supervisor (checkpoint / restart / straggler monitor).
Without --model-parallel one device holds the whole model.  With
--model-parallel N the state lives on a (world/N, N) (data, model)
DeviceMesh over the process group's ranks (one card each; a single
process starts a group of one): `ft.state_shardings` under TRAIN_RULES
places the parameters, moments and masters as DTensors, and every step
runs under `use_rules(rules, mesh)`.

Usage (on the CUDA card unless --device says otherwise):
  python -m repro_torch.launch.train --arch llama3.2-1b+smoke --steps 20
  python -m repro_torch.launch.train --arch custom-100m --steps 300 \\
      --batch 8 --seq 512 --ckpt-dir /path/to/run1
  python -m repro_torch.launch.train --arch llama3.2-1b+smoke --device cpu
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch llama3.2-1b+smoke --model-parallel 2
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import DataConfig, embeds_stream, synthetic_stream
from repro_torch.ft import (Supervisor, SupervisorConfig, reshard_state,
                            state_shardings)
from repro_torch.launch.mesh import group_scope, host_mesh, validate_mesh
from repro_torch.sharding import TRAIN_RULES, use_rules
from repro_torch.sharding.rules import is_dtensor
from repro_torch.train import TrainConfig, init_train_state
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_train_step


def custom_100m() -> ModelConfig:
    """~100M-parameter llama-style model for the end-to-end example."""
    return ModelConfig(
        name="custom-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab_size=32000,
        mlp_act="swiglu",
        norm="rmsnorm",
        remat="none",
        dtype="float32",
    )


def get_cfg(name: str) -> ModelConfig:
    if name == "custom-100m":
        return custom_100m()
    return configs.get_config(name)


def make_batch_iter(cfg: ModelConfig, batch: int, seq: int, start: int):
    dcfg = DataConfig(batch=batch, seq_len=seq, vocab_size=cfg.vocab_size)
    it = (
        embeds_stream(dcfg, cfg.d_model)
        if cfg.embeds_input
        else synthetic_stream(dcfg)
    )
    # fast-forward for deterministic restart (synthetic streams are
    # seeded per-step, so skipping is O(steps) cheap host work)
    for _ in range(start):
        next(it)
    return it


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="custom-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="train on a (data, model) mesh with this many "
                    "ranks along 'model' (default: no mesh)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run(argv=None, *, cfg: ModelConfig | None = None,
        opt: OptimizerConfig | None = None) -> dict:
    """The launcher's run: {"losses", "step_s" (each step's wall time,
    ending in a synchronize), "state" (the trained state), "cfg",
    "tcfg"}; `main` returns the losses.

    A caller may pass `cfg` in place of --arch's (a cut the registry does
    not name) and `opt` in place of --lr's optimizer settings."""
    args = parse_args(argv)
    with group_scope():
        return _run(args, get_cfg(args.arch) if cfg is None else cfg,
                    OptimizerConfig(lr=args.lr) if opt is None else opt)


def _run(args, cfg: ModelConfig, opt: OptimizerConfig) -> dict:
    mesh, rules, dev = host_mesh(args.model_parallel, args.device,
                                 TRAIN_RULES)
    if mesh is not None and args.ckpt_dir and dist.get_world_size() > 1:
        raise ValueError("--ckpt-dir with more than one rank: every rank "
                         "would write the same checkpoint files")
    tcfg = TrainConfig(
        opt=opt,
        microbatches=args.microbatches,
    )
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    if mesh is not None:
        state = reshard_state(state, state_shardings(cfg, mesh, rules,
                                                     state))
    step_fn = make_train_step(cfg, tcfg)

    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={dev} dtype={cfg.dtype} remat={cfg.remat}"
          + (f" mesh={validate_mesh(mesh)['axes']}" if mesh is not None
             else ""))

    losses, step_s = [], []

    def logged_step(state, batch):
        t0 = time.perf_counter()
        with use_rules(rules, mesh):
            new_state, metrics = step_fn(state, batch)
        losses.append(float(_whole(metrics["loss"])))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        step = len(losses)
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(_whole(metrics['grad_norm'])):.3f} "
                  f"{step_s[-1] * 1e3:.1f} ms")
        return new_state, metrics

    if args.ckpt_dir:
        sup = Supervisor(
            SupervisorConfig(
                ckpt_dir=Path(args.ckpt_dir),
                ckpt_every=args.ckpt_every,
            ),
            logged_step,
            lambda start: make_batch_iter(cfg, args.batch, args.seq, start),
            state_template=state,
        )
        state = sup.run(state, args.steps)
    else:
        it = make_batch_iter(cfg, args.batch, args.seq, 0)
        for _ in range(args.steps):
            state, _ = logged_step(state, next(it))

    first = np.mean(losses[: max(len(losses) // 10, 1)])
    last = np.mean(losses[-max(len(losses) // 10, 1):])
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return {"losses": losses, "step_s": step_s, "state": state, "cfg": cfg,
            "tcfg": tcfg}


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's replicated value)."""
    return t.full_tensor() if is_dtensor(t) else t


def main(argv=None):
    return run(argv)["losses"]


if __name__ == "__main__":
    main()
