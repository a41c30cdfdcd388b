"""Mesh construction (port of `repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
over the ranks of the default process group, one card per rank.  Under
`torchrun` (or any launcher that sets RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT) the group spans its processes; a single process with no
group and no such environment starts a group of one on a free local
port, so one card serves the same mesh code.  `group_scope` ends a
group started inside it and leaves one that was there before.
"""

from __future__ import annotations

import contextlib
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device_type: str = "cuda") -> None:
    """The default process group, started if there is none: from the
    launcher's environment when RANK/WORLD_SIZE are set, else a group of
    one on localhost.  NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)


@contextlib.contextmanager
def group_scope():
    """A block that may start the default group (a launcher's run): on
    exit the group is destroyed if there was none on entry, and a
    caller's own group is left as it was."""
    had_group = dist.is_initialized()
    try:
        yield
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of `shape` named `axes` over the world's ranks (their
    product must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device_type)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(data, model) mesh over every rank: model_parallel (capped at the
    world size, as the reference caps it at the device count) along
    'model', the rest along 'data'."""
    if model_parallel < 1:
        raise ValueError(f"--model-parallel must be >= 1, got "
                         f"{model_parallel}")
    ensure_process_group(device_type)
    n = dist.get_world_size()
    mp = min(model_parallel, n)
    if n % mp:
        raise ValueError(f"--model-parallel {mp} does not divide {n} ranks")
    return make_mesh((n // mp, mp), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production shapes: 16x16 (data, model), or
    2x16x16 (pod, data, model).  Needs a process group of 256 (512)
    ranks, one card each."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))
    if world != n:
        raise RuntimeError(
            f"the production mesh {shape} {axes} needs {n} ranks, one card "
            f"each; this run has {world} (start it under torchrun with "
            f"--nnodes/--nproc-per-node giving {n} ranks)")
    return make_mesh(shape, axes, device_type)


def validate_mesh(mesh) -> dict:
    """Shape/axis report used by the dry-run logs."""
    return {
        "axes": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "n_devices": int(mesh.mesh.numel()),
        "platform": "gpu" if mesh.device_type == "cuda" else mesh.device_type,
    }


def host_mesh(model_parallel, device=None, rules=None):
    """A launcher's placement: (mesh, resolved rules, this rank's
    device).  `model_parallel` None means no mesh: (None, None, the
    device).  Else a (data, model) mesh over the process group's ranks,
    started here when there is none (a group of one), on the card (the
    rank's own) unless `device` is the CPU."""
    from repro_torch.pipeline import resolve_device

    if model_parallel is None:
        return None, None, resolve_device(device)
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        resolve_device(None)  # raises without CUDA
    mesh = make_host_mesh(model_parallel, kind)
    dev = (resolve_device(None) if kind == "cuda"
           else torch.device(kind))
    return mesh, rules.resolve(mesh), dev

