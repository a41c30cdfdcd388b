"""Atomic, asynchronous checkpoint directories of array trees (port of
`repro/checkpoint/ckpt.py`).

Layout (one directory per step), the reference's own:

    <root>/step_00000123/
        manifest.json      — step, save wall-time, and per leaf its path,
                             file, shape and dtype
        <leaf-path>.npy    — one file per leaf

A tree is nested dicts and lists (tuples) of arrays: numpy arrays, or
torch tensors on any device, saved from a host copy; a module (an
`nn.Module`, e.g. a train state's `CausalLM`) stands for its
`state_dict()`.  A bfloat16 leaf (numpy has no bfloat16) is stored by
its 16-bit pattern as uint16 with "bfloat16" in the manifest, as the
reference's leaves of that dtype are named.  A leaf's path joins
its dict keys and list indices with "/" (dict keys in sorted order, as
`jax.tree_util` flattens them); its file name replaces each "/" with
"__".  A save writes into `.step_XXXXXXXX.tmp-<nonce>/`, syncs it, then
renames it into place, so a crash mid-save never leaves a partial step,
and keeps the last `keep_last` steps.  A directory written by either
package loads in the other.

`AsyncCheckpointer.save_async` copies the tree to host memory when it is
called and writes it on a thread, so training goes on while the files
are written.  `restore` places the leaves on `device=` where the
reference takes device shardings; `load_into` writes a restored tree
into live tensors and modules in place.

Under a process group of more than one rank (a sharded train state),
every rank takes part in gathering each DTensor leaf whole, rank 0
alone keeps the gathered leaves (another rank drops each at once) and
writes the directory, and every rank meets the others at a
barrier once the step is on disk: `save` before it returns, an
`AsyncCheckpointer` in its next `wait()`.  Every rank reads a restore
(the directory is on a file system they share) and `load_into` cuts
each rank's shard back out of the whole leaf.  The format is the one
above whatever the ranks.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding.rules import MeshPlacement, is_dtensor


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """[(path, leaf)] of a tree, dict keys in sorted order."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaf_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _host_copy(leaf):
    """A leaf as a host copy that nothing else writes: a tensor copied
    off its device into a CPU tensor (a CPU tensor copied too, since it
    shares its memory with the next in-place update), else a numpy
    array."""
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf).to("cpu", copy=True)
    return np.array(leaf)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor detached, a DTensor gathered whole (a collective: every
    rank of its mesh takes part)."""
    t = t.detach()
    return t.full_tensor() if is_dtensor(t) else t


def _npy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array written to its file and the manifest's dtype:
    bfloat16 (a tensor, or ml_dtypes' in a reference tree) as its uint16
    bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _rebuild(tree, values: dict, prefix: tuple = ()):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values["/".join(prefix)]


def snapshot(tree):
    """The tree with every leaf copied to host memory (`_host_copy`), a
    module as its state dict."""
    return _rebuild(tree, {name: _host_copy(leaf)
                           for name, leaf in leaf_paths(tree)})


def load_into(live, values):
    """Write `values` (a tree as `restore` returns it) into the tensors
    of `live` in place: a module through `load_state_dict`, a tensor by
    `copy_`; dicts and lists recursively.  Returns `live`."""
    if isinstance(live, nn.Module):
        if any(is_dtensor(t) for t in live.state_dict().values()):
            state = live.state_dict(keep_vars=True)
            for k, v in values.items():
                load_into(state[k], v)
        else:
            live.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in values.items()})
    elif isinstance(live, dict):
        for k in live:
            live[k] = load_into(live[k], values[k])
    elif isinstance(live, list):
        for i in range(len(live)):
            live[i] = load_into(live[i], values[i])
    elif is_dtensor(live):
        with torch.no_grad():
            live.copy_(MeshPlacement(live.device_mesh, live.placements).put(
                torch.as_tensor(values).to(live.device)))
    elif isinstance(live, torch.Tensor):
        with torch.no_grad():
            live.copy_(torch.as_tensor(values))
    else:
        return values
    return live


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this rank writes checkpoints: rank 0 of the default group
    (the only rank without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    """All ranks meet (a no-op with one rank)."""
    if _ranks() > 1:
        dist.barrier()


def _arrays(tree, copy: bool = False) -> list:
    """[(path, (array, dtype name))] of the leaves to write, on the
    writing rank (of a `snapshot` when `copy`).  Another rank takes part
    in gathering each DTensor leaf and drops it at once, holds nothing,
    and gets []."""
    if not is_writer():
        for _, leaf in leaf_paths(tree):
            if isinstance(leaf, torch.Tensor):
                _whole(leaf)
        return []
    if copy:
        tree = snapshot(tree)
    return [(name, _npy(leaf)) for name, leaf in leaf_paths(tree)]


def save(root, step: int, tree, *, keep_last: int = 3) -> Path:
    """Synchronous atomic save of `tree` as step `step` under `root`:
    every rank gathers the leaves, rank 0 writes, all meet before it
    returns.  Returns the final checkpoint directory."""
    arrays = _arrays(tree)
    final = Path(root) / f"step_{step:08d}"
    if is_writer():
        _write_step(Path(root), step, arrays, keep_last)
    _barrier()
    return final


def _write_step(root: Path, step: int, arrays, keep_last: int) -> Path:
    """Write [(path, (array, dtype name))] as step `step` (atomically)."""
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "leaves": []}
    for name, (arr, dtype) in arrays:
        fname = name.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"path": name, "file": fname, "shape": list(arr.shape),
             "dtype": dtype}
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    fd = os.open(tmp, os.O_RDONLY)  # sync the entries before publishing
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(root, keep_last)
    return final


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread checkpointing.

    `save_async(step, tree)` copies every leaf to host memory on rank 0
    before it returns (so later in-place updates of the live tensors
    cannot reach the files; every rank takes part in gathering a DTensor
    leaf, `_arrays`) and writes the step on a daemon thread of rank 0;
    one save is in flight
    at a time.  `wait()` joins it, meets the other ranks at a barrier,
    and raises the writer's error, if it had one (`save_async` calls it
    first).
    """

    def __init__(self, root, keep_last: int = 3):
        self.root = Path(root)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._pending = False
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree) -> None:
        """Snapshot `tree` now; write it as step `step` in the background."""
        self.wait()
        arrays = _arrays(tree, copy=True)
        self._pending = True
        if not is_writer():
            return

        def work():
            try:
                _write_step(self.root, step, arrays, self.keep_last)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save, meet the other ranks once it is on
        disk, and raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def _prune(root: Path, keep_last: int) -> None:
    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root) -> Optional[int]:
    """The newest step saved under `root`, or None."""
    root = Path(root)
    if not root.exists():
        return None
    steps = sorted(p.name for p in root.glob("step_*") if p.is_dir())
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def restore(root, step: Optional[int], target_tree, device=None):
    """Load step `step` (None: the latest) into the structure of
    `target_tree`, a tree whose leaves are arrays or anything with a
    `.shape` (checked against the file; leaves without one are not).

    Returns (tree, step): numpy leaves (bfloat16 ones as CPU tensors,
    numpy having no bfloat16), or with `device=` torch tensors placed
    there (the reference's `shardings=` places jax arrays).  A module in
    the template comes back as its state dict."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    values = {}
    for name, leaf in leaf_paths(target_tree):
        entry = by_path.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(d / entry["file"])
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs {expect}"
            )
        if entry["dtype"] == "bfloat16":  # uint16 here, |V2 from the reference
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif device is not None:
            arr = torch.from_numpy(arr)
        values[name] = arr if device is None else arr.to(device)
    return _rebuild(target_tree, values), manifest["step"]
