"""Atomic, asynchronous checkpoint directories of array trees (port of
`repro/checkpoint/ckpt.py`).

Layout (one directory per step), the reference's own:

    <root>/step_00000123/
        manifest.json      — step, save wall-time, and per leaf its path,
                             file, shape and dtype
        <leaf-path>.npy    — one file per leaf

A tree is nested dicts and lists (tuples) of arrays: numpy arrays, or
torch tensors on any device, saved from a host copy.  A leaf's path joins
its dict keys and list indices with "/" (dict keys in sorted order, as
`jax.tree_util` flattens them); its file name replaces each "/" with
"__".  A save writes into `.step_XXXXXXXX.tmp-<nonce>/`, syncs it, then
renames it into place, so a crash mid-save never leaves a partial step,
and keeps the last `keep_last` steps.  A directory written by either
package loads in the other.

`AsyncCheckpointer.save_async` copies the tree to host memory when it is
called and writes it on a thread, so training goes on while the files
are written.  `restore` places the leaves on `device=` where the
reference takes device shardings.
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


def _leaf_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaf_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array that nothing else writes: a tensor is
    copied off its device (and a CPU tensor copied too, since `.numpy()`
    shares its memory with the next in-place update)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _rebuild(tree, values: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values["/".join(prefix)]


def save(root, step: int, tree, *, keep_last: int = 3) -> Path:
    """Synchronous atomic save of `tree` as step `step` under `root`.
    Returns the final checkpoint directory."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "leaves": []}
    for name, leaf in _leaf_paths(tree):
        arr = _host_copy(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"path": name, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype)}
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

    `save_async(step, tree)` copies every leaf to host memory before it
    returns (so later in-place updates of the live tensors cannot reach
    the files) and writes the step on a daemon thread; one save is in
    flight at a time.  An error in the writer is raised by the next
    `wait()` (which `save_async` calls first).
    """

    def __init__(self, root, keep_last: int = 3):
        self.root = Path(root)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree) -> None:
        """Snapshot `tree` now; write it as step `step` in the background."""
        self.wait()
        values = {name: _host_copy(leaf) for name, leaf in _leaf_paths(tree)}
        host_tree = _rebuild(tree, values)

        def work():
            try:
                save(self.root, step, host_tree, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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

    Returns (tree, step): numpy leaves, or with `device=` torch tensors
    placed there (the reference's `shardings=` places jax arrays)."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    values = {}
    for name, leaf in _leaf_paths(target_tree):
        entry = by_path.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(d / entry["file"])
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs {expect}"
            )
        values[name] = (arr if device is None
                        else torch.from_numpy(arr).to(device))
    return _rebuild(target_tree, values), manifest["step"]
