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
from torch import nn


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
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _npy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array written to its file and the manifest's dtype:
    bfloat16 (a tensor, or ml_dtypes' in a reference tree) as its uint16
    bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
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
        live.load_state_dict({k: torch.as_tensor(v)
                              for k, v in values.items()})
    elif isinstance(live, dict):
        for k in live:
            live[k] = load_into(live[k], values[k])
    elif isinstance(live, list):
        for i in range(len(live)):
            live[i] = load_into(live[i], values[i])
    elif isinstance(live, torch.Tensor):
        with torch.no_grad():
            live.copy_(torch.as_tensor(values))
    else:
        return values
    return live


def save(root, step: int, tree, *, keep_last: int = 3) -> Path:
    """Synchronous atomic save of `tree` as step `step` under `root`.
    Returns the final checkpoint directory."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "leaves": []}
    for name, leaf in leaf_paths(tree):
        arr, dtype = _npy(leaf)
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
        host_tree = snapshot(tree)

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
