"""Atomic checkpoint directories of numpy-leaf trees (port of
`repro/checkpoint/ckpt.py`, its synchronous save and restore).

Layout (one directory per step), the reference's own:

    <root>/step_00000123/
        manifest.json      — step, save wall-time, and per leaf its path,
                             file, shape and dtype
        <leaf-path>.npy    — one file per leaf

A tree is nested dicts and lists (tuples) of arrays.  A leaf's path joins
its dict keys and list indices with "/" (dict keys in sorted order, as
`jax.tree_util` flattens them); its file name replaces each "/" with
"__".  A save writes into `.step_XXXXXXXX.tmp-<nonce>/`, syncs it, then
renames it into place, so a crash mid-save never leaves a partial step,
and keeps the last `keep_last` steps.  A directory written by either
package loads in the other.

The reference's asynchronous checkpointer and its restore onto device
shardings have no use on the port's path yet.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np


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
        arr = np.asarray(leaf)
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


def restore(root, step: Optional[int], template):
    """Load step `step` (None: the latest) into the structure of
    `template`, a tree whose leaves are arrays or anything with a
    `.shape` (checked against the file; leaves without one are not).
    Returns (tree of numpy arrays, step)."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    values = {}
    for name, leaf in _leaf_paths(template):
        entry = by_path.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(d / entry["file"])
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs {expect}"
            )
        values[name] = arr
    return _rebuild(template, values), manifest["step"]
