"""Atomic, async-capable checkpoints in the reference's on-disk format.

Port of ``repro.checkpoint.store``.  A checkpoint is a directory
``step_<n>/`` (8-digit step) holding one ``.npy`` per leaf plus a
``MANIFEST.json`` with the step, each leaf's name, shape and dtype, and the
tree structure.  Leaf names are the reference's ``_leaf_name``: the path of
dict keys and list/tuple indices in jax's flatten order, joined with
``__`` (``0__segments__0__attn__wq``, ``1__m__embed__table``,
``1__count``), so a checkpoint written by either package restores in the
other.  Writes go to ``step_<n>.tmp/`` and are published with one atomic
``rename``: a crash mid-write never leaves a readable but corrupt
checkpoint.  ``restore_checkpoint`` loads onto the device of the caller's
template tree (``like``), leaf by leaf.

``CheckpointManager`` adds retention, ``latest`` and an async writer: the
tree is copied to host memory on the caller's thread (so training may go
on and overwrite its tensors), then written by one background thread;
``wait()`` joins it before the next save.  ``timings`` records each save's
host-copy and write seconds and bytes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util

_MANIFEST = "MANIFEST.json"


def _leaf_name(path: tuple) -> str:
    return "__".join(str(p) for p in path) or "root"


def _treedef_str(t: Any) -> str:
    """jax's ``str(tree_structure(t))`` for dicts, lists, tuples and leaves."""

    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "None" if node is None else "*"

    return f"PyTreeDef({walk(t)})"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any) -> Path:
    """Write ``tree`` under ``directory/step_<step>`` atomically; returns the path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: dict[str, Any] = {"step": step, "leaves": []}
    for path, leaf in tree_util.leaves_with_path(tree):
        name = _leaf_name(path)
        arr = _to_host(leaf)
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    manifest["treedef"] = _treedef_str(tree)
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def restore_checkpoint(directory: str | os.PathLike, step: int, like: Any) -> Any:
    """Load ``step`` into the structure of ``like`` (a tree of tensors): each
    leaf takes its template's dtype and device."""
    final = Path(directory) / f"step_{step:08d}"
    if not (final / _MANIFEST).exists():
        raise FileNotFoundError(f"no checkpoint at {final}")
    values = []
    for path, leaf in tree_util.leaves_with_path(like):
        name = _leaf_name(path)
        arr = np.load(final / f"{name}.npy")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != expected {tuple(leaf.shape)}")
        values.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
    return tree_util.unflatten(like, values)


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.removeprefix("step_")) for p in directory.iterdir()
             if p.is_dir() and p.name.startswith("step_") and (p / _MANIFEST).exists()]
    return max(steps) if steps else None


class CheckpointManager:
    """Retention + async writes on top of save/restore."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3, async_write: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.timings: list[dict] = []  # per save: step, host_copy_s, write_s, bytes

    def save(self, step: int, tree: Any) -> None:
        self.wait()  # at most one in-flight write
        t0 = time.perf_counter()
        host_tree = tree_util.tree_map(_to_host, tree)
        rec = {"step": step, "host_copy_s": time.perf_counter() - t0,
               "bytes": sum(a.nbytes for a in tree_util.leaves(host_tree))}
        self.timings.append(rec)

        def _write():
            try:
                t1 = time.perf_counter()
                save_checkpoint(self.directory, step, host_tree)
                rec["write_s"] = time.perf_counter() - t1
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.removeprefix("step_"))
            for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, step: int, like: Any) -> Any:
        self.wait()
        return restore_checkpoint(self.directory, step, like)
