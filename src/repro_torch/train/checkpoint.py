"""Atomic checkpoints in the reference's on-disk format.

The port of ``repro.train.checkpoint``.  Layout::

    <dir>/step_<N>/
        manifest.json      # tree paths, shapes, dtypes, checksums
        <leaf-id>.npy      # one file per leaf

Writes go to ``step_<N>.tmp`` and are renamed into place only after the
manifest (written last) lands — a crash mid-write never corrupts the
latest checkpoint.  A leaf's path joins its dict keys and list indices
with ``"/"`` (``train.tree``), its file name replaces ``"/"`` by
``"__"``, bf16 is stored as its uint16 bits, and each file's checksum is
the first 16 hex digits of its sha256: the reference's format, so a
checkpoint written by either package is read by the other.  The train
state is saved in the reference's tree (``train.train_step.state_tree``:
the units' parameters stacked on a leading axis).

A checkpoint holds every leaf whole, whatever grid wrote it.  Restore
takes a device and, for a sharded state, the leaves' specs and the grid
(``train.train_step.state_shardings``) where the reference takes
shardings: each leaf is loaded whole on the host, cut to this rank's
block there and moved to the device, so a checkpoint restores onto any
grid.  On a grid of more than one rank every rank gathers the whole
state (a collective) and one rank writes it (``CheckpointManager(...,
write=...)``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import leaves, tree_map_with_path

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]


def _fname(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _digest(fn: str) -> str:
    with open(fn, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, the dtype name the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store the raw bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # keeps a 0-d leaf 0-d


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic save of a tree of tensors (or arrays); returns the final
    directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for path, leaf in leaves(tree):
        arr, dtype_name = _to_numpy(leaf)
        fn = _fname(path)
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][path] = {
            "file": fn,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "sha256_16": _digest(os.path.join(tmp, fn)),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(
    ckpt_dir: str,
    step: int,
    target: Any,
    *,
    device=None,
    verify: bool = True,
    shardings: Any = None,
    grid=None,
) -> Any:
    """Restore into the structure of ``target``, a tree whose leaves have
    a ``shape`` and a torch ``dtype`` (tensors, on any device including
    ``meta``).  Each leaf is cast to its target's dtype and put on
    ``device`` (default: the target leaf's device); with ``shardings``
    (a tree of ``target``'s structure of spec tuples) and ``grid``, only
    this rank's block of it.  Raises ``IOError`` on a checksum mismatch
    (with ``verify``) and ``ValueError`` on a shape mismatch."""
    from repro_torch.dist.partitioning import block_of
    base = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)

    def load(path: str, tgt):
        meta = manifest["leaves"][path]
        fn = os.path.join(base, meta["file"])
        if verify and _digest(fn) != meta["sha256_16"]:
            raise IOError(f"checksum mismatch for {path} in {base}")
        arr = np.load(fn)
        if list(arr.shape) != list(tgt.shape):
            raise ValueError(
                f"shape mismatch for {path}: ckpt {arr.shape} vs target "
                f"{tuple(tgt.shape)}"
            )
        out = _from_numpy(arr, meta["dtype"]).to(tgt.dtype)
        spec = specs.get(path) if specs else None
        if spec:
            out = block_of(out, spec, grid)
        return out.to(device if device is not None else tgt.device)

    specs = dict(leaves(shardings)) if shardings is not None else None
    return tree_map_with_path(load, target)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, saves every ``every`` steps;
    ``write=False`` builds the tree (a collective on a sharded state) and
    leaves the writing to another rank."""

    def __init__(self, ckpt_dir: str, every: int = 50, keep: int = 3,
                 write: bool = True):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.write = write

    def maybe_save(self, step: int, tree: Any) -> bool:
        """Save ``tree`` (or what a callable ``tree`` returns, built only
        when a save is due) at a step that ``every`` divides."""
        if self.every <= 0 or step % self.every:
            return False
        tree = tree() if callable(tree) else tree
        if self.write:
            save_checkpoint(self.dir, step, tree)
            self._gc()
        return True

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
