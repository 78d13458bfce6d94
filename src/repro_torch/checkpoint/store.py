"""Checkpoint store (counterpart of ``repro.checkpoint.store``): atomic
(tmp + rename), durable (fsync) and async (a background writer).

A tree is a nest of dicts, lists and tuples whose leaves are tensors,
numpy arrays or numpy / Python scalars; each leaf is stored through numpy
as one ``.npy`` file, named in the manifest by its key path in the
reference's notation (``['acc']``, ``['opt'][0]``), so a manifest of
either package reads the same.

Format: one directory per step --
  step_000123/
    .tmp-* during write, atomically renamed when complete
    manifest.json   -- key paths, shapes, dtypes, crc32s
    leaf_00000.npy  -- one file per leaf

Durability: ``save_pytree`` fsyncs every leaf file and the manifest,
fsyncs the tmp directory, renames it, then fsyncs the parent directory
(the rename's own durability point).  The manifest carries a crc32 of
each leaf FILE (read back after the fsync), which ``restore_pytree``
verifies before ``np.load`` sees the bytes: a torn write fails loudly,
named.  A leftover ``.tmp-step_*`` directory (a crash mid-write) is never
a step: ``latest_step`` ignores it, and the next save of that step
replaces it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree", "latest_step",
           "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key path, leaf)`` pairs in a fixed order: dict keys sorted (as
    JAX flattens a dict), sequences in order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten_with_names(tree[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_names(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves taken from ``leaves`` in the
    order of ``_flatten_with_names``."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return leaves.pop(0)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a CPU tensor's shares its memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _file_crc32(path: str) -> int:
    """crc32 of the file's bytes, streamed (header and data, so a truncated
    or torn write changes it)."""
    crc = 0
    with open(path, "rb") as f:
        while block := f.read(1 << 20):
            crc = zlib.crc32(block, crc)
    return crc


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_pytree(directory: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step`` atomically and durably: every leaf
    and the manifest land in ``.tmp-step_N`` and are fsynced, the tmp
    directory is fsynced, then one rename publishes the step and the parent
    directory is fsynced.  Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:06d}")
    tmp = os.path.join(directory, f".tmp-step_{step:06d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        arr = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        leaf_path = os.path.join(tmp, fn)
        with open(leaf_path, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest[name] = {"file": fn, "shape": list(arr.shape),
                          "dtype": str(arr.dtype),
                          "crc32": _file_crc32(leaf_path)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_file(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_file(directory)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The highest published step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def restore_pytree(directory: str, step: int, like, *, host: bool = False,
                   device="cpu"):
    """Restore step ``step`` into the structure of ``like`` (a tree whose
    leaves have ``.shape`` and ``.dtype``: tensors or numpy arrays).  Each
    leaf's file crc32 is checked against the manifest, its shape against
    ``like``'s.  ``host=True`` returns numpy leaves with the stored bits
    and dtypes; otherwise tensors on ``device``."""
    path = os.path.join(directory, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    out = []
    for name, leaf in _flatten_with_names(like):
        ent = manifest.get(name)
        if ent is None:
            raise KeyError(f"checkpoint at {path} is missing leaf {name}")
        leaf_path = os.path.join(path, ent["file"])
        if (got := _file_crc32(leaf_path)) != ent["crc32"]:
            raise ValueError(f"{name}: checkpoint leaf {ent['file']} at "
                             f"{path} is corrupt: file crc32 {got:#010x} "
                             f"!= manifest crc32 {ent['crc32']:#010x} "
                             f"(truncated or torn write)")
        arr = np.load(leaf_path)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        out.append(arr if host else torch.from_numpy(arr).to(device))
    return _unflatten(like, out)


class CheckpointManager:
    """Async save with retention of the last ``keep`` steps.  ``save``
    snapshots the tree to host (a device tensor's copy; a CPU tensor's or
    numpy array's memory is shared, so the caller does not change what a
    pending write still reads) and hands the file writes to a background
    thread; ``wait`` joins it and re-raises its error."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree) -> None:
        self.wait()                       # one write in flight at a time
        names = _flatten_with_names(tree)
        host_tree = _unflatten(tree, [_to_numpy(v) for _, v in names])

        def write():
            try:
                save_pytree(self.directory, step, host_tree)
                self._gc()
            except BaseException as e:    # surfaced on the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()

    def restore_latest(self, like, *, host: bool = False, device="cpu"):
        """``(step, tree)`` of the latest step, or ``(None, None)``."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_pytree(self.directory, step, like, host=host,
                                    device=device)

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:06d}"),
                          ignore_errors=True)
