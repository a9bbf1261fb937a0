"""Checkpointing with atomic commits and async save (port of
``repro.distributed.checkpoint``, the same on-disk format: a checkpoint
either package writes restores in the other).

Format: <dir>/step_<N>/
  manifest.json    — step, wall time, and per leaf its file, shape and
                     dtype string, keyed by the leaf's dict path joined
                     with ``::``
  leaf_<i>.npy     — the full array of the i-th leaf in sorted-key order

A bfloat16 leaf is stored as its raw bits (uint16) with the dtype string
``"bfloat16"`` and read back through ``torch``'s ``view``: no
``ml_dtypes`` is needed on either side of the port.

Atomicity: write into ``.tmp-step_<N>``, fsync the manifest, then
rename. A ``latest`` marker file is updated last. Partially-written
checkpoints are never visible; the manager keeps the newest ``keep``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_SEP = "::"
_NUMPY_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _flatten(tree, prefix=()) -> dict:
    """{"a::b::c": leaf} over a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten_like(tree, flat: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),))
                for k, v in tree.items()}
    return flat[_SEP.join(prefix)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A copy of ``t`` on the host as numpy (raw bits for bfloat16) and its
    dtype string; always a copy, so later in-place updates of ``t`` do not
    reach it."""
    name = _dtype_name(t)
    t = t.detach().to("cpu", copy=True)
    if name == "bfloat16":                 # numpy has none: its raw bits
        return t.view(torch.int16).numpy().view(np.uint16), name
    if name not in _NUMPY_NATIVE:
        raise TypeError(f"no checkpoint format for dtype {name}")
    return t.numpy(), name


def _from_host(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        bits = np.array(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if name not in _NUMPY_NATIVE and str(arr.dtype) != name:
        raise TypeError(f"no checkpoint format for dtype {name}")
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, blocking: bool = True):
    """Copy the tree to the host and write an atomic checkpoint; with
    ``blocking=False`` the write runs on a thread (returned), after the
    copy."""
    host = {k: _to_host(v) for k, v in _flatten(tree).items()}

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for i, (k, (a, dtype)) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), a)
            manifest["leaves"][k] = {
                "file": fname, "shape": list(a.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(ckpt_dir, "latest.tmp"),
                   os.path.join(ckpt_dir, "latest"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    marker = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(ckpt_dir, f"step_{step:08d}")):
        return step
    return None


def restore(ckpt_dir: str, step: int, target_tree):
    """Load a checkpoint into the structure of ``target_tree``: each leaf
    takes its target's dtype and device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for key, ref in _flatten(target_tree).items():
        meta = manifest["leaves"][key]
        raw = np.load(os.path.join(path, meta["file"]), mmap_mode="r")
        t = _from_host(raw, meta["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}"
                             f", target {tuple(ref.shape)}")
        out[key] = t.to(device=ref.device, dtype=ref.dtype)
    return _unflatten_like(target_tree, out)


class CheckpointManager:
    """Keep-latest-K manager with async save and restart discovery."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    def save(self, step: int, tree):
        self.wait()
        self._pending = save(self.dir, step, tree,
                             blocking=not self.async_save)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        if not os.path.isdir(self.dir):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, target_tree):
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        return restore(self.dir, step, target_tree), step
