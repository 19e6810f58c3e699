"""Checkpoints in the JAX package's on-disk format: async, atomic, striped
over hosts, keep-N — so either package restores the other's.

  * Format: ``step_XXXXXXXX/`` holds ``manifest.json`` ({"leaves": [{"name",
    "shape", "dtype"}]}, written by host 0) and ``shard_{host}.npz``; a
    leaf's name is its tree path joined by ``/`` (dict keys sorted, as
    ``jax.tree_util`` orders them, e.g. ``opt/master/blocks/wq``), and
    hosts stripe the leaves round-robin in that order.  bf16 is stored as
    f32 (npz has no bf16; the upcast is lossless).
  * Atomic: writes go to ``step_XXXXXXXX.tmp/`` then ``os.rename``; a crash
    mid-write never corrupts the latest checkpoint.
  * Async: :meth:`CheckpointManager.save` copies the tree to the host on the
    caller's thread (the next train step updates the params in place, so
    the thread must not read them later) and serializes on a background
    thread; at most one save is in flight, and its error surfaces on
    :meth:`CheckpointManager.wait`.
  * Restore reads only the arrays the template names (a serving template
    ``{"step", "params"}`` reads no optimizer state) and places each leaf
    on the template leaf's device and dtype, or on ``device``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.tree import flatten_with_paths, map_tree, path_name, unflatten


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # npz has no bf16: store f32
            leaf = leaf.to(torch.float32)  # (lossless upcast)
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _host_copy(leaf):
    """A copy on the host that later in-place updates of ``leaf`` leave
    alone (a blocking copy: it waits for the work that writes ``leaf``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _place(arr: np.ndarray, leaf, device: Optional[torch.device]):
    """A stored array as the template ``leaf``'s kind: a tensor of its dtype
    on its device (or ``device``), a numpy array of its dtype, or a Python
    scalar of its type."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.asarray(arr, order="C")).to(leaf.dtype)
        return t.to(device if device is not None else leaf.device)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def save_pytree(tree, directory: Path, *, host_id: int = 0,
                num_hosts: int = 1):
    """Write a tree as npz shards + manifest (atomically, via tmp+rename)."""
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = [(path_name(path), leaf)
            for path, leaf in flatten_with_paths(tree)]
    manifest = {"leaves": [{"name": n, "shape": list(np.shape(leaf)),
                            "dtype": _dtype_name(leaf)} for n, leaf in flat]}
    # host 0 writes the manifest; hosts stripe the leaves round-robin,
    # keyed by tree PATH (not position) so restoring into a sub-tree
    # template (e.g. params without optimizer state) stays aligned
    arrays = {n: _to_numpy(leaf) for i, (n, leaf) in enumerate(flat)
              if i % num_hosts == host_id}
    np.savez(tmp / f"shard_{host_id}.npz", **arrays)
    if host_id == 0:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_pytree(template, directory: Path, device: DeviceLike = None):
    """Restore into the structure of ``template``, reading only the arrays
    it names; each leaf takes the template leaf's dtype and device (or
    ``device``)."""
    directory = Path(directory)
    device = torch.device(device) if device is not None else None
    flat = flatten_with_paths(template)
    shards = [np.load(p) for p in sorted(directory.glob("shard_*.npz"))]
    try:
        where = {name: z for z in shards for name in z.files}
        out = []
        for path, leaf in flat:
            name = path_name(path)
            out.append(_place(where[name][name], leaf, device))
    finally:
        for z in shards:
            z.close()
    return unflatten(template, out)


class CheckpointManager:
    def __init__(self, root: Path, keep: int = 3, *, host_id: int = 0,
                 num_hosts: int = 1):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id, self.num_hosts = host_id, num_hosts
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- async save -----------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        self.wait()  # double-buffer: at most one in-flight save
        host_tree = map_tree(_host_copy, tree)

        def work():
            try:
                save_pytree(host_tree, self.root / f"step_{step:08d}",
                            host_id=self.host_id, num_hosts=self.num_hosts)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.root.glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                device: DeviceLike = None):
        self.wait()  # the in-flight save is the latest checkpoint
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        tree = load_pytree(template, self.root / f"step_{step:08d}", device)
        return step, tree

    def _gc(self):
        steps = sorted(p for p in self.root.glob("step_*") if p.is_dir())
        for p in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(p, ignore_errors=True)
