"""Async, atomic checkpointing.

The port of the JAX package's ``checkpoint/checkpointer.py``, with its
layout and protocol (one directory per step):

    <root>/step_00000040.tmp-<nonce>/  # written here first
        manifest.json                  # leaf paths, shapes, dtypes, extras
        leaf_00000.npy ...             # one file per leaf
    <root>/step_00000040/              # atomic rename when complete

* **atomic** — readers never see a partial checkpoint (tmp dir + rename);
  a crash mid-save leaves only a ``.tmp-`` directory, which the next
  ``Checkpointer`` on the root deletes.
* **async** — ``save`` copies the leaves to the host on the caller's
  thread (fresh copies, so that later in-place updates cannot reach the
  file) and writes them on a background thread; ``wait()`` joins it.
* keeps the newest ``keep`` checkpoints.

A tree is nested dicts, lists, tuples and NamedTuples of tensors or numpy
arrays (``None`` leaves are skipped, as ``jax.tree`` skips them).  The
manifest stores each leaf's path (``"opt/m/blocks/pos0/attn/wq"``) where
the JAX package pickles its treedef; bf16 leaves are written as their
bytes (``uint8``), as the JAX package writes its ``ml_dtypes`` leaves.
``restore`` rebuilds the tree of ``target`` (or nested dicts of the
paths) on a given device.

Sharded trees (DTensor leaves, :mod:`..distributed.sharding`) need a
``Checkpointer`` made with the process ``group`` that holds them:

* **save** gathers each DTensor whole (``full_tensor``) on the caller's
  thread, on every rank, and only then does the group's rank 0 hand its
  host copy to the writer thread (a collective on the writer thread could
  deadlock against the next step's collectives); the other ranks write
  nothing.  ``wait`` joins the write and then waits at a barrier, so no
  rank reads ``latest_step`` before rank 0's rename.
* **restore** takes ``shardings=`` (a tree of ``Sharding`` over the
  target's structure): each rank reads only its slice of a sharded leaf
  (``np.load(..., mmap_mode="r")``) and gets a DTensor.  The manifest is
  the same whatever the world size, so a checkpoint written on any number
  of ranks restores onto any other, or onto one process without a mesh
  (elastic restore, the JAX ``device_put`` onto the new shardings).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..distributed.sharding import (from_local, gather, is_dtensor,
                                    local_slices)

PyTree = Any

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.int64: "int64",
              torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
              torch.uint8: "uint8", torch.bool: "bool"}


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaf_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every non-None leaf, depth first in the tree's
    own order."""
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in kids:
        out += leaf_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def rebuild(target: PyTree, leaves: Dict[str, Any], prefix: str = ""):
    """``target``'s structure with each leaf the value of its path in
    ``leaves`` (``None`` leaves stay ``None``)."""
    kids = _children(target)
    if kids is None:
        return None if target is None else leaves[prefix]
    vals = [rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in kids]
    if isinstance(target, dict):
        return dict(zip(target.keys(), vals))
    if hasattr(target, "_fields"):
        return type(target)(*vals)
    return type(target)(vals)


def _nested(leaves: Dict[str, Any]) -> dict:
    out: dict = {}
    for path, v in leaves.items():
        node = out
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def _to_host(x) -> Tuple[np.ndarray, str]:
    """A fresh host copy of one leaf as numpy, and its dtype's name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).numpy(), "bfloat16"
        return t.numpy(), _NP_DTYPES[t.dtype]
    a = np.array(x, copy=True)
    return a, str(a.dtype)


def _load_leaf(path: str, meta: dict, sharding=None) -> torch.Tensor:
    """One saved leaf as a host tensor of its dtype: whole, or the slice
    ``sharding`` gives this rank (read through a memory map)."""
    arr = np.load(path, mmap_mode=None if sharding is None else "r")
    if meta["dtype"] == "bfloat16":     # saved as its bytes
        arr = arr.view(np.int16).reshape(meta["shape"])
    if sharding is not None:      # a copy: never a view of the map
        arr = np.array(arr[local_slices(meta["shape"], sharding)],
                       order="C")
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


class Checkpointer:
    """``group``: the process group of sharded trees (the module's
    docstring); None for a process's own."""

    def __init__(self, root: str, keep: int = 3, group=None):
        self.root = root
        self.keep = keep
        self.group = group
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if self._writes():
            self._gc_tmp()

    def _writes(self) -> bool:
        """Whether this process writes the files: rank 0 of ``group``."""
        if self.group is None:
            return True
        import torch.distributed as dist
        return dist.get_rank(self.group) == 0

    def _barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree,
             extras: Optional[Dict[str, Any]] = None,
             blocking: bool = False) -> None:
        self.wait()
        paths = leaf_paths(tree)
        if self.group is None and any(is_dtensor(x) for _, x in paths):
            raise ValueError("a tree of DTensors needs the Checkpointer's "
                             "group=")
        writes = self._writes()
        host = []
        for _, x in paths:
            full = gather(x)           # a collective: every rank, in order
            if writes:
                host.append(_to_host(full))
            del full
        if not writes:
            if blocking:
                self._barrier()
            return
        manifest = {
            "step": step,
            "leaves": [{"path": p, "shape": list(x.shape), "dtype": dt}
                       for (p, x), (_, dt) in zip(paths, host)],
            "extras": extras or {},
        }

        def work():
            tmp = os.path.join(self.root,
                               f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}")
            os.makedirs(tmp, exist_ok=True)
            for i, (arr, _) in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr,
                        allow_pickle=False)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.root, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            work()
            self._barrier()
            return

        def guarded():
            try:
                work()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background save and, with a ``group``, wait for every
        rank at a barrier; raise what the save raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = [int(name.split("_")[1]) for name in os.listdir(self.root)
                 if name.startswith("step_") and ".tmp" not in name]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None,
                target: Optional[PyTree] = None, device="cuda",
                shardings: Optional[PyTree] = None
                ) -> Tuple[PyTree, Dict[str, Any]]:
        """Load a checkpoint → (tree, extras), every leaf a tensor on
        ``device`` (the card unless ``"cpu"`` is asked for; raises without
        a card).  ``target``: a tree of the saved structure (any
        leaves, e.g. meta tensors) to rebuild; without it, nested dicts of
        the saved paths.  ``shardings``: a tree of ``Sharding`` (or
        ``None`` leaves) over the same structure; a leaf with one becomes
        a DTensor of which this rank reads only its slice."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        dev = resolve_device(device)
        placed = dict(leaf_paths(shardings)) if shardings is not None else {}
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for i, meta in enumerate(manifest["leaves"]):
            sh = placed.get(meta["path"])
            t = _load_leaf(os.path.join(d, f"leaf_{i:05d}.npy"), meta,
                           sh).to(dev)
            leaves[meta["path"]] = (t if sh is None
                                    else from_local(t, sh, meta["shape"]))
        tree = (rebuild(target, leaves) if target is not None
                else _nested(leaves))
        return tree, manifest["extras"]

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.root)
                       if n.startswith("step_") and ".tmp" not in n)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.root):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
