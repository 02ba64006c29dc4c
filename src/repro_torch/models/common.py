"""Parameter specs: declare params once, get a seeded numpy init.

The same tree as the JAX package's ``models/common.py``: a model declares
a *spec tree* — nested dicts of :class:`Spec` leaves, each carrying shape,
logical axis names and an initializer.  ``jax.random`` streams cannot be
reproduced here, so the port's init is :func:`init_params_numpy`: numpy
draws from a seed, which both the JAX package (in the tests and the
fixture script) and the port (on the card) can take as their weights.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, Tuple

import numpy as np

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # stddev multiplier (normal) / stddev (embed)
    dtype: Optional[str] = None  # overrides param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def _walk(tree: PyTree, fn: Callable[[Tuple[str, ...], Spec], Any],
          path: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if not isinstance(tree, Spec):
        raise TypeError(f"non-Spec leaf at {path}: {tree!r}")
    return fn(path, tree)


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of a nested dict (and, leaf for leaf, of the
    nested dicts ``rest`` of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree, path: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _path_seed(path: Tuple[str, ...]) -> int:
    """FNV-1a of the leaf's path: each leaf draws from its own stream."""
    h = 2166136261
    for part in path:
        for ch in part.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h


def leaf_std(spec: Spec) -> float:
    """Standard deviation of a ``normal`` or ``embed`` leaf: ``normal`` is
    ``scale / sqrt(fan_in)`` (fan-in = the second-to-last axis, or the
    only one), ``embed`` is ``scale``."""
    if spec.init == "embed":
        return float(spec.scale)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return float(spec.scale / np.sqrt(max(fan_in, 1)))


def init_params_numpy(specs: PyTree, seed: int = 0,
                      dtype: str = "float32",
                      workers: Optional[int] = None) -> PyTree:
    """Materialise a spec tree as numpy arrays, reproducibly from ``seed``.

    ``ones`` and ``zeros`` leaves are constant.  A ``normal`` or ``embed``
    leaf is standard normal float32 times :func:`leaf_std`, drawn with
    ``numpy.random.default_rng([seed, fnv1a(path)])``; a leaf stacked over
    layers (logical axis ``"layers"`` first) draws each layer's slice from
    ``default_rng([seed, fnv1a(path), layer])``.  Each stream depends only
    on the seed and the leaf's path, so the draws are the same in any
    order, and the slices are drawn on ``workers`` threads (numpy releases
    the interpreter lock while it fills an array).
    """
    if np.dtype(dtype) != np.float32:
        raise ValueError("init_params_numpy draws float32 parameters only")
    jobs = []

    def make(path, spec):
        dt = np.dtype(spec.dtype or dtype)
        if spec.init in ("ones", "zeros"):
            arr = (np.ones if spec.init == "ones" else np.zeros)(spec.shape,
                                                                 dt)
        elif spec.init in ("normal", "embed"):
            arr = np.empty(spec.shape, dt)
            std = np.float32(leaf_std(spec))
            if spec.logical and spec.logical[0] == "layers":
                jobs.extend((arr[i], (seed, _path_seed(path), i), std)
                            for i in range(spec.shape[0]))
            else:
                jobs.append((arr, (seed, _path_seed(path)), std))
        else:
            raise ValueError(f"unknown init {spec.init!r} at {path}")
        return arr

    def draw(job):
        arr, key, std = job
        np.random.default_rng(list(key)).standard_normal(
            size=arr.shape, dtype=np.float32, out=arr)
        arr *= std

    tree = _walk(specs, make)
    n = workers or min(8, os.cpu_count() or 1)
    if n > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(n) as ex:
            list(ex.map(draw, jobs))
    else:
        for job in jobs:
            draw(job)
    return tree


def logical_tree(specs: PyTree) -> PyTree:
    """The spec tree's logical axes: a tree of tuples of axis names."""
    return _walk(specs, lambda _, s: s.logical)


def spec_shapes(specs: PyTree, dtype: str = "float32") -> PyTree:
    """The spec tree as meta tensors of each leaf's shape and dtype (the
    leaf's own dtype, else ``dtype``): the structure with no storage, the
    JAX ``ShapeDtypeStruct`` tree."""
    import torch
    from .model import torch_dtype
    return _walk(specs, lambda _, s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype or dtype), device="meta"))


def count_params(specs: PyTree) -> int:
    total = 0

    def add(_, s):
        nonlocal total
        total += int(np.prod(s.shape))
        return None
    _walk(specs, add)
    return total
