"""Parameters from numpy: the JAX package's tree (or
:func:`.common.init_params_numpy`'s) as the port's tensors, and the same
seeded draw streamed straight to the card.

Both packages keep one layout (nested dicts, block leaves stacked over
layers, ``[d_in, d_out]`` matrices), so conversion is leaf for leaf: the
port then computes the same function on the same numbers.  That holds for
every family: the encoder's tree keeps its token ``embed`` and its
``lm_head`` (``input_embeds`` bypasses the embedding, which training then
leaves at a zero gradient, as ``jax.grad`` does), the VLM's is a dense
decoder's.
"""
from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from .common import _path_seed, _walk, leaf_std, tree_map


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:            # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) →
    the same nested dict of tensors on ``device`` (the card unless
    ``"cpu"`` is asked for; raises without a card), dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)


def init_params_on_device(specs: Any, seed: int = 0,
                          dtype: torch.dtype = torch.float32, device="cuda",
                          workers: Optional[int] = None) -> Any:
    """The tree :func:`.common.init_params_numpy` draws, as tensors of
    ``dtype`` on ``device`` (the card unless ``"cpu"`` is asked for),
    without ever holding the whole f32 tree on the host.

    Each ``normal`` / ``embed`` slice is drawn from the same stream as
    there (``default_rng([seed, fnv1a(path)])``, a stacked leaf's layer i
    from ``default_rng([seed, fnv1a(path), i])``), scaled in f32, and
    copied into its place on the device, where it is cast to ``dtype``
    (round to nearest even for bf16): the result equals
    ``params_from_numpy(init_params_numpy(specs, seed))`` cast to
    ``dtype``.  Slices are drawn on ``workers`` threads, at most twice as
    many in flight as there are threads (Qwen1.5-MoE-A2.7B's f32 tree is
    57 GB; its largest slice, the embedding, 1.2 GB)."""
    from .model import torch_dtype
    dev = resolve_device(device)
    jobs = []

    def make(path, spec):
        dt = torch_dtype(spec.dtype) if spec.dtype else dtype
        t = torch.empty(spec.shape, dtype=dt, device=dev)
        if spec.init in ("ones", "zeros"):
            t.fill_(1.0 if spec.init == "ones" else 0.0)
        elif spec.init in ("normal", "embed"):
            std = np.float32(leaf_std(spec))
            if spec.logical and spec.logical[0] == "layers":
                jobs.extend((t[i], (seed, _path_seed(path), i), std)
                            for i in range(spec.shape[0]))
            else:
                jobs.append((t, (seed, _path_seed(path)), std))
        else:
            raise ValueError(f"unknown init {spec.init!r} at {path}")
        return t

    def draw(job):
        dst, key, std = job
        a = np.random.default_rng(list(key)).standard_normal(
            size=tuple(dst.shape), dtype=np.float32)
        a *= std
        return a

    tree = _walk(specs, make)
    n = workers or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(n) as ex:
        pending = collections.deque()
        for job in jobs:
            pending.append((job[0], ex.submit(draw, job)))
            if len(pending) >= 2 * n:
                dst, fut = pending.popleft()
                dst.copy_(torch.from_numpy(fut.result()))
        while pending:
            dst, fut = pending.popleft()
            dst.copy_(torch.from_numpy(fut.result()))
    return tree
