"""Int8 error-feedback gradient reduction (distributed-optimization trick).

The port of the JAX package's ``distributed/grad_compress.py``.  Replaces
the f32 gradient all-reduce with: quantize the local gradient to int8
(one scale per block of ``QBLOCK = 512``) with an error-feedback
residual, all-gather the int8 payload and the scales over the data
ranks, dequantize and take the mean locally.  Wire bytes drop ~3.5x
against an f32 ring all-reduce; error feedback keeps the long-run update
sequence unbiased (EF-SGD / 1-bit Adam lineage).

Two entry points:

* :func:`ef_allreduce_inside` — one rank's gradient and residual, reduced
  over a process group (the JAX function inside ``shard_map``);
* :func:`ef_allreduce` — over trees of stacked per-shard gradients
  ``[ndp, ...]`` whose leading axis is sharded over a mesh axis (DTensors
  with ``Shard(0)`` there, or each rank's ``[1, ...]`` slice).

``torch.round`` rounds half to even as ``jnp.round`` does, so the payload
is the JAX package's bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from ..models.common import tree_map
from .sharding import is_dtensor, local

PyTree = Any
QBLOCK = 512


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x → (int8 blocks [n_blocks, QBLOCK], f32 scales [n_blocks, 1]), the
    flattened x zero-padded to whole blocks; scale = max(|block|, 1e-12) /
    127."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    blk = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, QBLOCK)
    scale = torch.clamp_min(blk.abs().amax(1, keepdim=True), 1e-12) / 127.0
    q = torch.clamp(torch.round(blk / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def ef_allreduce_inside(g_local: torch.Tensor, residual: torch.Tensor,
                        group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the mean over ``group``'s ranks of their dequantized payloads, the
    new residual): this rank quantizes ``g + residual`` and keeps what the
    quantization lost."""
    import torch.distributed as dist
    x = g_local.float() + residual
    q, s = _quant(x)
    new_resid = x - _dequant(q, s, x.shape)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, s, group=group)
    deq = torch.stack(qs).float() * torch.stack(ss)   # [ndp, blocks, QBLOCK]
    mean = deq.mean(dim=0)
    out = mean.reshape(-1)[: math.prod(x.shape)].reshape(x.shape)
    return out, new_resid


def ef_allreduce(stacked: PyTree, residual: PyTree, mesh,
                 dp_axis: str = "data") -> Tuple[PyTree, PyTree]:
    """``stacked``: nested dicts of ``[ndp, ...]`` per-shard gradients,
    the leading axis sharded over ``dp_axis`` of the ``DeviceMesh``
    ``mesh`` — DTensors, or this rank's ``[1, ...]`` slices — and
    ``residual`` alike.  Returns (the mean gradient on every shard, the new
    residuals), each in the form of its input."""
    group = mesh.get_group(dp_axis)

    def one(g, r):
        out, new_r = ef_allreduce_inside(local(g)[0], local(r)[0], group)
        return _like(g, out[None]), _like(g, new_r[None])
    pairs = tree_map(one, stacked, residual)
    return (tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs))


def _like(a, x: torch.Tensor):
    """``x`` as a DTensor placed as ``a`` where ``a`` is one."""
    if not is_dtensor(a):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, a.device_mesh, a.placements,
                              run_check=False)


def init_residual_stacked(stacked: PyTree) -> PyTree:
    """f32 zeros of each leaf's shape (a DTensor's placements kept)."""
    return tree_map(lambda p: _like(p, torch.zeros(
        local(p).shape, dtype=torch.float32, device=local(p).device)),
        stacked)
