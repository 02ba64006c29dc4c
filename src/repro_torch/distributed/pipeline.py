"""GPipe-style pipeline parallelism over a mesh axis (e.g. "pod").

The port of the JAX package's ``distributed/pipeline.py``.  Each rank of
the stage axis owns one stage's parameters; microbatches stream through
the stages, each tick's outputs passed one stage on around a ring
(point-to-point send and receive, the JAX ``ppermute``).

Schedule: plain GPipe (fill-drain), as there.  Every stage computes on
every tick (during the fill on the zero buffer, whose results go
nowhere), so the bubble fraction is (S-1)/(M+S-1) for S stages and M
microbatches.  The last stage's outputs are broadcast to every stage at
the end, where JAX sums them over the stage axis with zeros elsewhere.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.common import tree_map
from .sharding import is_dtensor

PyTree = Any


def _stage_leaf(a: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's slice of a ``[n_stages, ...]`` leaf: a DTensor's
    ``[1, ...]`` shard, or row ``stage`` of a whole tensor."""
    return a.to_local()[0] if is_dtensor(a) else a[stage]


def pipeline_forward(mesh, stage_axis: str,
                     block_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
                     stage_params: PyTree, x_micro: torch.Tensor
                     ) -> torch.Tensor:
    """Run ``block_fn`` as a pipeline over ``stage_axis``.

    ``mesh``: a ``DeviceMesh`` (the stages are the ranks of its
    ``stage_axis``) or a process group (its ranks; ``stage_axis`` unused).
    ``stage_params``: nested dicts of ``[n_stages, ...]`` leaves (DTensors
    sharded over the stage axis, or whole tensors of which each stage
    takes its row); ``x_micro``: ``[n_micro, Bm, ...]`` microbatched
    activations, the same on every stage.  Returns the outputs ``[n_micro,
    Bm, ...]`` of the last stage, on every stage."""
    import torch.distributed as dist
    group = (mesh.get_group(stage_axis) if hasattr(mesh, "get_group")
             else mesh)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    params_me = tree_map(lambda a: _stage_leaf(a, stage), stage_params)
    n_micro = x_micro.shape[0]
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    last = dist.get_global_rank(group, n_stages - 1)

    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (the last one again past the end)
        x_in = x_micro[min(t, n_micro - 1)] if stage == 0 else buf
        y = block_fn(params_me, x_in)
        # last stage emits microbatch t - (n_stages - 1)
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outs[out_idx] = y
        # pass to the next stage around the ring
        if n_stages > 1:
            y = y.contiguous()
            buf = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)])
            for r in reqs:
                r.wait()
        else:
            buf = y
    # broadcast the final outputs from the last stage to every stage
    dist.broadcast(outs, src=last, group=group)
    return outs
