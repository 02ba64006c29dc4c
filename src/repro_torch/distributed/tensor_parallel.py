"""Megatron tensor-parallel operators over a mesh's "model" group.

JAX shards the products of a jitted step over the ``"model"`` mesh axis
through its partitioner (``PARAM_RULES["default"]`` puts ``q_heads``,
``mlp`` and ``vocab`` there).  The port runs eagerly on each rank's plain
tensors, so the collectives are written out, as Megatron-LM writes them:

* :func:`copy_to_model` (Megatron's *f*): the identity forward, an
  all-reduce of the gradient backward.  It goes on the input of a
  column-parallel product (the rank multiplies by its columns of a
  weight, so the input's gradient it computes is partial), and on a
  replicated tensor of which each rank uses only a part (the replicated
  K and V before a rank takes its heads' part of them);
* :func:`reduce_from_model` (Megatron's *g*): an all-reduce forward, the
  identity backward.  It sums the partial outputs of a row-parallel
  product (a rank's rows of ``wo`` or ``w_down``);
* :func:`vocab_parallel_embed`: each rank holds rows ``[r V/tp, (r + 1)
  V/tp)`` of the embedding; a token outside them reads zeros, and the
  ranks' rows are summed;
* :func:`vocab_parallel_nll`: the cross-entropy of logits split over the
  vocabulary: the global max by an all-reduce MAX (no gradient flows
  through it: the loss does not depend on it), the sum of the
  exponentials by :func:`reduce_from_model`, and the target's logit taken
  on the rank that owns it and summed likewise;
* :func:`gather_from_model`: an all-gather along the last dimension (the
  full logits a forward returns); its backward takes the rank's slice.

Each operator is the identity, with no collective, when it is given no
group or a group of one rank, so the unsharded model runs the same code
as the tensor-parallel one.  ``torch.distributed`` is imported inside the
functions that run collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The process group of a mesh's ``"model"`` dimension, its number of
    ranks, and this rank's index on it
    (:func:`..distributed.sharding.model_group`)."""
    group: Any
    size: int
    rank: int


def _active(mg: Optional[ModelGroup]) -> bool:
    return mg is not None and mg.size > 1


def splits(mg: Optional[ModelGroup], local: int, full: int) -> bool:
    """Whether a weight dimension of ``full`` entries that arrives with
    ``local`` of them is this rank's model shard (``full / tp``), rather
    than whole: the layer then computes tensor-parallel.  Raises on any
    other width."""
    if local == full:
        return False
    if not _active(mg) or local * mg.size != full:
        raise ValueError(f"a dimension of {full} arrived with {local}: "
                         "neither whole nor one model rank's shard of "
                         f"{mg.size if mg else 1}")
    return True


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        import torch.distributed as dist
        ctx.rank, ctx.n = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g[..., ctx.rank * n:(ctx.rank + 1) * n], None, None, None


def copy_to_model(x: torch.Tensor, mg: Optional[ModelGroup]
                  ) -> torch.Tensor:
    """``x`` itself; backward, its gradient summed over the model ranks."""
    return _CopyToModel.apply(x, mg.group) if _active(mg) else x


def reduce_from_model(x: torch.Tensor, mg: Optional[ModelGroup]
                      ) -> torch.Tensor:
    """``x`` summed over the model ranks; backward, the gradient as it
    is."""
    return _ReduceFromModel.apply(x, mg.group) if _active(mg) else x


def gather_from_model(x: torch.Tensor, mg: Optional[ModelGroup]
                      ) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along the last dimension, in
    rank order; backward, this rank's slice of the gradient."""
    if not _active(mg):
        return x
    return _GatherFromModel.apply(x, mg.group, mg.size, mg.rank)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         mg: Optional[ModelGroup]) -> torch.Tensor:
    """Rows ``tokens`` [...] of an embedding of which this rank holds rows
    ``[rank V_l, (rank + 1) V_l)`` (``table`` [V_l, d]) → [..., d]: the
    rank's own rows, zeros for a token it does not hold, summed over the
    model ranks (exactly one rank adds a row that is not zero)."""
    if not _active(mg):
        return table[tokens.long()]
    n = table.shape[0]
    idx = tokens.long() - mg.rank * n
    mine = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows, mg)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       mg: Optional[ModelGroup], start: int = 0
                       ) -> torch.Tensor:
    """Per-position cross-entropy ``logsumexp(z) - z[label]`` (f32) of
    logits split over the vocabulary: ``logits`` [..., V_l] are classes
    ``start .. start + V_l`` of this rank, ``labels`` [...] global class
    ids.  ``m`` is the global max (an all-reduce MAX, outside the graph:
    ``log sum exp(z - m) + m`` does not depend on it), the sum of
    ``exp(z - m)`` and the label's logit (taken on the rank that holds
    it, zero elsewhere) are summed over the model ranks."""
    z = logits.float()
    n = z.shape[-1]
    m = z.detach().amax(-1)
    if _active(mg):
        m = _all_reduce(m, mg.group, "max")
    s = reduce_from_model(torch.exp(z - m[..., None]).sum(-1), mg)
    idx = labels.long() - start
    mine = (idx >= 0) & (idx < n)
    ll = torch.gather(z, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(mine, ll, torch.zeros(
        (), dtype=ll.dtype, device=ll.device)), mg)
    return torch.log(s) + m - ll
