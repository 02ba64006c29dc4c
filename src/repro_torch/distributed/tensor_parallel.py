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
* :func:`gather_from_model`: an all-gather along a dimension (the last
  by default: the full logits a forward returns; a recurrent state's
  channels or heads, which the rules replicate over the model ranks);
  its backward takes the rank's slice;
* :func:`paired_halves`: a rank's contiguous column shard of a fused
  ``[x | z]`` in-projection (``[d, 2 n]``, the Mamba ``in_proj``, the
  mLSTM ``up_proj``) exchanged into the rank's matching ``x`` and ``z``
  column blocks ``[r n/tp, (r + 1) n/tp)`` by one all-to-all
  (:func:`paired_plan`: at tp 2, rank 0's shard is all of x and rank 1's
  all of z); its backward is the inverse exchange.  The stored layout
  stays the JAX one, so checkpoints do not depend on tp;
* :func:`reduce_scatter_to_model`: the partial products of a
  row-parallel weight summed over the model ranks, each rank keeping its
  block of a dimension (the mLSTM's ``wq``, ``wk``, ``wv``, ``w_i`` and
  ``w_f``, reduced onto the rank's heads): one all-to-all and the sum of
  the received blocks in rank order; its backward is an all-gather.

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


def _all_gather(x: torch.Tensor, group, size: int, dim: int
                ) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _all_to_all(x: torch.Tensor, group, out_rows: int, out_splits,
                in_splits) -> torch.Tensor:
    """``all_to_all_single`` over dimension 0 of ``x``: ``in_splits[s]``
    rows to rank s, ``out_splits[r]`` rows from rank r, in rank order."""
    import torch.distributed as dist
    out = x.new_empty((out_rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(out_splits),
                           list(in_splits), group=group)
    return out


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.rank, ctx.n, ctx.dim = rank, x.shape[dim], dim
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None,
                None)


def _scatter_sum(x: torch.Tensor, group, size: int, dim: int
                 ) -> torch.Tensor:
    """Block r of ``x`` along ``dim`` summed over the ranks, on rank r
    (the received blocks added in rank order)."""
    xt = x.movedim(dim, 0)
    n = xt.shape[0] // size
    got = _all_to_all(xt, group, xt.shape[0], [n] * size, [n] * size)
    acc = got[:n]
    for r in range(1, size):
        acc = acc + got[r * n:(r + 1) * n]
    return acc.movedim(0, dim)


class _ReduceScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _scatter_sum(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.size, ctx.dim), None, None, None


def paired_plan(width: int, tp: int) -> list:
    """The exchange of :func:`paired_halves` for a fused leaf of ``width``
    = 2 n columns ``[x | z]`` split into ``tp`` contiguous shards of ``w =
    width / tp``: ``plan[r][s]`` lists the column ranges ``(lo, hi)`` of
    rank r's shard, local to it, that rank s needs (the intersections of
    ``[r w, (r + 1) w)`` with rank s's x block ``[s u, (s + 1) u)`` and z
    block ``[n + s u, n + (s + 1) u)``, ``u = n / tp``), x's part first.
    Rank s receives, in rank order, exactly its x block then its z
    block."""
    n = width // 2
    if width % 2 or n % tp:
        raise ValueError(f"a fused leaf of {width} columns has no paired "
                         f"halves over {tp} ranks")
    w, u = width // tp, n // tp
    plan = []
    for r in range(tp):
        lo, hi = r * w, (r + 1) * w
        row = []
        for s in range(tp):
            parts = []
            for a, b in ((s * u, (s + 1) * u), (n + s * u, n + (s + 1) * u)):
                a, b = max(a, lo), min(b, hi)
                if a < b:
                    parts.append((a - lo, b - lo))
            row.append(parts)
        plan.append(row)
    return plan


def _rows(parts) -> int:
    return sum(b - a for a, b in parts)


class _PairedHalves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, size, rank):
        plan = paired_plan(w.shape[-1] * size, size)
        ctx.group, ctx.plan, ctx.rank = group, plan, rank
        wt = w.t()
        send = torch.cat([wt[a:b] for parts in plan[rank]
                          for a, b in parts])
        out_splits = [_rows(plan[r][rank]) for r in range(size)]
        got = _all_to_all(send, group, sum(out_splits), out_splits,
                          [_rows(parts) for parts in plan[rank]])
        return got.t().contiguous()

    @staticmethod
    def backward(ctx, g):
        plan, rank = ctx.plan, ctx.rank
        size = len(plan)
        in_splits = [_rows(parts) for parts in plan[rank]]
        got = _all_to_all(g.t(), ctx.group, sum(in_splits), in_splits,
                          [_rows(plan[r][rank]) for r in range(size)])
        gw = torch.empty_like(got)
        i = 0
        for parts in plan[rank]:
            for a, b in parts:
                gw[a:b] = got[i:i + b - a]
                i += b - a
        return gw.t(), None, None, None


def copy_to_model(x: torch.Tensor, mg: Optional[ModelGroup]
                  ) -> torch.Tensor:
    """``x`` itself; backward, its gradient summed over the model ranks."""
    return _CopyToModel.apply(x, mg.group) if _active(mg) else x


def reduce_from_model(x: torch.Tensor, mg: Optional[ModelGroup]
                      ) -> torch.Tensor:
    """``x`` summed over the model ranks; backward, the gradient as it
    is."""
    return _ReduceFromModel.apply(x, mg.group) if _active(mg) else x


def gather_from_model(x: torch.Tensor, mg: Optional[ModelGroup],
                      dim: int = -1) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim``, in rank order;
    backward, this rank's slice of the gradient."""
    if not _active(mg):
        return x
    return _GatherFromModel.apply(x, mg.group, mg.size, mg.rank,
                                  dim % x.dim())


def reduce_scatter_to_model(x: torch.Tensor, mg: Optional[ModelGroup],
                            dim: int = -1) -> torch.Tensor:
    """``x`` summed over the model ranks, this rank's block r of ``size /
    tp`` along ``dim`` kept; backward, the gradient all-gathered along
    ``dim``."""
    if not _active(mg):
        return x
    if x.shape[dim] % mg.size:
        raise ValueError(f"a dimension of {x.shape[dim]} does not split "
                         f"over {mg.size} model ranks")
    return _ReduceScatterToModel.apply(x, mg.group, mg.size, dim % x.dim())


def paired_halves(w: torch.Tensor, mg: Optional[ModelGroup]
                  ) -> torch.Tensor:
    """This rank's column shard ``[d, 2 n / tp]`` of a fused ``[x | z]``
    leaf ``[d, 2 n]`` → the rank's x columns ``[r n/tp, (r + 1) n/tp)``
    followed by its z columns ``[n + r n/tp, ...)``, ``[d, 2 n / tp]``
    (one all-to-all, :func:`paired_plan`, moving at most the rank's own
    shard); backward, the inverse exchange of the gradient."""
    if not _active(mg):
        return w
    return _PairedHalves.apply(w, mg.group, mg.size, mg.rank)


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
