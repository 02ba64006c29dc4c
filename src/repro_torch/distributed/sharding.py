"""Logical-axis sharding rules (MaxText-style) as DTensor placements.

The port of the JAX package's ``distributed/sharding.py``.  Parameters
and activations name their dimensions with *logical* axes; a rule table
maps each to mesh axes.  The tables are the JAX package's, copied:

* ``default``      — FSDP over (pod×)data on the embed dim + Megatron
                     rules over model on heads/mlp/vocab; kv-heads
                     replicated.
* ``decode``       — decode caches: batch over (pod×)data, the KV
                     sequence over model.
* ``decode_long``  — long-context decode: KV sequence sharded over data,
                     batch replicated.

Where JAX builds a ``PartitionSpec`` and a ``NamedSharding``, the port
builds the same per-dimension axis assignment (:func:`logical_to_pspec`,
a tuple with one entry per tensor dimension) and turns it into DTensor
placements, one per mesh dimension (:func:`logical_to_placements`): mesh
axis ``a`` assigned to tensor dimension ``d`` is ``Shard(d)``, an axis
assigned to none is ``Replicate()``.  A tuple axis ``("pod", "data")``
on one dimension is ``Shard(d)`` on both mesh dimensions, in mesh order,
which DTensor splits pod-major as JAX does.  Axes that do not divide a
dimension are dropped outermost first, as JAX drops them
(:func:`_resolve`): DTensor would shard unevenly instead, so the rules
never hand it an uneven split.

The rule functions read only a mesh's axis names and sizes, so they take
a :class:`MeshShape` (no devices, no process group: any shape can be
tested in one process) as well as a ``DeviceMesh``.  ``torch.distributed``
is imported inside the functions that need it, so importing the port
stays light.

The port computes on plain local tensors (a rank gathers the parameters
it needs, :mod:`..train.train_step`); DTensors hold what is *stored*
sharded: parameters, optimizer state, batches and checkpoints.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]
PyTree = Any

# data-parallel super-axis: ("pod","data") on multi-pod meshes collapses to
# whatever subset exists on the current mesh (see _resolve).
DP = ("pod", "data")

PARAM_RULES: Dict[str, Dict[str, AxisVal]] = {
    "default": {
        "embed": DP,          # FSDP / ZeRO-3 shard dim
        "mlp": "model",
        "q_heads": "model",
        "kv_heads": None,     # kv=8 < model axis; replicate (small)
        "vocab": "model",
        "expert": DP,         # FSDP over experts (never the contraction dim)
        "layers": None,
    },
    # beyond-paper variant: shard experts over data too (less all-to-all,
    # more gather) — used in hillclimbing.
    "expert_dp": {
        "embed": DP, "mlp": "model", "q_heads": "model", "kv_heads": None,
        "vocab": "model", "expert": DP, "layers": None,
    },
    # 2D sharding for collective-bound cells: split embed over model too.
    "embed_2d": {
        "embed": "model", "mlp": DP, "q_heads": DP, "kv_heads": None,
        "vocab": "model", "expert": None, "layers": None,
    },
}

ACT_RULES: Dict[str, Dict[str, AxisVal]] = {
    "default": {
        "batch": DP,
        "seq": None,
        "embed": None,
        "q_heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "vocab": "model",
        "mlp": "model",
        "kv_seq": None,
        "kv_head_dim": "model",
        "pages": None,
    },
    # decode: shard the KV cache along the sequence (flash-decoding split-K);
    # avoids the kv_heads/head_dim axis fights (GQA kv=8 vs 16-way model)
    # that made the partitioner replicate cache slices per layer.
    "decode": {
        "batch": DP,
        "seq": None,
        "embed": None,
        "q_heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "vocab": "model",
        "mlp": "model",
        "kv_seq": "model",
        "kv_head_dim": None,
        "pages": None,
    },
    "decode_long": {
        "batch": None,          # batch 1
        "seq": None,
        "embed": None,
        "q_heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "vocab": "model",
        "mlp": "model",
        "kv_seq": DP,           # sequence-parallel KV cache
        "kv_head_dim": "model",
        "pages": DP,
    },
    # sequence-parallel training activations (hillclimb option)
    "seq_parallel": {
        "batch": DP, "seq": "model", "embed": None, "q_heads": "model",
        "kv_heads": None, "head_dim": None, "vocab": "model",
        "mlp": "model",
        "kv_seq": None, "kv_head_dim": "model", "pages": None,
    },
}


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices and no process group:
    all the rule functions read (the JAX ``Mesh``'s ``axis_names`` and
    ``shape``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def is_device_mesh(mesh) -> bool:
    mod = sys.modules.get("torch.distributed.device_mesh")
    return mod is not None and isinstance(mesh, mod.DeviceMesh)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor: no DTensor
    exists before ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_shape(mesh) -> MeshShape:
    """``mesh`` as a :class:`MeshShape`: a ``DeviceMesh`` with named
    dimensions, a :class:`MeshShape`, or anything with ``axis_names`` and
    ``shape`` (axis name → size)."""
    if isinstance(mesh, MeshShape):
        return mesh
    if is_device_mesh(mesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        return MeshShape(tuple(mesh.mesh_dim_names),
                         tuple(int(s) for s in mesh.shape))
    return MeshShape(tuple(mesh.axis_names),
                     tuple(int(mesh.shape[a]) for a in mesh.axis_names))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _resolve(axis: AxisVal, mesh, dim_size: Optional[int] = None
             ) -> AxisVal:
    """Drop mesh axes that don't exist; drop sharding if not divisible."""
    if axis is None:
        return None
    ms = mesh_shape(mesh)
    names = axis if isinstance(axis, tuple) else (axis,)
    names = tuple(a for a in names if a in ms.axis_names)
    if not names:
        return None
    if dim_size is not None:
        while names and dim_size % math.prod(ms.shape[a] for a in names):
            names = names[1:]   # drop outermost axis until divisible
        if not names:
            return None
    # preserve the declared form: tuple-valued rules stay tuples even when
    # axis dropping leaves a single mesh axis (("pod","data") -> ("data",))
    return names if (len(names) > 1 or isinstance(axis, tuple)) else names[0]


def logical_to_pspec(logical: Sequence[Optional[str]], mesh,
                     rules: Dict[str, AxisVal],
                     shape: Optional[Sequence[int]] = None
                     ) -> Tuple[AxisVal, ...]:
    """Per tensor dimension, the mesh axis (or tuple of axes, or None) it
    is sharded over: the entries of the JAX ``PartitionSpec``."""
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        ax = rules.get(name) if name else None
        ax = _resolve(ax, mesh, None if shape is None else shape[i])
        # a mesh axis may appear at most once in a PartitionSpec
        if ax is not None:
            was_tuple = isinstance(ax, tuple)
            names = ax if was_tuple else (ax,)
            names = tuple(a for a in names if a not in used)
            used.update(names)
            if not names:
                ax = None
            elif len(names) > 1 or was_tuple:
                ax = names
            else:
                ax = names[0]
        out.append(ax)
    return tuple(out)


def spec_to_placements(spec: Sequence[AxisVal], mesh) -> tuple:
    """A :func:`logical_to_pspec` assignment → one DTensor placement per
    mesh dimension: ``Shard(d)`` on each axis assigned to tensor dimension
    ``d``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_shape(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        idx = [names.index(a) for a in (ax if isinstance(ax, tuple)
                                        else (ax,))]
        if idx != sorted(idx):
            raise ValueError(f"axes {ax} of dimension {d} are not in mesh "
                             f"order {names}: DTensor would split them "
                             "otherwise than JAX")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_to_placements(logical: Sequence[Optional[str]], mesh,
                          rules: Dict[str, AxisVal],
                          shape: Optional[Sequence[int]] = None) -> tuple:
    """The DTensor placements of a tensor of ``shape`` with ``logical``
    axes under ``rules`` on ``mesh`` (one per mesh dimension)."""
    return spec_to_placements(logical_to_pspec(logical, mesh, rules, shape),
                              mesh)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives: a mesh (a ``DeviceMesh``, or a
    :class:`MeshShape` for the rules alone) and one placement per mesh
    dimension — the port's ``NamedSharding``."""
    mesh: Any
    placements: tuple


def _is_logical(x) -> bool:
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(a is None or isinstance(a, str) for a in x))


def map_logical(fn: Callable[..., Any], logical_tree: PyTree,
                *rest: PyTree) -> PyTree:
    """``fn(logical, *leaves)`` over a tree of logical-axis tuples (nested
    dicts and NamedTuples; ``None`` stays ``None``) and, leaf for leaf,
    over trees ``rest`` of the same structure."""
    if logical_tree is None:
        return None
    if _is_logical(logical_tree):
        return fn(logical_tree, *rest)
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(r[k] for r in rest))
                for k, v in logical_tree.items()}
    if hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*(
            map_logical(fn, getattr(logical_tree, f),
                        *(getattr(r, f) for r in rest))
            for f in logical_tree._fields))
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


def param_sharding(logical_tree_: Any, shape_tree: Any, mesh,
                   rule_set: str = "default") -> Any:
    """A tree of :class:`Sharding` for a tree of logical axes and one of
    shapes (leaves with ``.shape``: meta tensors from
    :func:`..models.common.spec_shapes`, or tensors)."""
    rules = PARAM_RULES[rule_set]
    return map_logical(lambda lg, s: Sharding(mesh, logical_to_placements(
        lg, mesh, rules, tuple(s.shape))), logical_tree_, shape_tree)


def act_pspec(logical: Sequence[Optional[str]], mesh,
              rule_set: str = "default",
              shape: Optional[Sequence[int]] = None) -> Tuple[AxisVal, ...]:
    return logical_to_pspec(logical, mesh, ACT_RULES[rule_set], shape)


def with_logical_constraint(x: torch.Tensor,
                            logical: Sequence[Optional[str]],
                            mesh, rule_set: str = "default") -> torch.Tensor:
    """A DTensor redistributed to the activation rules' placements; a plain
    tensor unchanged.

    JAX constrains the global arrays of a jitted step and its partitioner
    inserts the collectives.  The port's step computes on each rank's
    plain local tensors (the parameters it gathered, its rows of the
    batch), where there is nothing to constrain: the constraint acts only
    on tensors that are DTensors."""
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, logical_to_placements(
        logical, mesh, ACT_RULES[rule_set], tuple(x.shape)))


def dp_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh).axis_names)


def dp_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).shape[a] for a in dp_axis_names(mesh))


# ---------------------------------------------------------------------------
# local slices, DTensors and reductions over mesh axes
# ---------------------------------------------------------------------------

def batch_axes(mesh, rule_set: str = "default") -> Tuple[str, ...]:
    """The mesh axes the batch dimension is sharded over under
    ``ACT_RULES[rule_set]`` (mesh order)."""
    ax = _resolve(ACT_RULES[rule_set]["batch"], mesh)
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def axes_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's linear index over ``axes``, major first; their size
    product) on a ``DeviceMesh``."""
    ms = mesh_shape(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        idx = idx * ms.shape[a] + coord[ms.axis_names.index(a)]
    return idx, math.prod(ms.shape[a] for a in axes)


def local_slices(shape: Sequence[int], sharding: Sharding,
                 coordinate: Optional[Sequence[int]] = None) -> tuple:
    """The slice of a tensor of ``shape`` that ``sharding`` gives the rank
    at ``coordinate`` (default: this rank's): each dimension split evenly
    over the mesh dimensions that shard it, the earlier mesh dimension
    major, as DTensor splits it."""
    ms = mesh_shape(sharding.mesh)
    if coordinate is None:
        coordinate = sharding.mesh.get_coordinate()
    out = []
    for d, n in enumerate(shape):
        idx, parts = 0, 1
        for m, pl in enumerate(sharding.placements):
            if pl.is_shard() and pl.dim == d:
                idx = idx * ms.sizes[m] + coordinate[m]
                parts *= ms.sizes[m]
        if n % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split evenly over {parts} ranks")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def from_local(local: torch.Tensor, sharding: Sharding,
               shape: Sequence[int]):
    """A DTensor of global ``shape`` whose shard on this rank is
    ``local`` (no communication)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def shard_local(full: torch.Tensor, sharding: Sharding):
    """The DTensor of ``full`` (which every rank holds whole) placed by
    ``sharding``: this rank's slice copied out, no communication."""
    local = full[local_slices(full.shape, sharding)].clone(
        memory_format=torch.contiguous_format)
    return from_local(local, sharding, full.shape)


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (``full_tensor``); a
    plain tensor unchanged."""
    return x.full_tensor() if is_dtensor(x) else x


def local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if is_dtensor(x) else x


def sum_over(x: torch.Tensor, mesh, axes: Sequence[str],
             autograd: bool = False) -> torch.Tensor:
    """``x`` summed over the ranks of the mesh ``axes`` (one all-reduce
    per axis; a sum over a product of axes is the sum over each in turn).
    ``autograd=True``: the backward sums the gradient over the same
    ranks."""
    if not axes:
        return x
    for a in axes:
        group = mesh.get_group(a)
        x = _SumOver.apply(x, group) if autograd else _all_reduce(x, group)
    return x


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _SumOver(torch.autograd.Function):
    """Sum over a group's ranks whose backward sums the gradient over the
    same ranks (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def reduce_grad(g: torch.Tensor, sharding: Sharding,
                axes: Sequence[str]):
    """The mean over the data ranks ``axes`` of a full-size gradient ``g``
    (each rank's own), as a DTensor placed by ``sharding``: ``g / n``
    partial over ``axes`` and replicated over the other mesh axes,
    redistributed (a reduce-scatter where ``sharding`` shards a data axis,
    an all-reduce where it replicates one)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = sharding.mesh
    ms = mesh_shape(mesh)
    n = math.prod(ms.shape[a] for a in axes)
    pl = [Partial() if a in axes else Replicate() for a in ms.axis_names]
    return DTensor.from_local(g / n, mesh, pl, run_check=False).redistribute(
        mesh, sharding.placements)


def sharded_sq_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of a whole tensor: a DTensor's local sum,
    summed over the mesh dimensions that shard it (a replicated leaf is
    counted once); a plain tensor's own."""
    if not is_dtensor(x):
        return x.float().square().sum()
    import torch.distributed as dist
    s = x.to_local().float().square().sum()
    for m, pl in enumerate(x.placements):
        if pl.is_shard():
            dist.all_reduce(s, group=x.device_mesh.get_group(m))
    return s
