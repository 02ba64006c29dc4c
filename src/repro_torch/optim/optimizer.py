"""Optimizers: AdamW, AdamW-8bit (block-quantized first moment), Adafactor.

The port of the JAX package's ``optim/optimizer.py``, pure-functional as
there: ``init_opt(cfg, params) -> state`` and ``apply_opt(cfg, grads,
state, params, step) -> (new_params, new_state, grad_norm)`` over nested
dicts of tensors, each leaf's update in f32 (f32 scalars where the JAX
code's weak types give f32).  The 8-bit variant stores m as int8 with one
f32 scale per block of 256 along the last axis and v in bfloat16.
``abstract_opt`` (meta tensors) and ``opt_logical`` mirror ``init_opt``
leaf for leaf, for the state's shardings.

Sharded leaves (DTensors, :mod:`..distributed.sharding`) update to the
bits of the unsharded update: the global norm sums each leaf's local
squares over the mesh dimensions that shard it, so a replicated leaf
counts once; a leaf whose update is elementwise on its shard (AdamW;
AdamW8bit where no placement splits the last axis, whose 256-wide blocks
would straddle shards) updates its local tensors; any other (AdamW8bit
split on the last axis, Adafactor's row and column means and update RMS
over a sharded leaf) is gathered whole, updated, and sliced back — one
leaf's state at a time on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.checkpointer import leaf_paths, rebuild
from ..distributed.sharding import (Sharding, gather, is_dtensor, local,
                                    shard_local, sharded_sq_sum)
from ..models.common import tree_map as _map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adamw8bit | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _field(tree: PyTree, i: int) -> PyTree:
    """Element ``i`` of every tuple leaf of a tree of tuples."""
    return _map(lambda t: t[i], tree)


def sorted_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


def schedule(cfg: OptConfig, step: int) -> np.float32:
    """Learning rate at ``step``: linear warmup over ``warmup_steps``, then
    a cosine down to ``min_lr_frac`` of ``lr`` at ``total_steps`` (f32
    arithmetic, as the JAX package's)."""
    f = np.float32
    s = f(step)
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((s - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * t))
    frac = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * cos
    return f(cfg.lr) * warm * frac


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves added in
    the JAX leaf order."""
    total = None
    for x in sorted_leaves(tree):
        sq = sharded_sq_sum(x)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Grads scaled to a global norm of at most ``max_norm``, and the norm
    before (a DTensor's local tensor scaled, placements kept)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)

    def one(g):
        if is_dtensor(g):
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(g.to_local() * scale.to(g.dtype),
                                      g.device_mesh, g.placements,
                                      run_check=False, shape=g.shape,
                                      stride=g.stride())
        return g * scale.to(g.dtype)
    return _map(one, grads), norm


# ---------------------------------------------------------------------------
# int8 block quantization (for 8-bit moments); blocks run along the last
# axis only, so quantized moments keep the param's leading dims
# ---------------------------------------------------------------------------

QBLOCK = 256


def _q8_shapes(shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    last = shape[-1] if shape else 1
    padded = -(-last // QBLOCK) * QBLOCK
    return (tuple(shape[:-1]) + (padded,),
            tuple(shape[:-1]) + (padded // QBLOCK,))


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x → (int8 q of the padded shape, f32 scale per block): q =
    clip(round(x / scale), -127, 127) with ``torch.round``'s half-to-even,
    as ``jnp.round``; scale = max(|block|, 1e-12) / 127."""
    qshape, sshape = _q8_shapes(x.shape)
    pad = qshape[-1] - x.shape[-1]
    xp = torch.nn.functional.pad(x.float(), (0, pad))
    blk = xp.reshape(sshape + (QBLOCK,))
    amax = blk.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(blk / scale), -127, 127).to(torch.int8)
    return q.reshape(qshape), scale[..., 0].float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    sshape = scale.shape
    blk = q.reshape(sshape + (QBLOCK,)).float() * scale[..., None]
    return blk.reshape(sshape[:-1] + (-1,))[..., : shape[-1]]


# ---------------------------------------------------------------------------
# AdamW family
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    m: PyTree
    v: PyTree
    m_scale: Optional[PyTree]   # None for fp32 m


def init_adam(params: PyTree, kind: str = "adamw") -> AdamState:
    if kind == "adamw8bit":
        qs = _map(lambda p: _q8(torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)), params)
        v = _map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                       device=p.device), params)
        return AdamState(_field(qs, 0), v, _field(qs, 1))
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamState(_map(zeros, params), _map(zeros, params), None)


def adam_update(cfg: OptConfig, grads: PyTree, state: AdamState,
                params: PyTree, step: int) -> Tuple[PyTree, AdamState]:
    lr = float(schedule(cfg, step))
    t = np.float32(step) + np.float32(1)
    c1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
    c2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
    eight_bit = state.m_scale is not None

    def upd(p, g, m, v, ms=None):
        g32 = g.float()
        m32 = _dq8(m, ms, p.shape) if eight_bit else m
        v32 = v.float()
        m32 = cfg.b1 * m32 + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v32 + (1 - cfg.b2) * g32.square()
        upd_ = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            upd_ = upd_ + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * upd_).to(p.dtype)
        if eight_bit:
            qm, qs = _q8(m32)
            return new_p, qm, qs, v32.to(torch.bfloat16)
        return new_p, m32, None, v32

    if eight_bit:
        out = _map(upd, params, grads, state.m, state.v, state.m_scale)
        return _field(out, 0), AdamState(_field(out, 1), _field(out, 3),
                                         _field(out, 2))
    out = _map(upd, params, grads, state.m, state.v)
    return _field(out, 0), AdamState(_field(out, 1), _field(out, 3), None)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for >=2D params)
# ---------------------------------------------------------------------------

class FactorState(NamedTuple):
    vr: PyTree
    vc: PyTree
    v: PyTree      # unfactored fallback for <2D


def init_adafactor(params: PyTree) -> FactorState:
    def z(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def rows(p):
        return z(p.shape[:-1], p) if p.dim() >= 2 else z((1,), p)

    def cols(p):
        return (z(p.shape[:-2] + p.shape[-1:], p) if p.dim() >= 2
                else z((1,), p))

    def full(p):
        return z((1,), p) if p.dim() >= 2 else z(p.shape, p)
    return FactorState(_map(rows, params), _map(cols, params),
                       _map(full, params))


def adafactor_update(cfg: OptConfig, grads: PyTree, state: FactorState,
                     params: PyTree, step: int
                     ) -> Tuple[PyTree, FactorState]:
    lr = float(schedule(cfg, step))
    t = np.float32(step) + np.float32(1)
    beta2 = float(np.float32(1) - t ** np.float32(-0.8))

    def upd(p, g, vr, vc, v):
        g32 = g.float()
        g2 = g32.square() + 1e-30
        if p.dim() >= 2:
            vr = beta2 * vr + (1 - beta2) * g2.mean(-1)
            vc = beta2 * vc + (1 - beta2) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(-1, keepdim=True)[..., None],
                                       1e-30))
            u = g32 / torch.sqrt(denom + 1e-30)
        else:
            v = beta2 * v + (1 - beta2) * g2
            u = g32 / torch.sqrt(v + 1e-30)
        # update clipping (Shazeer & Stern)
        rms_u = torch.sqrt(u.square().mean() + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        if p.dim() >= 2:
            u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), vr, vc, v

    out = _map(upd, params, grads, state.vr, state.vc, state.v)
    return _field(out, 0), FactorState(_field(out, 1), _field(out, 2),
                                       _field(out, 3))


# ---------------------------------------------------------------------------
# unified front-end
# ---------------------------------------------------------------------------

def init_opt(cfg: OptConfig, params: PyTree):
    if cfg.kind in ("adamw", "adamw8bit"):
        return init_adam(params, cfg.kind)
    if cfg.kind == "adafactor":
        return init_adafactor(params)
    raise ValueError(cfg.kind)


def abstract_opt(cfg: OptConfig, abstract_params: PyTree):
    """``init_opt``'s tree as meta tensors (no storage), from a tree of
    meta tensors (:func:`..models.common.spec_shapes`)."""
    if cfg.kind not in ("adamw", "adamw8bit", "adafactor"):
        raise ValueError(cfg.kind)
    return init_opt(cfg, _map(lambda p: torch.empty(
        p.shape, dtype=p.dtype, device="meta"), abstract_params))


def opt_logical(cfg: OptConfig, param_logical: PyTree):
    """Logical axes for the opt state (mirrors :func:`abstract_opt`).

    Moment tensors inherit the param's logical axes (same rank); factored /
    scale tensors inherit sliced axes; non-divisible dims fall back to
    replication inside ``logical_to_pspec``'s divisibility check.
    """
    if cfg.kind == "adamw":
        m = _map(lambda lg: lg, param_logical)
        return AdamState(m, m, None)
    if cfg.kind == "adamw8bit":
        m = _map(lambda lg: lg, param_logical)
        return AdamState(m, m, m)
    if cfg.kind == "adafactor":
        rows = _map(lambda lg: lg[:-1] or (None,), param_logical)
        cols = _map(lambda lg: (lg[:-2] + lg[-1:]) if len(lg) >= 2
                    else (None,), param_logical)
        full = _map(lambda lg: (None,) if len(lg) >= 2 else lg,
                    param_logical)
        return FactorState(rows, cols, full)
    raise ValueError(cfg.kind)


def _update_one(cfg: OptConfig, p, g, comps, step: int):
    """One leaf's update on plain tensors → (new p, new state components
    in ``comps``' order)."""
    if cfg.kind in ("adamw", "adamw8bit"):
        m, v, ms = (comps + [None])[:3]
        new_p, st = adam_update(cfg, {"x": g}, AdamState(
            {"x": m}, {"x": v}, None if ms is None else {"x": ms}),
            {"x": p}, step)
        out = [st.m["x"], st.v["x"]] + (
            [] if ms is None else [st.m_scale["x"]])
        return new_p["x"], out
    vr, vc, v = comps
    new_p, st = adafactor_update(cfg, {"x": g}, FactorState(
        {"x": vr}, {"x": vc}, {"x": v}), {"x": p}, step)
    return new_p["x"], [st.vr["x"], st.vc["x"], st.v["x"]]


def _elementwise_on_shards(cfg: OptConfig, p, comps) -> bool:
    """Whether ``p``'s update on its shard and its state's shards is the
    unsharded update's: every tensor placed alike, and none of the
    update's reductions crossing a shard."""
    if any(c.placements != p.placements for c in comps):
        return False
    shards = [pl.dim for pl in p.placements if pl.is_shard()]
    if cfg.kind == "adamw":
        return True
    if cfg.kind == "adamw8bit":
        return p.dim() - 1 not in shards
    return not shards


def _apply_sharded(cfg: OptConfig, grads: PyTree, state, params: PyTree,
                   step: int):
    """:func:`apply_opt` over DTensor leaves (the module's docstring)."""
    fields = [f for f in state._fields if getattr(state, f) is not None]
    comp = {f: dict(leaf_paths(getattr(state, f))) for f in fields}
    new_p, new_s = {}, {}
    for (path, p), (_, g) in zip(leaf_paths(params), leaf_paths(grads)):
        cs = [comp[f][path] for f in fields]
        if _elementwise_on_shards(cfg, p, cs):
            np_, ncs = _update_one(cfg, local(p), local(g),
                                   [local(c) for c in cs], step)
            from torch.distributed.tensor import DTensor
            wrap = [DTensor.from_local(x, a.device_mesh, a.placements,
                                       run_check=False, shape=a.shape,
                                       stride=a.stride())
                    for x, a in zip([np_] + ncs, [p] + cs)]
        else:
            np_, ncs = _update_one(cfg, gather(p), gather(g),
                                   [gather(c) for c in cs], step)
            wrap = [shard_local(x, Sharding(a.device_mesh, a.placements))
                    for x, a in zip([np_] + ncs, [p] + cs)]
        new_p[path] = wrap[0]
        for f, x in zip(fields, wrap[1:]):
            new_s[f"{f}/{path}"] = x
    return rebuild(params, new_p), rebuild(state, new_s)


@torch.no_grad()
def apply_opt(cfg: OptConfig, grads: PyTree, state, params: PyTree,
              step: int):
    """Clip ``grads`` to ``clip_norm`` by their global norm, then one
    update → (new params, new state, the norm before clipping).  Leaves
    may be DTensors (the module's docstring)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    if any(is_dtensor(p) for p in sorted_leaves(params)):
        new_p, new_s = _apply_sharded(cfg, grads, state, params, step)
    elif cfg.kind in ("adamw", "adamw8bit"):
        new_p, new_s = adam_update(cfg, grads, state, params, step)
    else:
        new_p, new_s = adafactor_update(cfg, grads, state, params, step)
    return new_p, new_s, gnorm
