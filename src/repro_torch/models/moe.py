"""Mixture-of-Experts FFN with sort-based top-k dispatch.

The port of the JAX package's ``models/moe.py`` (``moe_specs``,
``_dispatch_indices``, ``moe_ffn``).  On a ``DeviceMesh`` the balance
loss's means run over the global batch: each data rank's router means
and expert counts are summed over the data ranks (the means by a sum
whose backward sums the gradient over the same ranks), as the JAX means run over the global arrays.  The
dispatch is the MegaBlocks/GShard-style capacity-bounded gather, per group
(a group is one sequence of the batch):

  1. router logits → the top-k experts of each token, their gates
     renormalised to sum to 1;
  2. the group's ``S * k`` assignments sorted by expert id (stably);
  3. rank within expert = position in sorted order − the expert's segment
     start; an assignment past ``capacity = max(ceil(S k f / E), 4)``
     (``f = RunConfig.capacity_factor``, S the call's own length) goes to
     the drop bucket ``E * C``;
  4. tokens scattered into an ``[E, C, d]`` buffer, one batched product
     per expert, and each token's kept outputs summed with its gates.

Shared experts (qwen2-moe) run as one dense SwiGLU behind a sigmoid gate.
The JAX package computes the expert products outside any Pallas kernel;
here they are ``torch.bmm``.  Three places where the two frameworks' own
operations differ are written out so that both compute the same thing:
``jax.lax.top_k`` breaks ties to the lower index (here a stable sort of
the descending probabilities), ``jnp.argsort`` is stable (here
``stable=True``), and the combine's ``.at[tok_idx].add`` adds a token's k
outputs in order (here k explicit adds; ``index_add_`` on the card would
add them by atomics, in no fixed order).  Routing depends only on the
group's own tokens, so junk in an inactive batch slot never reaches a
live row.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (axes_index, batch_axes, is_device_mesh,
                                    sum_over, with_logical_constraint)
from .common import Spec
from .config import ModelConfig, RunConfig


def moe_specs(cfg: ModelConfig, rc: RunConfig) -> dict:
    """The JAX package's expert-weight tree, logical axes included (its
    two layouts, experts on the data axis when ``E % 16 == 0`` and
    ``d_model`` there otherwise, only name the axes)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if E % 16 == 0:
        wl = ("expert", None, "mlp")
        wl_down = ("expert", "mlp", None)
    else:
        wl = (None, "embed", "mlp")
        wl_down = (None, "mlp", "embed")
    s = {
        "router": Spec((d, E), ("embed", None)),
        "w_gate": Spec((E, d, ff), wl),
        "w_up": Spec((E, d, ff), wl),
        "w_down": Spec((E, ff, d), wl_down),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        s["shared"] = {
            "w_gate": Spec((d, sff), ("embed", "mlp")),
            "w_up": Spec((d, sff), ("embed", "mlp")),
            "w_down": Spec((sff, d), ("mlp", "embed")),
            "gate": Spec((d, 1), ("embed", None)),
        }
    return s


def _dispatch_indices(expert_ids: torch.Tensor, E: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert_ids: ``[..., A]`` assignments of one group per leading index →
    (slot index in ``[E * C]``, keep mask), both ``[..., A]``; a dropped
    assignment's slot is ``E * C`` (the drop bucket)."""
    A = expert_ids.shape[-1]
    dev = expert_ids.device
    e = expert_ids.long()
    order = torch.argsort(e, dim=-1, stable=True)
    sorted_e = torch.gather(e, -1, order)
    # rank within expert: position - start of this expert's segment
    experts = torch.arange(E, device=dev).expand(*e.shape[:-1], E)
    seg_start = torch.searchsorted(sorted_e.contiguous(),
                                   experts.contiguous(), side="left")
    rank_sorted = (torch.arange(A, device=dev)
                   - torch.gather(seg_start, -1, sorted_e))
    rank = torch.empty_like(e).scatter_(-1, order, rank_sorted)
    keep = rank < capacity
    slot = e * capacity + torch.clamp_max(rank, capacity - 1)
    return torch.where(keep, slot, E * capacity), keep


def route(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router probabilities [..., E] → (gates, experts), both [..., k]: the
    k most probable experts, ties to the lower expert index as
    ``jax.lax.top_k`` breaks them (a stable sort of the descending
    probabilities), their gates renormalised to sum to 1."""
    expert_ids = torch.argsort(probs, dim=-1, descending=True,
                               stable=True)[..., :k]
    gate_vals = torch.gather(probs, -1, expert_ids)
    return gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                       1e-9), expert_ids


def capacity_of(cfg: ModelConfig, rc: RunConfig, S: int) -> int:
    """Expert capacity of a group of ``S`` tokens: ``max(ceil(S k f / E),
    4)``, in the JAX package's float arithmetic."""
    A = S * cfg.top_k
    return max(int(math.ceil(A * rc.capacity_factor / cfg.n_experts)), 4)


def router_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] → the router's f32 probabilities [B, S, E]."""
    return torch.softmax((x @ p["router"]).float(), dim=-1)


def moe_ffn(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor,
            mesh=None, act_rules: str = "default"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] → (y [B, S, d] in x's dtype, aux: the f32 scalar
    load-balance loss, Switch's ``E * sum_e f_e p_e``)."""
    probs = router_probs(p, x)
    return moe_experts(cfg, rc, p, x, probs, *route(probs, cfg.top_k),
                       mesh=mesh, act_rules=act_rules)


def moe_experts(cfg: ModelConfig, rc: RunConfig, p: dict, x: torch.Tensor,
                probs: torch.Tensor, gate_vals: torch.Tensor,
                expert_ids: torch.Tensor, mesh=None,
                act_rules: str = "default"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` after routing: x [B, S, d] through the experts
    ``expert_ids`` [B, S, k] picked from ``probs`` [B, S, E] with gates
    ``gate_vals`` [B, S, k] (:func:`route`), dispatched per group within
    the call's capacity, plus the shared experts → (y, aux).  On a
    ``DeviceMesh`` x is this data rank's rows and aux is the global
    batch's (the module's docstring)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    if rc.moe_weight_gather and 3 * E * d * cfg.d_ff * 2 < 2e9:
        # inference: small expert stacks replicated over the data axes at
        # use (the identity on plain tensors)
        w_gate = with_logical_constraint(w_gate, (None, None, "mlp"),
                                         mesh, act_rules)
        w_up = with_logical_constraint(w_up, (None, None, "mlp"),
                                       mesh, act_rules)
        w_down = with_logical_constraint(w_down, (None, "mlp", None),
                                         mesh, act_rules)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((B, E), dtype=torch.float32, device=dev)
    ce.scatter_add_(1, expert_ids.reshape(B, -1),
                    torch.ones((B, S * k), dtype=torch.float32, device=dev))
    counts = ce.sum(0)
    axes = batch_axes(mesh, act_rules) if is_device_mesh(mesh) else ()
    if axes:
        n = axes_index(mesh, axes)[1]
        me = sum_over(me, mesh, axes, autograd=True) / n
        counts = sum_over(counts, mesh, axes)
        T = T * n
    aux = E * torch.sum(me * (counts / (T * k)))

    A = S * k                                         # assignments/group
    C = capacity_of(cfg, rc, S)
    flat_e = expert_ids.reshape(B, A)
    slot, keep = _dispatch_indices(flat_e, E, C)      # [B, A]
    tok_idx = torch.arange(S, device=dev).repeat_interleave(k)   # [A]

    # scatter tokens into per-group expert buffers (+1 drop row)
    bidx = torch.arange(B, device=dev)[:, None]
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=dev)
    buf[bidx, slot] = x[:, tok_idx]
    eb = buf[:, :E * C].reshape(B, E, C, d).transpose(0, 1).reshape(
        E, B * C, d)                                  # [E, B*C, d]

    h = F.silu(torch.bmm(eb, w_gate)) * torch.bmm(eb, w_up)
    out = torch.bmm(h, w_down)                        # [E, B*C, d]
    flat_out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)

    # combine: each token's kept outputs times their gates, added in k order
    g = flat_out[bidx, torch.clamp_max(slot, E * C - 1)]       # [B, A, d]
    g = torch.where(keep[..., None], g, torch.zeros((), dtype=g.dtype,
                                                    device=dev))
    gw = (g * gate_vals.reshape(B, A, 1).to(g.dtype)).reshape(B, S, k, d)
    y = torch.zeros((B, S, d), dtype=g.dtype, device=dev)
    for j in range(k):
        y = y + gw[:, :, j]

    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        ys = hs @ sp["w_down"]
        gs = torch.sigmoid((x @ sp["gate"]).float()).to(ys.dtype)
        y = y + gs * ys

    return y.to(x.dtype), aux
