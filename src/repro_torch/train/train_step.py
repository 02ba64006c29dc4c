"""Train step: loss, gradient accumulation (microbatching), optimizer apply.

The port of the JAX package's ``train/train_step.py``.  Gradients come
from autograd through :meth:`..models.model.Model.loss` with the
parameters as leaves that require grad; a parameter the loss does not
reach (the encoder's token embedding, which ``input_embeds`` bypasses)
gets a zero gradient, as ``jax.grad`` gives it, so that the optimizer
treats every leaf alike.  Microbatching splits the global batch ``[B,
...]`` into ``rc.microbatches`` slices of ``B / n`` and accumulates their
gradients in ``rc.grad_dtype``, one slice after another (the JAX
``lax.scan``).

With ``param_shardings`` (parameters and optimizer state as DTensors, a
tree of ``Sharding`` over one ``DeviceMesh``) the step is sharded, with
the semantics of the JAX step on global arrays.  Along the data axes it
is data-parallel: each rank takes its rows of each *global* microbatch
(rows ``[i B/n, (i+1) B/n)`` make microbatch i, and the data ranks split
each in order) and runs the loss of a model on the mesh, so the masked
mean's denominator and the MoE balance loss are the global
microbatch's (:class:`..models.model.Model`).  Along ``"model"`` it is
tensor-parallel: each parameter is gathered over the data axes only
(``gather_data``), keeping this rank's model shard, and the model
computes on it (Megatron heads, SwiGLU and expert columns, vocabulary
rows: :mod:`..distributed.tensor_parallel`); a parameter whose layer has
no tensor-parallel form (the Mamba and xLSTM mixers, attention whose
heads do not split evenly over the model ranks:
:func:`..models.model.whole_along_model`) is gathered whole. The
gradients, accumulated as above, are each rank's model shard (or the
whole leaf's), averaged over the data ranks into the placements of the
parameters (a reduce-scatter where a leaf is sharded over a data axis),
and the optimizer updates each rank's shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..checkpoint.checkpointer import leaf_paths, rebuild
from ..distributed.sharding import (axes_index, batch_axes, gather,
                                    is_device_mesh, is_dtensor, reduce_grad)
from ..models.common import tree_leaves, tree_map
from ..models.config import ModelConfig
from ..models.model import Model, torch_dtype
from ..optim.optimizer import OptConfig, apply_opt

PyTree = Any

MOE_AUX_COEF = 0.01


def make_batch_shapes(cfg: ModelConfig, batch: int, seq: int
                      ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """The input batch of this architecture: ``{name: (shape, dtype)}``."""
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "encoder":
        return {"input_embeds": ((batch, seq, cfg.d_model), f32),
                "labels": ((batch, seq), i32),
                "mask": ((batch, seq), f32)}
    out = {"tokens": ((batch, seq), i32), "labels": ((batch, seq), i32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = ((batch, cfg.n_patches, cfg.d_model), f32)
    return out


def batch_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of :func:`make_batch_shapes`' batch."""
    if cfg.family == "encoder":
        return {"input_embeds": ("batch", "seq", None),
                "labels": ("batch", "seq"), "mask": ("batch", "seq")}
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        out["patch_embeds"] = ("batch", None, None)
    return out


def loss_fn(model: Model, params: PyTree, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss + ``MOE_AUX_COEF`` * aux, {"loss", "aux"})."""
    if model.cfg.family == "encoder":
        loss, aux = model.loss(params, None, batch["labels"],
                               mask=batch.get("mask"),
                               input_embeds=batch["input_embeds"])
    else:
        loss, aux = model.loss(params, batch["tokens"], batch["labels"],
                               patch_embeds=batch.get("patch_embeds"))
    return loss + MOE_AUX_COEF * aux, {"loss": loss, "aux": aux}


def _split_micro(batch: Dict[str, torch.Tensor], n: int
                 ) -> Dict[str, torch.Tensor]:
    def f(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             "microbatches")
        return x.reshape((n, B // n) + tuple(x.shape[1:]))
    return {k: f(v) for k, v in batch.items()}


def _leaves(tree: PyTree) -> list:
    return [x for _, x in tree_leaves(tree)]


def _rebuild(tree: PyTree, values) -> PyTree:
    """``tree``'s structure with its leaves, in order, from ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def grads_of(model: Model, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> Tuple[PyTree, Dict[str, torch.Tensor]]:
    """(d total / d params as a tree of params' shape and dtype, the
    metrics {"loss", "aux"} detached)."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(model, _rebuild(params, leaves), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (_rebuild(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def _accumulate(model: Model, params: PyTree, micro, n: int):
    """(gradients, metrics) of the microbatches ``micro(i)``, i < n: one
    microbatch's own; or summed in ``grad_dtype`` and divided by n."""
    if n == 1:
        return grads_of(model, params, micro(0))
    gdt = torch_dtype(model.rc.grad_dtype)
    grads = metrics = None
    for i in range(n):
        g, m = grads_of(model, params, micro(i))
        if grads is None:
            grads = [torch.zeros(a.shape, dtype=gdt, device=a.device)
                     for a in _leaves(params)]
            metrics = {k: torch.zeros_like(v) for k, v in m.items()}
        grads = [a + b.to(gdt) for a, b in zip(grads, _leaves(g))]
        metrics = {k: metrics[k] + m[k] for k in m}
        del g
    return (_rebuild(params, [a / n for a in grads]),
            {k: v / n for k, v in metrics.items()})


def make_train_step(model: Model, opt_cfg: OptConfig,
                    param_shardings: PyTree = None):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``, metrics ``{"loss", "aux", "grad_norm"}`` as f32
    scalar tensors.  ``param_shardings``: the sharded step over
    DTensor parameters (the module's docstring)."""
    if param_shardings is not None:
        return _sharded_train_step(model, opt_cfg, param_shardings)
    n = model.rc.microbatches

    def train_step(params, opt_state, batch, step: int):
        micro = _split_micro(batch, n) if n > 1 else None
        grads, metrics = _accumulate(
            model, params,
            (lambda i: {k: v[i] for k, v in micro.items()}) if n > 1
            else (lambda i: batch), n)
        new_params, new_opt, gnorm = apply_opt(opt_cfg, grads, opt_state,
                                               params, step)
        return new_params, new_opt, dict(metrics, grad_norm=gnorm)

    return train_step


def mesh_of(shardings: PyTree):
    """The one ``DeviceMesh`` of a tree of ``Sharding``."""
    meshes = {id(sh.mesh): sh.mesh for _, sh in leaf_paths(shardings)}
    if len(meshes) != 1:
        raise ValueError(f"shardings span {len(meshes)} meshes; want one")
    mesh = next(iter(meshes.values()))
    if not is_device_mesh(mesh):
        raise ValueError("shardings of a MeshShape place nothing: build "
                         "them over a DeviceMesh")
    return mesh


def _sharded_train_step(model: Model, opt_cfg: OptConfig,
                        shardings: PyTree):
    mesh = mesh_of(shardings)
    if model.mesh is not None and model.mesh is not mesh:
        raise ValueError("the model's mesh is not the shardings' mesh")
    dp_model = dataclasses.replace(model, mesh=mesh)
    axes = batch_axes(mesh, model.act_rules)
    rank, n_dp = axes_index(mesh, axes)
    n = model.rc.microbatches
    places = dict(leaf_paths(shardings))

    def rows(x, i):
        """This rank's rows of global microbatch i of batch leaf x (a
        DTensor's own shard where that is exactly them)."""
        if is_dtensor(x) and n == 1 and all(
                (pl.is_shard() and pl.dim == 0) == (a in axes)
                for a, pl in zip(mesh.mesh_dim_names, x.placements)):
            return x.to_local()
        x = gather(x)
        B = x.shape[0]
        if B % (n * n_dp):
            raise ValueError(f"batch {B} does not split into {n} "
                             f"microbatches over {n_dp} data ranks")
        bm = B // (n * n_dp)
        start = i * (B // n) + rank * bm
        return x[start:start + bm]

    def train_step(params, opt_state, batch, step: int):
        local = dp_model.local_params(params)
        grads, metrics = _accumulate(
            dp_model, local, lambda i: {k: rows(v, i)
                                        for k, v in batch.items()}, n)
        del local
        held = dict(leaf_paths(params))
        grads = rebuild(params, {
            path: reduce_grad(g, places[path], axes, held[path].shape)
            for path, g in leaf_paths(grads)})
        new_params, new_opt, gnorm = apply_opt(opt_cfg, grads, opt_state,
                                               params, step)
        return new_params, new_opt, dict(metrics, grad_norm=gnorm)

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        if model.cfg.family == "encoder":
            with torch.no_grad():
                logits, _ = model.forward(params, None,
                                          input_embeds=batch["input_embeds"])
            return logits
        return model.prefill(params, batch["tokens"],
                             patch_embeds=batch.get("patch_embeds"))
    return prefill_step


def make_serve_step(model: Model):
    """One decode step against a dense KV / SSM cache
    (:meth:`..models.model.Model.decode_step`; on a model with a mesh,
    tokens and kv_len are this rank's rows and the state is placed by the
    rules under the model's ``act_rules``)."""
    def serve_step(params, state, tokens, kv_len):
        return model.decode_step(params, state, tokens, kv_len)
    return serve_step
