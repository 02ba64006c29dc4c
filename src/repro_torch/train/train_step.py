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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

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


def make_train_step(model: Model, opt_cfg: OptConfig):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``, metrics ``{"loss", "aux", "grad_norm"}`` as f32
    scalar tensors."""
    rc = model.rc

    def train_step(params, opt_state, batch, step: int):
        n = rc.microbatches
        gdt = torch_dtype(rc.grad_dtype)
        if n > 1:
            micro = _split_micro(batch, n)
            grads = metrics = None
            for i in range(n):
                g, m = grads_of(model, params,
                                {k: v[i] for k, v in micro.items()})
                if grads is None:
                    grads = [torch.zeros(a.shape, dtype=gdt, device=a.device)
                             for a in _leaves(params)]
                    metrics = {k: torch.zeros_like(v) for k, v in m.items()}
                grads = [a + b.to(gdt) for a, b in zip(grads, _leaves(g))]
                metrics = {k: metrics[k] + m[k] for k in m}
                del g
            grads = _rebuild(params, [a / n for a in grads])
            metrics = {k: v / n for k, v in metrics.items()}
        else:
            grads, metrics = grads_of(model, params, batch)
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
    """One decode step against a dense KV / SSM cache."""
    def serve_step(params, state, tokens, kv_len):
        return model.decode_step(params, state, tokens, kv_len)
    return serve_step
