"""Model assembly for the dense family: config → specs, prefill, decode.

The port of the JAX package's ``models/model.py`` for ``family ==
"dense"`` (the other families raise ``NotImplementedError``; ROADMAP A8
ports their layers).  Parameters keep the JAX layout at every public
function: ``{"embed" [V, d], "blocks": {"pos0": {...}}, "final_norm",
"lm_head" [d, V]}`` with every block leaf stacked over layers.  PyTorch
runs eagerly, so the JAX scan over the stack is a Python loop over layers.

Decode state is updated in place (JAX returns a new pytree; here the KV
cache or pool would otherwise be copied every step): ``decode_step`` and
``decode_step_paged`` write the step's K/V into ``state`` and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import layers as L
from .common import Spec, count_params, init_params_numpy, tree_map
from .config import ModelConfig, RunConfig
from ..kernels.paged_attention.ops import (classes_of, paged_attention,
                                           prepare_descriptors)

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_vocab(cfg: ModelConfig) -> int:
    return _round_up(cfg.vocab, 256)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            "runs dense models only (MoE, Mamba, xLSTM and encoder layers "
            "are ROADMAP A8)")


def n_superblocks(cfg: ModelConfig) -> int:
    """Layers per stack (the dense family's block period is 1)."""
    _require_dense(cfg)
    return cfg.n_layers


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _stack(tree: PyTree, n: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    return Spec((n,) + tree.shape, ("layers",) + tree.logical,
                init=tree.init, scale=tree.scale, dtype=tree.dtype)


def model_specs(cfg: ModelConfig, rc: RunConfig) -> dict:
    _require_dense(cfg)
    d, V = cfg.d_model, padded_vocab(cfg)
    block = {"ln1": Spec((d,), (None,), init="ones"),
             "attn": L.attention_specs(cfg),
             "ln2": Spec((d,), (None,), init="ones"),
             "mlp": L.mlp_specs(cfg)}
    s: dict = {
        "embed": Spec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "blocks": _stack({"pos0": block}, n_superblocks(cfg)),
        "final_norm": Spec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((d, V), ("embed", "vocab"))
    return s


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rc: RunConfig

    def __post_init__(self):
        _require_dense(self.cfg)

    # ---- params ----
    def specs(self) -> dict:
        return model_specs(self.cfg, self.rc)

    def n_params(self) -> int:
        return count_params(self.specs())

    def init_numpy(self, seed: int = 0) -> PyTree:
        """Seeded numpy weights (:func:`.common.init_params_numpy`)."""
        return init_params_numpy(self.specs(), seed=seed,
                                 dtype=self.rc.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return torch_dtype(self.rc.compute_dtype)

    def compute_params(self, params: PyTree) -> PyTree:
        """The weights the passes multiply with: ``embed``, ``lm_head`` and
        every block leaf in the compute dtype (``final_norm`` stays as it
        is).  The JAX package casts these inside every call; the port
        casts once, and each pass's own cast is then a no-op."""
        cast = lambda a: a.to(self.cdt) if a.is_floating_point() else a  # noqa: E731
        return {k: (tree_map(cast, v) if k in ("embed", "lm_head", "blocks")
                    else v) for k, v in params.items()}

    # ---- helpers ----
    def _layer(self, params, i: int) -> dict:
        cast = lambda a: a[i].to(self.cdt) if a.is_floating_point() else a[i]  # noqa: E731
        return tree_map(cast, params["blocks"]["pos0"])

    def _embed(self, params, tokens):
        return params["embed"].to(self.cdt)[tokens.long()]

    def _logits(self, params, x):
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        logits = x @ head.to(x.dtype)
        V = padded_vocab(self.cfg)
        if V != self.cfg.vocab:  # mask padding classes
            pad = torch.arange(V, device=x.device) >= self.cfg.vocab
            logits = torch.where(pad, -1e9, logits.float())
        return logits

    def _block_tail(self, p, x):
        """Residual MLP half of a block."""
        return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], self.cfg.rms_eps))

    # ---- public passes ----
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor,
                max_seq: Optional[int] = None):
        """tokens [B, S] → (logits [B, S, V], decode state with the dense
        KV cache ``{"pos0": {"k", "v"}}`` of ``[n_layers, B, max_seq, KVH,
        D]`` filled to S tokens)."""
        cfg, rc = self.cfg, self.rc
        B, S = tokens.shape
        dev = tokens.device
        max_seq = max_seq or S
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=dev).expand(B, S)
        shape = (n_superblocks(cfg), B, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kc = torch.zeros(shape, dtype=self.cdt, device=dev)
        vc = torch.zeros(shape, dtype=self.cdt, device=dev)
        for i in range(n_superblocks(cfg)):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
            q, k, v = L.attention_qkv(cfg, p["attn"], h, positions)
            o = L.chunked_attention(q, k, v, causal=cfg.causal,
                                    q_chunk=rc.attn_q_chunk,
                                    kv_chunk=rc.attn_kv_chunk)
            x = x + o.reshape(B, S, cfg.q_dim) @ p["attn"]["wo"]
            kc[i, :, :S] = k.to(self.cdt)
            vc[i, :, :S] = v.to(self.cdt)
            x = self._block_tail(p, x)
        x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), {"pos0": {"k": kc, "v": vc}}

    @torch.no_grad()
    def decode_step(self, params, state, tokens: torch.Tensor,
                    kv_len: torch.Tensor):
        """One decode step against the dense KV cache: tokens [B, 1],
        kv_len [B] → (logits [B, 1, V], state).  Writes the step's K/V at
        position ``kv_len`` of ``state`` in place."""
        cfg = self.cfg
        B = tokens.shape[0]
        dev = tokens.device
        kv_len = torch.as_tensor(kv_len, device=dev).long()
        x = self._embed(params, tokens)
        positions = kv_len[:, None]
        bidx = torch.arange(B, device=dev)
        kc, vc = state["pos0"]["k"], state["pos0"]["v"]
        for i in range(n_superblocks(cfg)):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
            q, k, v = L.attention_qkv(cfg, p["attn"], h, positions)
            kc[i, bidx, kv_len] = k[:, 0].to(kc.dtype)
            vc[i, bidx, kv_len] = v[:, 0].to(vc.dtype)
            o = L.decode_attention(q, kc[i].to(q.dtype), vc[i].to(q.dtype),
                                   kv_len + 1)
            x = x + o.reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"]
            x = self._block_tail(p, x)
        x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), state

    @torch.no_grad()
    def decode_step_paged(self, params, state, tokens: torch.Tensor,
                          kv_len, block_tables: np.ndarray, descriptors, *,
                          page_size: int, K_classes: Sequence[int]):
        """One decode step against the PAGED KV cache (the paper's path).

        ``state``: ``{"pos0": {"pool_k", "pool_v"}}`` of shape
        ``[n_layers, n_pages, T, KVH, D]``; ``kv_len`` [B] and
        ``block_tables`` [B, max_pages] (shared by all layers) are host
        arrays; ``descriptors``: the per-class host tables of
        ``kernels.paged_attention.ops.build_descriptors``, checked and
        uploaded once for all layers.  Writes the step's K/V into the pools in
        place; a batch slot whose page is ``-1`` (an inactive slot) writes
        nothing — a raw index -1 would wrap to the last pool page, which a
        live sequence may own."""
        cfg = self.cfg
        B = tokens.shape[0]
        dev = tokens.device
        pool_k, pool_v = state["pos0"]["pool_k"], state["pos0"]["pool_v"]
        n_pool = pool_k.shape[1]
        kv_host = np.asarray(kv_len.cpu() if isinstance(kv_len, torch.Tensor)
                             else kv_len, dtype=np.int64)
        bt = np.asarray(block_tables)
        prep = prepare_descriptors(descriptors, classes_of(K_classes),
                                   n_pool, dev)
        page_of = bt[np.arange(B), kv_host // page_size]
        rows = np.flatnonzero(page_of >= 0)
        rows_t = torch.from_numpy(rows).to(dev)
        pages_t = torch.from_numpy(page_of[rows].astype(np.int64)).to(dev)
        offs_t = torch.from_numpy(kv_host[rows] % page_size).to(dev)
        lens_t = torch.from_numpy((kv_host + 1).astype(np.int32)).to(dev)
        positions = torch.from_numpy(kv_host).to(dev)[:, None]
        x = self._embed(params, tokens)
        for i in range(n_superblocks(cfg)):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
            q, k, v = L.attention_qkv(cfg, p["attn"], h, positions)
            pk, pv = pool_k[i], pool_v[i]
            pk[pages_t, offs_t] = k[rows_t, 0].to(pk.dtype)
            pv[pages_t, offs_t] = v[rows_t, 0].to(pv.dtype)
            o = paged_attention(q[:, 0].contiguous(), pk, pv, None, lens_t,
                                page_size=page_size, descriptors=prep)
            x = x + o.to(h.dtype).reshape(B, 1, cfg.q_dim) @ p["attn"]["wo"]
            x = self._block_tail(p, x)
        x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
        return self._logits(params, x), state


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cpu") -> dict:
    """Zero dense KV cache for :meth:`Model.decode_step`."""
    shape = (n_superblocks(cfg), batch, max_seq, cfg.n_kv_heads,
             cfg.head_dim)
    return {"pos0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}
