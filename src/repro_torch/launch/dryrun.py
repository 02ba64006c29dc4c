"""The dry-run's per-cell policy and its analytic memory model.

The part of the JAX package's ``launch/dryrun.py`` that reads only the
config, the shape and the mesh's sizes: :func:`cell_runconfig` (the
microbatching, optimizer, dtype and chunking policy of a cell),
:func:`act_rules_for` and :func:`analytic_memory_bytes` with its two byte
helpers, copied.  The rest of that module lowers and compiles each cell
with XLA and reads the HLO (``memory_analysis``, ``cost_analysis``, the
collective parser, ``hlo_analysis.py``) against hardware constants of
the JAX package's own target; none of it has a counterpart in PyTorch,
and no hardware constant is copied (``docs/port.md``).  ``mesh`` is a
``DeviceMesh`` or a :class:`..distributed.sharding.MeshShape`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..configs import ShapeSpec
from ..distributed.sharding import dp_size
from ..models.config import ModelConfig, RunConfig


# ---------------------------------------------------------------------------
# per-cell execution policy (microbatching, optimizer, dtypes, rules)
# ---------------------------------------------------------------------------

def cell_runconfig(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   rules: str = "default",
                   microbatches: Optional[int] = None,
                   overrides: Optional[Dict[str, Any]] = None) -> RunConfig:
    dp = dp_size(mesh)
    rc = RunConfig()
    kw: Dict[str, Any] = dict(rules=rules)
    if shape.kind == "train":
        # auto-microbatching: keep per-layer saved activations ~<=2GB/device
        b_loc = max(shape.global_batch // dp, 1)
        bytes_per_layer_carry = (b_loc * shape.seq_len * cfg.d_model * 2)
        saved = bytes_per_layer_carry * cfg.n_layers
        micro = 1
        while saved / micro > 2e9 and micro < b_loc:
            micro *= 2
        kw.update(microbatches=(microbatches or micro),
                  param_dtype="float32", compute_dtype="bfloat16")
        if cfg.param_count() > 1e11:      # jamba-398B: factored opt + bf16
            kw.update(optimizer="adafactor", param_dtype="bfloat16",
                      grad_dtype="bfloat16", scan_chunk=128)
        kw.update(attn_q_chunk=512, attn_kv_chunk=1024, scan_chunk=256)
    elif shape.kind == "prefill":
        kw.update(param_dtype="bfloat16", compute_dtype="bfloat16",
                  attn_q_chunk=1024, attn_kv_chunk=2048, scan_chunk=512,
                  remat="none")
        # chunked prefill when per-device activation transients get large
        b_loc = max(shape.global_batch // dp, 1)
        est = b_loc * shape.seq_len * cfg.d_model * 24
        chunks = 1
        while est / chunks > 4e9 and chunks < 8:
            chunks *= 2
        kw.update(prefill_seq_chunks=chunks)
    else:  # decode
        kw.update(param_dtype="bfloat16", compute_dtype="bfloat16",
                  remat="none")
        if shape.seq_len >= 100_000:
            kw.update(rules=rules if rules != "default" else "default")
    if overrides:
        kw.update(overrides)
    return rc.replace(**kw)


def act_rules_for(shape: ShapeSpec) -> str:
    if shape.kind == "decode":
        return "decode_long" if shape.seq_len >= 100_000 else "decode"
    return "default"


# ---------------------------------------------------------------------------
# analytic memory-traffic model (per device per step, bytes)
#
# The JAX package sets this model beside two estimates parsed from the
# compiled HLO; the port has no HLO, so the model is its only estimate:
# weights + activations + KV + optimizer state, from the config and the
# shape alone.
# ---------------------------------------------------------------------------

ACT_TENSORS_PER_LAYER = 14      # d-sized tensor reads+writes per token, fwd
REMAT_FACTOR = 1.5              # full remat: fwd recompute in bwd


def _param_bytes_per_chip(cfg: ModelConfig, rc: RunConfig, n_chips: int) -> float:
    bs = {"float32": 4, "bfloat16": 2}[rc.param_dtype]
    return cfg.param_count() * bs / n_chips


def _opt_bytes_per_chip(cfg: ModelConfig, rc: RunConfig, n_chips: int) -> float:
    n = cfg.param_count() / n_chips
    return {"adamw": 8 * n, "adamw8bit": 3.02 * n,
            "adafactor": 0.02 * n}[rc.optimizer]


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeSpec, rc: RunConfig,
                          n_chips: int, dp: int) -> Dict[str, float]:
    W = _param_bytes_per_chip(cfg, rc, n_chips)
    ab = 2  # bf16 activations
    d = cfg.d_model
    L = cfg.n_layers
    L_attn = cfg.n_attn_layers
    if shape.kind == "train":
        micro = rc.microbatches
        tok_chip = shape.global_batch * shape.seq_len / dp   # per chip, step
        # weights: fwd + bwd + remat-recompute reads, per microbatch
        weights = (2 + REMAT_FACTOR) * W * micro
        acts = (tok_chip * L * d * ab * ACT_TENSORS_PER_LAYER
                * (1 + 1 + (REMAT_FACTOR - 1)))
        # flash attention: each q-block re-reads K,V (causal: half on avg)
        nq = max(shape.seq_len // rc.attn_q_chunk, 1)
        attn = (tok_chip / max(shape.seq_len, 1)) * nq * (shape.seq_len / 2) \
            * cfg.kv_dim * 2 * ab * L_attn * 2
        grads = 2.0 * 4 * cfg.param_count() / n_chips * micro  # fp32 accum r/w
        opt = 2 * W + 2 * _opt_bytes_per_chip(cfg, rc, n_chips)
        total = weights + acts + attn + grads + opt
        return dict(weights=weights, activations=acts, attention=attn,
                    grads=grads, optimizer=opt, total=total)
    if shape.kind == "prefill":
        tok_chip = shape.global_batch * shape.seq_len / dp
        weights = W
        acts = tok_chip * L * d * ab * ACT_TENSORS_PER_LAYER
        nq = max(shape.seq_len // rc.attn_q_chunk, 1)
        attn = (tok_chip / max(shape.seq_len, 1)) * nq * (shape.seq_len / 2) \
            * cfg.kv_dim * 2 * ab * L_attn
        cache_w = tok_chip * cfg.kv_dim * 2 * ab * L_attn
        total = weights + acts + attn + cache_w
        return dict(weights=weights, activations=acts, attention=attn,
                    cache_write=cache_w, total=total)
    # decode: weights + full KV-cache read + state r/w per token
    b_chip = max(shape.global_batch / dp, shape.global_batch / dp)
    kv_read = (b_chip * shape.seq_len * cfg.kv_dim * 2 * ab * L_attn
               / (n_chips / dp if False else 1))
    # kv head_dim is model-sharded: divide by the model-axis size
    model_par = n_chips // dp
    kv_read = kv_read / model_par
    ssm = 0.0
    if cfg.mamba is not None:
        d_in = cfg.mamba.expand * d
        n_mamba = L - L_attn
        ssm = 2 * b_chip * d_in * cfg.mamba.d_state * 4 * n_mamba / model_par
    if cfg.family == "xlstm":
        d_in = 2 * d
        dh = d_in // cfg.n_heads
        ssm = 2 * b_chip * cfg.n_heads * dh * dh * 4 * L / model_par
    acts = b_chip * L * d * ab * ACT_TENSORS_PER_LAYER
    total = W + kv_read + ssm + acts
    return dict(weights=W, kv_read=kv_read, state=ssm, activations=acts,
                total=total)

