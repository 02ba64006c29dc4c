"""Transformer building blocks: RMSNorm, RoPE, GQA attention (prefill:
the flash-attention kernel on the card, chunked online softmax on the CPU;
grouped for decode), SwiGLU MLP.

The port of the JAX package's ``models/layers.py``, function for function,
with the same layouts at every public function (``[B, S, H, D]``
activations, ``[d_in, d_out]`` weights).  Where the JAX code multiplies in
the working dtype and asks for an f32 result (``preferred_element_type``),
the port multiplies the same operands upcast to f32: the products of bf16
values are exact in f32, so both sum the same terms.  Attention and the
MLP also take a model rank's shard of their weights (``mg``, a
:class:`..distributed.tensor_parallel.ModelGroup`): query heads and
``d_ff`` columns split over the model ranks, as Megatron splits them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as TP
from ..distributed.sharding import Sharding, is_dtensor, local_slices
from ..distributed.tensor_parallel import ModelGroup
from ..kernels.flash_attention.ops import flash_attention_gqa
from .common import Spec
from .config import ModelConfig, RunConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Half-split
    rotation: the first and second halves of the head dim are the pairs."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs          # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention (prefill)
# ---------------------------------------------------------------------------

def _attn_block(q, k, v, mask, scale):
    """One (q-block, kv-block) tile: (m, l, o) online-softmax stats.

    q: [B, Q, H, D]; k, v: [B, S, H, D]; mask [Q, S]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                   # [b, h, q]
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, lsum, o


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      kv_len: Optional[int] = None, q_chunk: int = 512,
                      kv_chunk: int = 1024, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """Memory-efficient attention (prefill path).

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq % Hkv == 0 (kv heads
    repeated to Hq).  ``q_offset`` is the absolute position of q[0].
    Never materialises more than [B, Hq, q_chunk, kv_chunk] scores.  The
    JAX version pads the ragged last chunks and masks the padding; here
    they are simply shorter, and kv chunks wholly above the causal
    diagonal are skipped — both leave the online-softmax state exactly as
    the masked tiles would (their weights are exp(-1e30 - m) = 0).
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv}")
    rep = Hq // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    dev = q.device
    out = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        nq = qc.shape[1]
        q_pos = q_offset + q0 + torch.arange(nq, device=dev)
        m_acc = torch.full((B, Hq, nq), NEG_INF, device=dev)
        l_acc = torch.zeros((B, Hq, nq), device=dev)
        o_acc = torch.zeros((B, nq, Hq, D), device=dev)
        for k0 in range(0, Skv, kv_chunk):
            if causal and k0 > q_offset + q0 + nq - 1:
                break
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            k_pos = k0 + torch.arange(kc.shape[1], device=dev)
            mask = torch.ones((nq, kc.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if kv_len is not None:
                mask &= k_pos[None, :] < kv_len
            m, lsum, o = _attn_block(qc, kc, vc, mask, scale)
            m_new = torch.maximum(m_acc, m)
            alpha = torch.exp(m_acc - m_new)
            beta = torch.exp(m - m_new)
            l_acc = l_acc * alpha + lsum * beta
            o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                     + o * beta.transpose(1, 2)[..., None])
            m_acc = m_new
        l_acc = torch.clamp_min(l_acc, 1e-20)
        out.append(o_acc / l_acc.transpose(1, 2)[..., None])
    return torch.cat(out, dim=1).to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, rc: RunConfig, q_offset: int = 0
                      ) -> torch.Tensor:
    """The prefill's attention, q [B, Sq, Hq, D] at positions ``q_offset
    ..`` and k, v [B, q_offset + Sq, Hkv, D] from position 0 (``q_offset``
    > 0: a later chunk of ``Model.prefill_chunked``): on the card one
    launch of the flash-attention kernel
    (:func:`..kernels.flash_attention.flash_attention_gqa`, f32 or bf16),
    on the CPU :func:`chunked_attention` with ``rc``'s chunk sizes, as the
    JAX prefill computes it."""
    if q.device.type == "cuda":
        return flash_attention_gqa(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 q_chunk=rc.attn_q_chunk,
                                 kv_chunk=rc.attn_kv_chunk)
    raise ValueError(f"prefill_attention: no implementation for {q.device}")


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """How a rank's part of a decode KV cache sits in the whole:
    ``seq_start``, the global position of its first row, and the process
    groups (of more than one rank each) whose ranks hold the other parts
    of the sequence (``seq_groups``) and of the head dimension
    (``dim_groups``, this rank's part of it ``dim``)."""
    seq_start: int
    seq_groups: tuple
    dim_groups: tuple
    dim: slice


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     split: Optional[CacheSplit] = None) -> torch.Tensor:
    """Single-step decode attention (grouped GQA, cache never repeated).

    q: [B, 1, Hq, D]; caches: [B, S, Hkv, D]; kv_len: [B] valid lengths.
    The caches may be this rank's part of a cache split over ranks
    (``split``; or DTensors, whose placements say it):
    :func:`_decode_attention_split`.
    """
    if is_dtensor(k_cache):
        k_cache, v_cache, split = _split_of(k_cache, v_cache)
    if split is not None:
        return _decode_attention_split(q, k_cache, v_cache, kv_len, scale,
                                       split)
    B, _, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bcgd,bscd->bcgs", qg.float(), k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bcgs,bscd->bcgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _split_of(k_cache, v_cache):
    """(local k, local v, :class:`CacheSplit`) of DTensor caches [B, S,
    Hkv, D] split along the batch (q and kv_len are then this rank's
    rows), the sequence or the head dimension over mesh dimensions."""
    pls = k_cache.placements
    if v_cache.placements != pls or any(
            pl.is_shard() and pl.dim == 2 for pl in pls):
        raise ValueError("decode_attention: the caches must be placed "
                         "alike, and not split over their KV heads")
    mesh = k_cache.device_mesh
    sl = local_slices(k_cache.shape, Sharding(mesh, pls))
    groups = {1: [], 3: []}
    for m, pl in enumerate(pls):
        if pl.is_shard() and pl.dim in groups and mesh.shape[m] > 1:
            groups[pl.dim].append(mesh.get_group(m))
    split = (CacheSplit(sl[1].start, tuple(groups[1]), tuple(groups[3]),
                        sl[3]) if groups[1] or groups[3] else None)
    return k_cache.to_local(), v_cache.to_local(), split


def _decode_attention_split(q, k, v, kv_len, scale, split: CacheSplit):
    """:func:`decode_attention` over this rank's part ``k``, ``v`` [B, S_r,
    Hkv, D_r] of caches split along the sequence and the head dimension
    (``split``; q [B, 1, Hq, D] whole): the scores' partial sums over the
    rank's part of the head dimension summed over ``dim_groups``; the
    softmax's partial (max, sum, unnormalised output) over the rank's
    positions, the partials combined over each of ``seq_groups`` in turn
    (flash-decoding's split-K, which is what the JAX partitioner makes of
    a cache sharded along the sequence); the output's parts of the head
    dimension gathered over ``dim_groups``."""
    import torch.distributed as dist
    B, _, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q[..., split.dim].reshape(B, Hkv, G, -1)
    s = torch.einsum("bcgd,bscd->bcgs", qg.float(), k.float())
    for group in split.dim_groups:
        s = s.contiguous()
        dist.all_reduce(s, group=group)
    s = s * scale
    pos = split.seq_start + torch.arange(S, device=q.device)
    mask = (pos[None, :] < kv_len.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bcgs,bscd->bcgd", p, v.float())
    for group in split.seq_groups:
        n = dist.get_world_size(group)
        ms, ls, os_ = ([torch.empty_like(t) for _ in range(n)]
                       for t in (m, l, o))
        dist.all_gather(ms, m, group=group)
        dist.all_gather(ls, l, group=group)
        dist.all_gather(os_, o.contiguous(), group=group)
        m = torch.stack(ms).amax(0)
        w = [torch.exp(mi - m) for mi in ms]
        l = sum(wi * li for wi, li in zip(w, ls))
        o = sum(wi * oi for wi, oi in zip(w, os_))
    for group in split.dim_groups:
        n = dist.get_world_size(group)
        parts = [torch.empty_like(o) for _ in range(n)]
        dist.all_gather(parts, o.contiguous(), group=group)
        o = torch.cat(parts, dim=-1)
    return (o / l).reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# attention layer (params + apply)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        "wq": Spec((d, qd), ("embed", "q_heads")),
        "wk": Spec((d, kvd), ("embed", "kv_heads")),
        "wv": Spec((d, kvd), ("embed", "kv_heads")),
        "wo": Spec((qd, d), ("q_heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = Spec((cfg.head_dim,), (None,), init="ones")
        s["k_norm"] = Spec((cfg.head_dim,), (None,), init="ones")
    return s


def kv_heads_of(k: torch.Tensor, h0: int, n: int, group: int
                ) -> torch.Tensor:
    """The KV heads [B, S, KVH, D] that query heads ``h0 .. h0 + n`` read
    (query head h reads KV head ``h // group``), grouped as attention
    reads them: a slice of whole groups where ``n`` is a multiple of the
    group, the one head they share where ``n`` divides it (both views, no
    copy), else one KV head per query head."""
    if n % group == 0:
        return k[:, :, h0 // group:(h0 + n) // group]
    if group % n == 0:
        return k[:, :, h0 // group:h0 // group + 1]
    idx = torch.arange(h0, h0 + n, device=k.device) // group
    return k.index_select(2, idx)


def attention_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, mg: Optional[ModelGroup] = None,
                  all_kv: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] → q [B, S, H, D], k and v [B, S, KVH, D] (RoPE on q,
    k; RMSNorm on them first where the config has ``qk_norm``).  The head
    counts are the weights' own: where ``wq`` holds this model rank's
    columns (its heads ``[r H_l, (r + 1) H_l)``, ``mg``), q holds those
    heads and k, v the KV heads they read (:func:`kv_heads_of`).  The
    replicated ``wk``, ``wv`` (and ``q_norm``) are then used in part on
    each rank: ``copy_to_model`` on k and v before their heads are taken
    (and on ``q_norm``, and on x into ``wq``) sums their gradients over
    the model ranks, so each rank ends with the whole gradient.
    ``all_kv``: k and v keep every KV head (the cached passes, which store
    them all)."""
    B, S, _ = x.shape
    D = cfg.head_dim
    split = TP.splits(mg, p["wq"].shape[-1], cfg.q_dim)
    xq = TP.copy_to_model(x, mg) if split else x
    q = (xq @ p["wq"]).reshape(B, S, -1, D)
    k = (x @ p["wk"]).reshape(B, S, -1, D)
    v = (x @ p["wv"]).reshape(B, S, -1, D)
    if cfg.qk_norm:
        qn = TP.copy_to_model(p["q_norm"], mg) if split else p["q_norm"]
        q = rms_norm(q, qn, cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if split and not all_kv:
        n = q.shape[2]
        group = cfg.n_heads // cfg.n_kv_heads
        k = kv_heads_of(TP.copy_to_model(k, mg), mg.rank * n, n, group)
        v = kv_heads_of(TP.copy_to_model(v, mg), mg.rank * n, n, group)
    return q, k, v


def attention_out(cfg: ModelConfig, p: dict, o: torch.Tensor,
                  mg: Optional[ModelGroup] = None) -> torch.Tensor:
    """Attention's heads o [B, S, H, D] through ``wo`` → [B, S, d]; where
    ``wo`` holds this model rank's rows (its heads), the partial products
    are summed over the model ranks."""
    B, S = o.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"]
    if TP.splits(mg, p["wo"].shape[-2], cfg.q_dim):
        out = TP.reduce_from_model(out, mg)
    return out


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": Spec((d, ff), ("embed", "mlp")),
        "w_up": Spec((d, ff), ("embed", "mlp")),
        "w_down": Spec((ff, d), ("mlp", "embed")),
    }


def mlp(p: dict, x: torch.Tensor, mg: Optional[ModelGroup] = None,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU.  Where the weights hold this model rank's part of the
    ``d_ff`` hidden columns (``mg``; ``w_gate``, ``w_up`` column-parallel,
    ``w_down`` row-parallel), x's gradient and the output are summed over
    the model ranks."""
    split = d_ff is not None and TP.splits(mg, p["w_down"].shape[-2], d_ff)
    if split:
        x = TP.copy_to_model(x, mg)
    h = F.silu(x @ p["w_gate"])
    h = h * (x @ p["w_up"])
    out = h @ p["w_down"]
    return TP.reduce_from_model(out, mg) if split else out
