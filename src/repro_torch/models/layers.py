"""Transformer building blocks: RMSNorm, RoPE, GQA attention (prefill:
the flash-attention kernel on the card, chunked online softmax on the CPU;
grouped for decode), SwiGLU MLP.

The port of the JAX package's ``models/layers.py``, function for function,
with the same layouts at every public function (``[B, S, H, D]``
activations, ``[d_in, d_out]`` weights).  Where the JAX code multiplies in
the working dtype and asks for an f32 result (``preferred_element_type``),
the port multiplies the same operands upcast to f32: the products of bf16
values are exact in f32, so both sum the same terms.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
                      *, causal: bool, rc: RunConfig) -> torch.Tensor:
    """The prefill's attention, q [B, S, Hq, D] and k, v [B, S, Hkv, D]
    from position 0: on the card one launch of the flash-attention kernel
    (:func:`..kernels.flash_attention.flash_attention_gqa`, f32 or bf16),
    on the CPU :func:`chunked_attention` with ``rc``'s chunk sizes, as the
    JAX prefill computes it."""
    if q.device.type == "cuda":
        return flash_attention_gqa(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal,
                                 q_chunk=rc.attn_q_chunk,
                                 kv_chunk=rc.attn_kv_chunk)
    raise ValueError(f"prefill_attention: no implementation for {q.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode attention (grouped GQA, cache never repeated).

    q: [B, 1, Hq, D]; caches: [B, S, Hkv, D]; kv_len: [B] valid lengths.
    """
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


def attention_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] → q [B, S, H, D], k and v [B, S, KVH, D] (RoPE on q,
    k; RMSNorm on them first where the config has ``qk_norm``)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"])
    h = h * (x @ p["w_up"])
    return h @ p["w_down"]
