"""Plain PyTorch versions of prefill (flash) attention.

* :func:`attention_ref` — the naive oracle: masked softmax attention over
  the whole ``[S, S]`` score matrix in f32 (the JAX package's
  ``kernels/flash_attention/ref.py``).
* :func:`flash_attention_ref` — the CUDA kernel's own contract
  (``csrc/flash_attention.cu``), which is the Pallas ``_flash_kernel``'s:
  q, k and v cast to f32, scores masked to exactly ``-1e30``, the online
  softmax ``(m, l, acc)`` and the probabilities kept in f32, ``l`` clamped
  at ``1e-30``, the output cast to q's dtype.  It walks the keys in blocks
  (never an ``[S, S]`` matrix, so it serves as the yardstick at 32k tokens
  on the card) and indexes KV heads in groups, without materialising the
  GQA repeat.  The kernel is held to this function on the card, and the op
  takes it for tensors that lie on the CPU.
* :func:`split_bf16` and :func:`flash_attention_tc_ref` — the arithmetic of
  the bf16 tensor-core kernel written out plainly: q, k, v in bf16, each
  score an f32 sum of exact bf16 products, the 64-key tiles of the kernel,
  and ``p @ v`` as ``p_hi @ v + p_lo @ v`` with ``(p_hi, p_lo) =
  split_bf16(p)``.  The CPU tests hold it to :func:`flash_attention_ref`
  within one bf16 ulp of the output, the limit the card holds the kernel
  to; ``p_terms=1`` rounds p once to bf16 instead, which that limit must
  catch.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """q, k, v: [B, S, H, D] (H equal for all three) → [B, S, H, D] in q's
    dtype, f32 math."""
    B, S, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def split_bf16(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``p`` as two bf16 tensors ``(p_hi, p_lo)``: ``p_hi = bf16(p)``,
    ``p_lo = bf16(p - p_hi)``, so that ``p_hi + p_lo`` keeps p to about
    2^-16 of its magnitude where ``p_hi`` alone keeps 2^-9."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


@torch.no_grad()
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: Optional[float] = None,
                        kv_block: int = 1024) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, KVH, D] with ``H % KVH == 0`` (query
    head h reads KV head ``h // (H // KVH)``, the order of the JAX op's
    ``jnp.repeat``) → [B, S, H, D] in q's dtype.

    Keys are taken ``kv_block`` at a time; under ``causal`` a block only
    updates the query rows at or past its first key (the rows before it
    are wholly masked there, and a wholly masked block adds
    ``exp(-1e30 - m) = 0``)."""
    return _flash_walk(q, k, v, causal, scale, kv_block, None)


@torch.no_grad()
def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           scale: Optional[float] = None, p_terms: int = 2
                           ) -> torch.Tensor:
    """The bf16 tensor-core kernel's arithmetic, plainly: q, k, v rounded to
    bf16 (a no-op for bf16 inputs), 64-key tiles, and ``p @ v`` summed over
    the first ``p_terms`` of ``split_bf16(p)`` (2: hi and lo, as the
    kernel; 1: p rounded once to bf16) → [B, S, H, D] in q's dtype."""
    if p_terms not in (1, 2):
        raise ValueError(f"p_terms must be 1 or 2, not {p_terms}")
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    return _flash_walk(*bf, causal, scale, 64, p_terms).to(q.dtype)


def _flash_walk(q, k, v, causal, scale, kv_block, p_terms):
    """The online-softmax walk of :func:`flash_attention_ref`; ``p @ v``
    takes p in f32 (``p_terms`` None) or as the first ``p_terms`` bf16
    parts of :func:`split_bf16`."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads do not group over {KVH}")
    G = H // KVH
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, S, KVH, G, D).float()
    m = torch.full((B, KVH, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, S, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(S, device=dev)
    for k0 in range(0, S, kv_block):
        q0 = k0 if causal else 0              # first row this block reaches
        kf = k[:, k0:k0 + kv_block].float()   # [B, n, KVH, D]
        vf = v[:, k0:k0 + kv_block].float()
        k_pos = k0 + torch.arange(kf.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:], kf) * scale
        if causal:
            mask = q_pos[q0:, None] >= k_pos[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_prev = m[..., q0:]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l[..., q0:] = l[..., q0:] * alpha + p.sum(-1)
        if p_terms is None:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vf)
        else:
            pv = sum(torch.einsum("bhgqk,bkhd->bhgqd", part.float(), vf)
                     for part in split_bf16(p)[:p_terms])
        acc[..., q0:, :] = acc[..., q0:, :] * alpha[..., None] + pv
        m[..., q0:] = m_new
        del s, p
    o = acc / torch.clamp_min(l, 1e-30)[..., None]    # [B, KVH, G, S, D]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
