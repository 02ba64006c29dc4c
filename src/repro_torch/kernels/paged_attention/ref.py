"""Plain PyTorch versions of paged decode attention.

* :func:`gather_kv` / :func:`paged_attention_ref` — the dense oracle: gather
  the pages through the block table into a contiguous ``[B, S, KVH, D]``
  view and run masked decode attention in f32 (the JAX package's
  ``kernels/paged_attention/ref.py``).
* :func:`paged_attention_class_pass_ref` — one class-k pass with the CUDA
  kernel's own contract (``csrc/paged_attention.cu``): the unnormalised
  online-softmax state ``(o [B,H,D], m [B,H], l [B,H])`` in f32, exactly as
  the Pallas ``_class_kernel`` defines it, masked scores ``-1e30``.  The
  kernel is held to this function on the card, and the op takes it for
  tensors that lie on the CPU.
* :func:`paged_attention_split_pass_ref` — the same pass computed as the
  CUDA kernels compute it: each row's windows split into ``n_split``
  contiguous ranges, each range's partial state by the class pass above,
  the partials combined exactly (``m = max m_s``, weights
  ``exp(m_s - m)``).  It equals :func:`paged_attention_class_pass_ref` for
  every ``n_split``, junk windows and inactive rows included; the CPU
  tests hold it to that.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _as_tensor(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor,
              page_size: int) -> torch.Tensor:
    """pool: [n_pages, T, KVH, D]; block_table: [B, max_pages] (-1 pad)
    → [B, max_pages*T, KVH, D], zeros on unmapped pages."""
    block_table = _as_tensor(block_table, pool.device, torch.long)
    gathered = pool[block_table.clamp_min(0)]        # [B, P, T, KVH, D]
    B, P, T, KVH, D = gathered.shape
    valid = (block_table >= 0)[..., None, None, None]
    gathered = torch.where(valid, gathered, torch.zeros((), dtype=pool.dtype,
                                                        device=pool.device))
    return gathered.reshape(B, P * T, KVH, D)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables, kv_lens,
                        page_size: int, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """q: [B, H, D]; pools: [n_pages, T, KVH, D]; block_tables: [B, P];
    kv_lens: [B] → o: [B, H, D] in q's dtype."""
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = gather_kv(k_pool, block_tables, page_size).float()
    v = gather_kv(v_pool, block_tables, page_size).float()
    S = k.shape[1]
    lens = _as_tensor(kv_lens, q.device, torch.long)
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


@torch.no_grad()
def paged_attention_class_pass_ref(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        win_idx, covered, kv_lens, *, pages_per_block: int, page_size: int,
        scale: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One class-k pass, plain PyTorch, on the device of ``q``.

    q: [B, H, D]; pools: [n_pages, T, KVH, D]; win_idx/covered: [B, n_win]
    (physical window index / class-assignment mask); kv_lens: [B].
    Returns the unnormalised ``(o [B,H,D], m [B,H], l [B,H])``, all f32:
    windows are visited in order, each covered window's scores (masked to
    ``-1e30`` at positions ``>= kv_lens``) update ``m, l, o`` as the
    Pallas kernel's per-window step does; a row with no covered window
    keeps ``(0, -1e30, 0)``.
    """
    B, H, D = q.shape
    n_pages, T, KVH, _ = k_pool.shape
    P2 = pages_per_block
    if T != page_size or n_pages % P2:
        raise ValueError(f"pool of {n_pages} pages of {T} tokens does not "
                         f"split into windows of {P2} pages of {page_size}")
    W = P2 * T
    G = H // KVH
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kp = k_pool.reshape(n_pages // P2, W, KVH, D)
    vp = v_pool.reshape(n_pages // P2, W, KVH, D)
    win_idx = _as_tensor(win_idx, dev, torch.long)
    covered = _as_tensor(covered, dev, torch.int32) != 0
    lens = _as_tensor(kv_lens, dev, torch.long)

    qg = q.reshape(B, KVH, G, D).float()
    o = torch.zeros((B, KVH, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=dev)
    pos0 = torch.arange(W, device=dev)
    for j in range(win_idx.shape[1]):
        cov = covered[:, j]
        k = kp[win_idx[:, j]].float()                # [B, W, KVH, D]
        v = vp[win_idx[:, j]].float()
        s = torch.einsum("bhgd,bwhd->bhgw", qg, k) * scale
        live = (j * W + pos0)[None, :] < lens[:, None]   # [B, W]
        s = torch.where(live[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1)
        o_new = o * alpha[..., None] + torch.einsum("bhgw,bwhd->bhgd", p, v)
        sel = cov[:, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        o = torch.where(sel[..., None], o_new, o)
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


@torch.no_grad()
def paged_attention_split_pass_ref(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        win_idx, covered, kv_lens, *, pages_per_block: int, page_size: int,
        n_split: int, scale: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One class-k pass as the split and combine kernels compute it:
    split s walks windows ``[s * n_win // n_split, (s + 1) * n_win //
    n_split)`` (positions from the range's first window on, so the masks
    are the whole walk's) into a partial ``(o_s, m_s, l_s)``, and the
    partials combine to ``m = max m_s``, ``l = sum l_s exp(m_s - m)``,
    ``o = sum o_s exp(m_s - m)``.  A split with no covered window gives
    ``(0, -1e30, 0)``; one wholly past ``kv_lens`` gives finite junk at
    ``m = -1e30``, which a live split weights by 0 and other junk splits
    by 1, so the per-window walk's ``l`` adds up."""
    win_idx = _as_tensor(win_idx, q.device, torch.long)
    covered = _as_tensor(covered, q.device, torch.int32)
    lens = _as_tensor(kv_lens, q.device, torch.long)
    n_win = win_idx.shape[1]
    if not 1 <= n_split <= max(n_win, 1):
        raise ValueError(f"n_split {n_split} outside 1 .. {max(n_win, 1)}")
    W = pages_per_block * page_size
    parts = []
    for s in range(n_split):
        lo, hi = s * n_win // n_split, (s + 1) * n_win // n_split
        parts.append(paged_attention_class_pass_ref(
            q, k_pool, v_pool, win_idx[:, lo:hi], covered[:, lo:hi],
            lens - lo * W, pages_per_block=pages_per_block,
            page_size=page_size, scale=scale))
    m = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m) for p in parts]
    o = sum(p[0] * wi[..., None] for p, wi in zip(parts, w))
    l = sum(p[2] * wi for p, wi in zip(parts, w))
    return o, m, l
