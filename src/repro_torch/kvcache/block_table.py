"""Block tables with K-bit aligned run descriptors — the paper on KV paging.

A block table maps logical KV pages → physical pool pages (the "page table").
This module computes, per 2^k-aligned logical window, whether the window is
*coverable by one class-k descriptor*:

    covered_k[b, j]  ⇔  pages [j·2^k, (j+1)·2^k) are all mapped,
                        physically consecutive, AND the physical start is
                        2^k-aligned

— the direct analogue of a k-bit aligned PTE whose contiguity spans its
window (paper §3.1), with the added physical-alignment condition because a
Pallas BlockSpec index is in units of the block shape (hardware pages and
buddy blocks are naturally aligned, so the condition is usually free).

``assign_classes`` implements Algorithm 1's rightward-compatible fill: each
page belongs to the *largest* covering class in K; pages covered by no class
fall back to class 0 (page-granular access = the "regular entry").
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def window_coverage(block_table: np.ndarray, k: int) -> np.ndarray:
    """bool[n_windows]: class-k coverage of each 2^k-page logical window.

    ``block_table``: int array [max_pages], -1 = unmapped.
    """
    w = 1 << k
    n = block_table.shape[0]
    nw = n // w
    bt = block_table[: nw * w].reshape(nw, w).astype(np.int64)
    mapped = (bt >= 0).all(axis=1)
    consec = (np.diff(bt, axis=1) == 1).all(axis=1) if w > 1 else \
        np.ones(nw, bool)
    aligned = (bt[:, 0] % w) == 0
    return mapped & consec & aligned


def assign_classes(block_table: np.ndarray, K: Sequence[int]
                   ) -> Dict[int, np.ndarray]:
    """Rightward-compatible class assignment (Algorithm 1 analogue).

    Returns {k: bool[n_windows_k]} where a window is marked for class k iff
    it is covered at k and NOT already claimed by a larger class in K.
    Class 0 (single pages) is always present as the fallback and marks every
    mapped page not claimed by any k in K.
    """
    n = block_table.shape[0]
    Kd = sorted(set(int(k) for k in K if k > 0), reverse=True)
    claimed = np.zeros(n, dtype=bool)
    out: Dict[int, np.ndarray] = {}
    for k in Kd:
        w = 1 << k
        cov = window_coverage(block_table, k)
        free = ~claimed[: (n // w) * w].reshape(-1, w).any(axis=1)
        take = cov & free
        out[k] = take
        claimed[: (n // w) * w] |= np.repeat(take, w)
    page_mapped = block_table >= 0
    out[0] = page_mapped & ~claimed
    return out


def descriptor_tables(block_tables: np.ndarray, K: Sequence[int]
                      ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Batched kernel inputs per class.

    ``block_tables``: [B, max_pages].  Returns, for each class k in K ∪ {0}:
    ``(window_index [B, n_w_k] int32, covered [B, n_w_k] int8)`` where
    ``window_index[b, j]`` is the PHYSICAL window index (phys_start >> k) the
    class-k Pallas pass loads for logical window j, or 0 when not covered
    (masked out by ``covered``).
    """
    B, n = block_tables.shape
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    Kall = sorted(set(list(K) + [0]), reverse=True)
    assigns = [assign_classes(block_tables[b], K) for b in range(B)]
    for k in Kall:
        w = 1 << k
        nw = n // w
        idx = np.zeros((B, nw), dtype=np.int32)
        cov = np.zeros((B, nw), dtype=np.int8)
        for b in range(B):
            take = assigns[b][k]
            if k == 0:
                take = take[: nw]
                phys = block_tables[b][: nw]
                idx[b] = np.where(take, np.maximum(phys, 0), 0)
            else:
                phys0 = block_tables[b][: nw * w: w]
                idx[b] = np.where(take, np.maximum(phys0, 0) >> k, 0)
            cov[b] = take.astype(np.int8)
        out[k] = (idx, cov)
    return out


def dma_descriptor_count(block_tables: np.ndarray, K: Sequence[int]
                         ) -> Dict[str, float]:
    """The paper's miss-count metric, TPU edition: DMA descriptors needed to
    read every mapped page once, with vs without coalescing."""
    B, n = block_tables.shape
    total_pages = int((block_tables >= 0).sum())
    coalesced = 0
    for b in range(B):
        asg = assign_classes(block_tables[b], K)
        for k, take in asg.items():
            coalesced += int(take.sum())
    return {
        "pages": total_pages,
        "descriptors_page_granular": total_pages,
        "descriptors_coalesced": coalesced,
        "reduction": 1.0 - coalesced / max(total_pages, 1),
    }


def choose_kernel_classes(contiguity_histogram: Dict[int, int],
                          psi: int = 3, theta: float = 0.9,
                          max_class: int = 6) -> List[int]:
    """Algorithm 3 with a DMA-appropriate size→class mapping.

    The paper's Table 1 assigns a chunk the smallest alignment whose window
    COVERS it (size 2–16 → k=4): a partially-filled aligned entry still
    translates its pages.  A Pallas class-k pass instead loads the whole
    2^k-page window in one DMA, so a chunk only benefits from classes with
    2^k ≤ size: f(size) = floor(log2(size)).  Same greedy coverage selection,
    θ and ψ as Algorithm 3.  ``max_class`` bounds the superblock so a class-k
    tile (2^k pages × page_size tokens × KVH × D) fits VMEM.
    """
    weights: Dict[int, int] = {}
    total = 0
    for size, freq in contiguity_histogram.items():
        if size < 2 or freq <= 0:
            continue
        k = min(int(np.floor(np.log2(size))), max_class)
        cov = size * freq
        total += cov
        weights[k] = weights.get(k, 0) + cov
    if not total:
        return []
    K: List[int] = []
    covered = 0
    for k, cov in sorted(weights.items(), key=lambda kv: (-kv[1], -kv[0])):
        K.append(k)
        covered += cov
        if covered > theta * total or len(K) >= psi:
            break
    return sorted(K, reverse=True)
