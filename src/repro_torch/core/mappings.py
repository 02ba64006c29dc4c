"""Memory-mapping generators (paper §2.2, §4.1 and Table 3).

Synthetic mappings restrict chunk sizes to a range (Table 3):

* small   — 1..63 pages
* medium  — 64..511 pages
* large   — 512..1024 pages
* mixed   — 0.4 small + 0.4 medium + 0.2 large (by chunk count)

``demand_mapping`` emulates Linux demand paging through a buddy allocator with
churn, producing the *mixed contiguity* the paper measures on real machines
(Figs 2–3): a long-running buddy system serves allocations from power-of-two
free lists, so a warmed-up process sees chunks of many coexisting sizes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .determine_k import f_alignment
from .page_table import Mapping, make_mapping

SYNTH_RANGES = {
    "small": (1, 63),
    "medium": (64, 511),
    "large": (512, 1024),
}
MIXED_WEIGHTS = (("small", 0.4), ("medium", 0.4), ("large", 0.2))


def _va_alignment_of(size: int, cap_bits: int = 11) -> int:
    """VA alignment (pages) a chunk of ``size`` naturally lands on.

    OS allocators place extents at boundaries of their covering power of two
    (buddy blocks are order-aligned; THP-aware faulting aligns VMAs): the
    paper's own examples (Fig 4: size-6 chunk at VPN 8, size-3 at VPN 4) all
    assume this.  We align to the Table-1 matching alignment so a chunk is
    coverable by a single k-bit aligned entry — the regime the paper's §3.3
    ("every contiguity chunk covered by its matching aligned entry") targets.
    """
    k = f_alignment(size)
    if k < 0:
        return 1
    return 1 << min(k, cap_bits)


def _layout(chunks: List[int], rng: np.random.Generator,
            pa_align: bool = False, va_align: bool = True) -> np.ndarray:
    """Place chunks at (aligned) VA offsets, scattered in PA.

    Each chunk gets a physical base; chunk order is shuffled in PA and a
    one-page guard gap inserted so virtually-adjacent chunks are never
    physically adjacent (otherwise they would merge into one chunk).
    With ``pa_align`` the PA base of each chunk is rounded up to the chunk's
    power-of-two (gives THP/huge-page-promotable layouts).  With ``va_align``
    each chunk's VA base is aligned per ``_va_alignment_of`` (padding pages
    stay unmapped).
    """
    order = rng.permutation(len(chunks))
    pa_base = np.zeros(len(chunks), dtype=np.int64)
    cursor = np.int64(rng.integers(0, 512))
    for idx in order:
        size = chunks[idx]
        if pa_align:
            align = 1 << int(np.ceil(np.log2(max(size, 1))))
            cursor = (cursor + align - 1) & ~np.int64(align - 1)
        pa_base[idx] = cursor
        cursor += size + 1  # guard page: forces PA discontiguity at boundary

    va_base = np.zeros(len(chunks), dtype=np.int64)
    vp = np.int64(0)
    for idx, size in enumerate(chunks):
        if va_align:
            a = _va_alignment_of(size)
            vp = (vp + a - 1) & ~np.int64(a - 1)
        va_base[idx] = vp
        vp += size
    ppn = np.full(int(vp), -1, dtype=np.int64)
    for idx, size in enumerate(chunks):
        v = va_base[idx]
        ppn[v:v + size] = pa_base[idx] + np.arange(size)
    return ppn


def _draw_sizes(kind: str, n_pages: int, rng: np.random.Generator) -> List[int]:
    sizes: List[int] = []
    total = 0
    names = [k for k, _ in MIXED_WEIGHTS]
    probs = np.array([w for _, w in MIXED_WEIGHTS])
    while total < n_pages:
        k = kind if kind != "mixed" else names[rng.choice(len(names), p=probs)]
        lo, hi = SYNTH_RANGES[k]
        s = int(rng.integers(lo, hi + 1))
        s = min(s, n_pages - total)
        sizes.append(s)
        total += s
    return sizes


def synthetic_mapping(kind: str, n_pages: int, seed: int = 0,
                      pa_align: bool = True, va_align: bool = True) -> Mapping:
    """Table 3 synthetic mapping with chunk sizes drawn from ``kind``.

    ``n_pages`` counts *mapped* pages; with ``va_align`` the virtual footprint
    is slightly larger (alignment holes are unmapped).
    """
    if kind not in ("small", "medium", "large", "mixed"):
        raise ValueError(f"unknown synthetic mapping kind: {kind}")
    rng = np.random.default_rng(seed)
    sizes = _draw_sizes(kind, n_pages, rng)
    ppn = _layout(sizes, rng, pa_align=pa_align, va_align=va_align)
    return make_mapping(ppn, name=f"synth-{kind}")


def mapped_vpns(m: Mapping) -> np.ndarray:
    """VPNs of mapped pages, for trace generation over sparse footprints."""
    return np.flatnonzero(m.ppn >= 0).astype(np.int64)


class BuddyAllocator:
    """Minimal binary-buddy physical allocator (order 0..max_order).

    Used both by ``demand_mapping`` (to emulate the OS) and by the paged
    KV-cache allocator in ``kvcache/allocator.py`` of the JAX package (the TPU adaptation).
    """

    def __init__(self, n_frames: int, max_order: int = 10):
        self.max_order = max_order
        block = 1 << max_order
        n_frames = (n_frames // block) * block
        self.n_frames = n_frames
        self.free: List[set] = [set() for _ in range(max_order + 1)]
        for base in range(0, n_frames, block):
            self.free[max_order].add(base)

    def alloc(self, order: int) -> Optional[int]:
        for o in range(order, self.max_order + 1):
            if self.free[o]:
                base = min(self.free[o])
                self.free[o].discard(base)
                # split down to requested order
                while o > order:
                    o -= 1
                    self.free[o].add(base + (1 << o))
                return base
        return None

    def free_block(self, base: int, order: int) -> None:
        # coalesce with buddy while possible
        while order < self.max_order:
            buddy = base ^ (1 << order)
            if buddy in self.free[order]:
                self.free[order].discard(buddy)
                base = min(base, buddy)
                order += 1
            else:
                break
        self.free[order].add(base)

    def frag_stats(self) -> Tuple[int, int]:
        free_frames = sum(len(s) << o for o, s in enumerate(self.free))
        largest = max((o for o, s in enumerate(self.free) if s), default=-1)
        return free_frames, largest

    # ---------------------------------------------------------- robustness
    def snapshot(self) -> List[List[int]]:
        """Free lists as plain sorted lists (JSON-serializable), one per
        order — the allocator's complete mutable state."""
        return [sorted(s) for s in self.free]

    def restore(self, freelists: List[List[int]]) -> None:
        assert len(freelists) == len(self.free)
        self.free = [set(int(b) for b in fl) for fl in freelists]

    def retire(self, frame: int) -> bool:
        """Permanently remove one FREE frame from the pool (bad page).

        Splits the free block containing ``frame`` down to order 0 and
        drops the poisoned frame; its buddies stay allocatable.  Returns
        False when the frame is currently allocated (or already retired) —
        the caller must free its owner first.  ``n_frames`` is unchanged,
        so a retired frame counts as permanently in-use."""
        for o in range(self.max_order + 1):
            base = (frame >> o) << o       # buddy blocks are size-aligned
            if base in self.free[o]:
                self.free[o].discard(base)
                while o > 0:
                    o -= 1
                    half = 1 << o
                    if frame < base + half:
                        self.free[o].add(base + half)
                    else:
                        self.free[o].add(base)
                        base += half
                return True
        return False


def demand_mapping(n_pages: int, seed: int = 0, churn: float = 0.3,
                   thp: bool = False) -> Mapping:
    """Emulated demand-paged mapping from a churned buddy allocator.

    ``churn`` controls fragmentation: fraction of interleaved alloc/free
    traffic before the process' own allocations, mirroring a long-running
    system (paper §2.1).  With ``thp`` the allocator prefers order-9 (2MB)
    blocks when the requested span is large, as Linux THP would.
    """
    rng = np.random.default_rng(seed)
    buddy = BuddyAllocator(n_frames=4 * n_pages, max_order=11)

    # Warm-up churn: scatter small in-use allocations, free a random subset.
    held: List[Tuple[int, int]] = []
    n_churn = int(churn * n_pages / 8)
    for _ in range(n_churn):
        order = int(rng.choice([0, 1, 2, 3], p=[0.5, 0.25, 0.15, 0.1]))
        base = buddy.alloc(order)
        if base is not None:
            held.append((base, order))
    rng.shuffle(held)
    for base, order in held[: len(held) // 2]:
        buddy.free_block(base, order)

    # The process' allocations: VA is filled left to right, each extent at its
    # order-aligned VA boundary (buddy/THP-style aligned faulting); the OS
    # serves each request with the largest available buddy block.
    blocks: List[Tuple[int, int]] = []   # (pa_base, n)
    mapped = 0
    while mapped < n_pages:
        want = n_pages - mapped
        max_req_order = 9 if thp else 11
        order = min(int(np.log2(max(want, 1))), max_req_order)
        # demand paging rarely asks for one giant block; mix request sizes
        order = int(rng.integers(0, order + 1)) if not thp else order
        base = None
        while base is None and order >= 0:
            base = buddy.alloc(order)
            if base is None:
                order -= 1
        if base is None:
            raise RuntimeError("buddy allocator exhausted")
        n = min(1 << order, want)
        blocks.append((base, n))
        mapped += n
    vp = np.int64(0)
    spans = []
    for base, n in blocks:
        a = 1 << int(np.ceil(np.log2(n))) if n > 1 else 1
        vp = (vp + a - 1) & ~np.int64(a - 1)
        spans.append((int(vp), base, n))
        vp += n
    ppn = np.full(int(vp), -1, dtype=np.int64)
    for v, base, n in spans:
        ppn[v:v + n] = base + np.arange(n)
    return make_mapping(ppn, name=f"demand{'-thp' if thp else ''}")
