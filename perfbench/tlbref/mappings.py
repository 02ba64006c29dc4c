"""Memory-mapping generators (paper §2.2, §4.1 and Table 3).

Synthetic mappings restrict chunk sizes to a range (Table 3):

* small   — 1..63 pages
* medium  — 64..511 pages
* large   — 512..1024 pages
* mixed   — 0.4 small + 0.4 medium + 0.2 large (by chunk count)

A frozen copy of the synthetic part of ``src/repro_torch/core/mappings.py``:
the benchmark builds its input mappings with it.  Not to be edited.
"""
from __future__ import annotations

from typing import List

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

