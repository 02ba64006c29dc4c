"""Algorithm 3 — determining K (paper §3.3, Table 1).

Given the OS contiguity histogram (chunk size → frequency), greedily choose
the alignment set K that covers the most contiguous pages, stopping once the
selected alignments cover ``theta`` (default 0.9) of the total contiguity or
``psi`` (default 4) alignments have been chosen.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

# Table 1: contiguity-chunk size range → matching alignment (k bits).
SIZE_RANGE_TABLE: Tuple[Tuple[int, int, int], ...] = (
    (2, 16, 4),
    (17, 64, 6),
    (65, 128, 7),
    (129, 256, 8),
    (257, 512, 9),
    (513, 1024, 10),
    (1025, 1 << 62, 11),
)

THETA_DEFAULT = 0.9
PSI_DEFAULT = 4


def f_alignment(size: int) -> int:
    """Table 1 mapping function f(): chunk size → alignment k.

    Chunks of size < 2 have no matching alignment (nothing to coalesce) and
    return -1; Algorithm 3 skips them.
    """
    if size < 2:
        return -1
    for lo, hi, k in SIZE_RANGE_TABLE:
        if lo <= size <= hi:
            return k
    raise AssertionError("unreachable")


def determine_k(contiguity_histogram: Mapping[int, int] | Iterable[Tuple[int, int]],
                theta: float = THETA_DEFAULT,
                psi: int = PSI_DEFAULT) -> List[int]:
    """Algorithm 3.

    ``contiguity_histogram``: (size, freq) pairs — e.g. ``{16: 33}`` means a
    contiguity chunk of 16 pages occurs 33 times in the mapping.

    Returns K sorted descending (the probe order of Algorithms 1–2).

    Coverage of alignment k accumulates ``size * freq`` over all chunks whose
    matching alignment (Table 1) is k.  Size-1 chunks have nothing to coalesce
    and are excluded from both the weights and the total (the paper's
    pseudo-code leaves f(1) undefined; counting uncoalescible pages in the
    total would make theta unreachable on fragmented mappings).
    """
    items = (contiguity_histogram.items()
             if hasattr(contiguity_histogram, "items")
             else contiguity_histogram)
    alignment_weight: Dict[int, int] = {}
    total_contiguity = 0
    for size, freq in items:
        if size < 2 or freq <= 0:
            continue
        coverage = size * freq
        total_contiguity += coverage
        k = f_alignment(size)
        alignment_weight[k] = alignment_weight.get(k, 0) + coverage

    K: List[int] = []
    if total_contiguity == 0:
        return K
    sum_coverage = 0
    # descending by coverage; ties broken toward larger k (more reach)
    ranked = sorted(alignment_weight.items(), key=lambda kv: (-kv[1], -kv[0]))
    # Algorithm 3 stops once the selected alignments cover >= theta of the
    # total contiguity (the paper's "covers more than 90%" is inclusive at
    # the boundary: reaching exactly theta is enough).  The epsilon keeps
    # a histogram whose coverage is *exactly* theta from being pushed past
    # the boundary by the floating-point rounding of ``total * theta``.
    threshold = total_contiguity * theta * (1.0 - 1e-12)
    for k, coverage in ranked:
        K.append(k)
        sum_coverage += coverage
        if sum_coverage >= threshold:
            break
        if len(K) >= psi:
            break
    return sorted(K, reverse=True)
