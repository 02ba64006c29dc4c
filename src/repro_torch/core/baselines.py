"""Method configurations for all compared schemes (paper §4.1, Table 2).

A copy of the spec factories of the JAX package's ``core/baselines.py``.
Each returns a :class:`repro_torch.core.simulator.MethodSpec` driving the
unified engine.  TLB geometries follow Table 2:

* common L1: 64-entry 4-way 4KB (+32-entry 4-way 2MB for THP)
* Base/THP/COLT/Anchor/K-Aligned L2: 1024 entries, 8-way (128 sets)
* Cluster: 768-entry 6-way regular + 320-entry 5-way clustered
* RMM: baseline L2 + 32-entry fully-associative range TLB

``anchor_static`` and ``standard_suite`` return what the reference's do —
the same results, names and order — but run all their cells as lanes of
one :func:`~repro_torch.core.sweep.run_sweep` call (one kernel launch on
the card) where the reference calls its per-call engine once per method.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .determine_k import determine_k
from .page_table import Mapping, contiguity_histogram
from .simulator import SUBR_BITS, MethodSpec, SimResult


def base_spec() -> MethodSpec:
    return MethodSpec(name="Base", kind="base")


def thp_spec() -> MethodSpec:
    return MethodSpec(name="THP", kind="thp")


def colt_spec() -> MethodSpec:
    # coalesced entries indexed by the 8-PTE window (index_shift=3)
    return MethodSpec(name="COLT", kind="colt", index_shift=3)


def cluster_spec() -> MethodSpec:
    # 768-entry 6-way regular TLB + clustered side TLB
    return MethodSpec(name="Cluster", kind="cluster", l2_sets=128, l2_ways=6,
                      side="cluster")


def rmm_spec() -> MethodSpec:
    return MethodSpec(name="RMM", kind="rmm", side="rmm")


def anchor_spec(distance_bits: int) -> MethodSpec:
    """Anchor with anchor distance 2**distance_bits [Park et al., ISCA'17]."""
    return MethodSpec(name=f"Anchor(d=2^{distance_bits})", kind="anchor",
                      K=(distance_bits,), index_shift=distance_bits)


def subregion_spec() -> MethodSpec:
    """Subregion TLB: large-reach entries covering an aligned 16-page
    memory subregion with a per-entry contiguity bitmap (the
    high-throughput-processor lineage, arXiv 2110.08613).  Sets are
    indexed by the subregion base, so one window maps to one set."""
    return MethodSpec(name="Subregion", kind="subregion",
                      index_shift=SUBR_BITS)


def cache_tlb_spec() -> MethodSpec:
    """Cache-backed TLB reach extension (Victima lineage, arXiv
    2310.04158): evicted L2 entries drop into a large cache-resident
    tier probed past an L1+L2 miss at L2-cache latency."""
    return MethodSpec(name="Cache-TLB", kind="cache-tlb")


def dead_protect_spec() -> MethodSpec:
    """Dead-entry protection (GPU TLB lineage, arXiv 2606.00486): a
    saturating-counter predictor bypasses L2 fills for pages never yet
    re-referenced, protecting live entries from dead-on-arrival fills."""
    return MethodSpec(name="Dead-Protect", kind="dead-protect")


def kaligned_spec(K: Sequence[int], use_predictor: bool = True,
                  name: str | None = None) -> MethodSpec:
    Kd = tuple(sorted(set(int(k) for k in K), reverse=True))
    return MethodSpec(
        name=name or f"|K|={len(Kd)} Aligned",
        kind="kaligned", K=Kd, index_shift=max(Kd) if Kd else 0,
        use_predictor=use_predictor)


def kaligned_for_histogram(hist, psi: int, theta: float = 0.9,
                           use_predictor: bool = True) -> MethodSpec:
    """K Aligned with K chosen by Algorithm 3 from a contiguity histogram.

    Use when the histogram is not derived from one mapping — e.g. the
    merged per-tenant histogram of a
    :class:`~repro_torch.core.page_table.MultiTenantMapping`, the closest
    analogue of an OS aggregating per-process contiguity stats."""
    K = determine_k(hist, theta=theta, psi=psi)
    if not K:       # fully fragmented mapping: degenerate to smallest reach
        K = [4]
    return kaligned_spec(K[:psi], use_predictor=use_predictor,
                         name=f"|K|={min(len(K), psi)} Aligned")


def kaligned_for_mapping(m: Mapping, psi: int, theta: float = 0.9,
                         use_predictor: bool = True) -> MethodSpec:
    """K Aligned with K chosen by Algorithm 3 from the mapping's histogram."""
    return kaligned_for_histogram(contiguity_histogram(m), psi=psi,
                                  theta=theta, use_predictor=use_predictor)


ANCHOR_GRID: Tuple[int, ...] = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11)


def _run_specs(specs: Sequence[MethodSpec], m: Mapping, trace: np.ndarray,
               device) -> List[SimResult]:
    """Every spec over ``(m, trace)`` in one cache-less ``run_sweep``."""
    from .sweep import SweepCell, run_sweep   # sweep builds on the kernels
    trace = np.asarray(trace)
    cells = [SweepCell(s, m, trace) for s in specs]
    return run_sweep(cells, cache=False, device=device).results


def _best_anchor(results: Sequence[SimResult], grid: Sequence[int]
                 ) -> SimResult:
    """The reference's tie rule: the first ``d`` with the fewest walks."""
    best: SimResult | None = None
    for d, r in zip(grid, results):
        if best is None or r.walks < best.walks:
            best = r
            best.name = f"Anchor-Static(best d=2^{d})"
    assert best is not None
    return best


def anchor_static(m: Mapping, trace: np.ndarray,
                  grid: Iterable[int] = ANCHOR_GRID, *,
                  device="cuda") -> SimResult:
    """Anchor-Static: exhaustively try all anchor distances, keep the best
    (paper §4.1: 'ends up with the optimal performance').  The whole grid
    runs as one sweep, on the card unless ``device="cpu"``."""
    grid = tuple(grid)
    return _best_anchor(_run_specs([anchor_spec(d) for d in grid], m, trace,
                                   device), grid)


def standard_suite(m: Mapping, trace: np.ndarray,
                   psis: Sequence[int] = (2, 3, 4),
                   anchor_grid: Iterable[int] = ANCHOR_GRID, *,
                   device="cuda") -> List[SimResult]:
    """The paper's full comparison (Figs 1/8, Table 4): Base, THP, RMM, COLT,
    Cluster, Anchor-Static, |K|=2/3/4 Aligned — every cell, the anchor grid
    included, as one sweep, on the card unless ``device="cpu"``."""
    grid = tuple(anchor_grid)
    fixed = [base_spec(), thp_spec(), rmm_spec(), colt_spec(), cluster_spec()]
    aligned = [kaligned_for_mapping(m, psi=psi) for psi in psis]
    res = _run_specs(fixed + [anchor_spec(d) for d in grid] + aligned, m,
                     trace, device)
    n = len(fixed)
    return (res[:n] + [_best_anchor(res[n:n + len(grid)], grid)]
            + res[n + len(grid):])
