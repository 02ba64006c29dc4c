"""Frozen copy of the method factories of
``src/repro_torch/core/baselines.py`` (Table 2's geometries) that the
benchmark's sweep roster uses.  The benchmark builds every spec here, so
the roster, and K as Algorithm 3 picks it, are inputs that both the
program and the reference are given.  Not to be edited.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from .determine_k import determine_k


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """A method of the roster (``src/repro_torch/core/simulator.py``'s
    fields): its kind, its alignment classes K (descending), its L2
    geometry and index shift, the predictor, the side structure, and the
    policies of worlds with several address spaces, remaps or faults,
    which a static mapping leaves unused."""

    name: str
    kind: str
    K: Tuple[int, ...] = ()
    l2_sets: int = 128
    l2_ways: int = 8
    index_shift: int = 0
    use_predictor: bool = False
    side: Optional[str] = None
    ctx_policy: str = "flush"
    coh_policy: str = "shootdown"
    par_policy: str = "parity"


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


def kaligned_spec(K: Sequence[int], use_predictor: bool = True,
                  name: str | None = None) -> MethodSpec:
    Kd = tuple(sorted(set(int(k) for k in K), reverse=True))
    return MethodSpec(
        name=name or f"|K|={len(Kd)} Aligned",
        kind="kaligned", K=Kd, index_shift=max(Kd) if Kd else 0,
        use_predictor=use_predictor)


def kaligned_for_histogram(hist, psi: int, theta: float = 0.9,
                           use_predictor: bool = True) -> MethodSpec:
    """K Aligned with K chosen by Algorithm 3 from a contiguity histogram
    (for a multi-tenant or nested world, the merged per-tenant one)."""
    K = determine_k(hist, theta=theta, psi=psi)
    if not K:       # fully fragmented mapping: degenerate to smallest reach
        K = [4]
    return kaligned_spec(K[:psi], use_predictor=use_predictor,
                         name=f"|K|={min(len(K), psi)} Aligned")


def suite_specs(hist, anchor_grid, psis):
    """``chip_smoke.py::suite_specs``'s roster (that of
    ``benchmarks/tlb_suite.py::_add_suite``) as ``(spec, label, group)``:
    Base, THP, RMM, COLT, Cluster, Anchor over ``anchor_grid`` and |K| =
    psi Aligned for each psi (theta 1.0 above psi 2, else 0.9), K from the
    histogram ``hist``."""
    out = [(base_spec(), "Base", "plain"), (thp_spec(), "THP", "plain"),
           (rmm_spec(), "RMM", "plain"), (colt_spec(), "COLT", "plain"),
           (cluster_spec(), "Cluster", "plain")]
    out += [(anchor_spec(d), "Anchor-Static", "anchor") for d in anchor_grid]
    for psi in psis:
        theta = 1.0 if psi > 2 else 0.9
        out.append((kaligned_for_histogram(hist, psi=psi, theta=theta),
                    f"|K|={psi}", "plain"))
    return out
