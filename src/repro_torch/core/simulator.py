"""Simulator constants, method specs and results (paper §4).

The host-side part of the JAX package's ``core/simulator.py`` (its lines
52-211), copied: the k-class and latency constants, the structure
geometries, ``KINDS``, :class:`MethodSpec`, :class:`SimResult` and
:func:`miss_chain_cycles`.  The per-call jitted engine and the
pure-python segment oracle of that module are not ported yet; the port
simulates through :func:`repro_torch.core.sweep.run_sweep` only.

Every compared method is a configuration of ONE set-associative engine
(the lane program, :mod:`repro_torch.core.lane_program`): the paper's
baselines and K-bit Aligned TLB differ only in declared policy.

Latency model (Table 2): L1 hit 0 (parallel with the cache access), L2
regular hit 7, coalesced/aligned/range/cluster hit 8 (+7 per extra aligned
probe), page walk 50, paid after the failed lookup chain (§3.5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

REGULAR = -1
HUGE = 9            # k-class used for 2MB entries (2^9 pages)
KSUBR = 10          # k-class used for subregion entries (bitmapped window)
INVALID = -2
NEG = -(2 ** 30)

# Subregion TLB (arXiv 2110.08613): one entry covers a fixed-size aligned
# memory subregion with a per-entry contiguity bitmap — bit j serves page
# ``base + j`` iff it is mapped with the same VA→PA delta as the fill page.
SUBR_BITS = 4
SUBR_PAGES = 1 << SUBR_BITS

# L2-cache-backed TLB tier (Victima, arXiv 2310.04158): evicted L2 TLB
# entries are victim-inserted into repurposed cache capacity — a much
# larger but slower tier probed after the on-chip structures miss.
CTLB_SETS, CTLB_WAYS = 256, 8
LAT_CTLB = 24

# Dead-entry protection (GPU TLB lineage, arXiv 2606.00486): a table of
# saturating reuse counters; a fill whose counter is still zero is
# predicted dead-on-arrival and bypasses the L2 (the walk is paid, the
# capacity is not).  Counters learn from repeated walks to the same index.
DP_TABLE = 256

# Latencies (Table 2)
LAT_L2_REG = 7
LAT_COAL = 8
LAT_EXTRA_PROBE = 7
LAT_WALK = 50

# Translation-coherence model (Yan et al., PAPERS.md): entering an epoch
# whose events dirtied >= 1 previously-mapped page costs one shootdown
# (IPI receipt + kernel entry), plus a per-entry invalidation port write
# for every TLB entry — in ANY structure — whose covered range contains a
# dirty vpn.  Charged once per epoch transition per TLB.
#
# WHICH entries die is fixed by correctness; what the turnover *stalls* is
# ``MethodSpec.coh_policy``: IPI-style ``"shootdown"`` pays LAT_SHOOTDOWN
# per turnover (broadcast receipt + kernel entry, even when nothing
# matches) plus LAT_INVALIDATE per killed entry, while directory-tracked
# ``"hw-coherence"`` pays only the per-entry port writes — the directory
# already knows which TLBs cache the dirty range, so there is no
# broadcast stall.  Counters and translations are bit-identical between
# the two policies; only cycles differ.
LAT_SHOOTDOWN = 200
LAT_INVALIDATE = 8

# Context-switch model (multi-tenant worlds): switching the running address
# space costs the kernel switch path once, whatever the TLB does about it.
# Under ``ctx_policy="flush"`` every structure is then bulk-cleared (valid
# bits drop in one go — no per-entry port writes; the real cost is the
# refill misses, which the simulation produces naturally).  Under
# ``ctx_policy="tag"`` entries survive and are screened by ASID compare;
# only a *recycled* ASID (see page_table.MultiTenantMapping) pays a
# targeted invalidation of its stale entries.  Entries invalidated by
# either flush are counted in ``SimResult.shootdowns``.
LAT_CTX_SWITCH = 150

N_COV_SAMPLES = 64

L1_SETS, L1_WAYS = 16, 4       # 64-entry 4-way (Table 2)
L1H_SETS, L1H_WAYS = 8, 4      # 32-entry 4-way 2MB array
RMM_ENTRIES = 32
CLUS_SETS, CLUS_WAYS = 64, 5   # 320-entry 5-way clustered TLB

# Accelerator-lineage kinds run through the segment oracle and the batched
# lane program only; ``run_method`` routes them past the legacy jitted
# ``_simulate`` (which covers the original paper roster).
ACCEL_KINDS = ("subregion", "cache-tlb", "dead-protect")

#: every registered MethodSpec kind — docs/methods.md must document each
#: one (enforced by scripts/check_docs_links.py).
KINDS = ("base", "thp", "colt", "cluster", "rmm", "anchor",
         "kaligned") + ACCEL_KINDS


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Static (hashable) method configuration."""

    name: str
    kind: str                      # one of KINDS
    K: Tuple[int, ...] = ()        # alignment classes, descending
    l2_sets: int = 128
    l2_ways: int = 8
    index_shift: int = 0           # k_hat of Fig 7
    use_predictor: bool = False
    side: Optional[str] = None     # None | "rmm" | "cluster"
    #: context-switch policy on multi-tenant worlds: ``"flush"`` wipes every
    #: structure on a switch (untagged hardware), ``"tag"`` keeps entries
    #: ASID-tagged across switches (lookups only hit the live ASID; recycled
    #: ASIDs pay a targeted invalidation).  Irrelevant on single-address-
    #: space worlds: entries and probes then all carry ASID 0.
    ctx_policy: str = "flush"
    #: translation-coherence policy on remap turnovers (dynamic/nested
    #: worlds): ``"shootdown"`` is the IPI model — LAT_SHOOTDOWN broadcast
    #: stall per turnover plus LAT_INVALIDATE per killed entry —
    #: ``"hw-coherence"`` is the directory-tracked model (Yan et al.) —
    #: targeted per-entry invalidations only, no broadcast stall.  The
    #: invalidated-entry set (and so every counter and translation) is
    #: identical under both; only cycles differ.
    coh_policy: str = "shootdown"
    #: soft-error (parity-flip) policy on ParityWorld faults: ``"parity"``
    #: is detect-invalidate-rewalk — a flipped bit is caught by the parity
    #: check, EVERY entry whose covered range contains the poisoned vpn is
    #: invalidated (a |K|=k entry loses up to 2^k translations where Base
    #: loses one — the coalescing blast radius), and subsequent accesses
    #: re-walk and refill.  ``"ecc"`` is idealized in-place correction: the
    #: flip is repaired without losing any entry, so a run is bit-identical
    #: to the fault-free run by construction.  Irrelevant on worlds without
    #: parity faults.
    par_policy: str = "parity"

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert tuple(sorted(self.K, reverse=True)) == tuple(self.K)
        assert self.ctx_policy in ("flush", "tag"), self.ctx_policy
        assert self.coh_policy in ("shootdown", "hw-coherence"), \
            self.coh_policy
        assert self.par_policy in ("parity", "ecc"), self.par_policy


@dataclasses.dataclass
class SimResult:
    name: str
    accesses: int
    l1_hits: int
    l2_regular_hits: int
    l2_coalesced_hits: int
    walks: int
    aligned_probes: int
    pred_correct: int
    cycles: int
    coverage_mean: float           # Table 5 metric (covered PTEs in L2+side)
    ppn: np.ndarray                # translated PPNs (correctness oracle)
    shootdowns: int = 0            # entries invalidated by remap coherence

    @property
    def misses(self) -> int:       # "TLB misses" as plotted in Figs 1/8/9
        return self.walks

    @property
    def cpi(self) -> float:        # translation cycles per access (Fig 10/11)
        return self.cycles / max(self.accesses, 1)

    @property
    def predictor_accuracy(self) -> float:   # Table 6
        return self.pred_correct / max(self.l2_coalesced_hits, 1)


def miss_chain_cycles(spec: MethodSpec) -> int:
    """Cycles burned on the failed lookup chain before a walk (§3.5)."""
    if spec.K and spec.kind in ("kaligned", "anchor"):
        return LAT_COAL + LAT_EXTRA_PROBE * (len(spec.K) - 1)
    if spec.kind == "cache-tlb":
        return LAT_CTLB                  # the cache-backed tier probes last
    if spec.kind in ("colt", "subregion") or spec.side is not None:
        return LAT_COAL
    return LAT_L2_REG

