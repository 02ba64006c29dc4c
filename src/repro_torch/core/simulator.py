"""Simulator constants, method specs, the per-call entry point and the
segment oracle (paper §4).

The JAX package's ``core/simulator.py`` without its per-call jitted engine:
the k-class and latency constants, the structure geometries, ``KINDS``,
:class:`MethodSpec`, :class:`SimResult` and :func:`miss_chain_cycles`
(its lines 52-211), and the pure-python segment oracle (its lines
620-1281: :func:`run_method_dynamic`, :func:`run_method_multitenant`,
:func:`run_method_nested`, :func:`run_method_parity` over one loop,
:func:`_run_segments`), copied.  :func:`run_method`, the reference's
jitted per-call engine, is here one lane of
:func:`repro_torch.core.sweep.run_sweep`: the TLB-sweep kernel on the
card, its plain version on the CPU.

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

from .page_table import (DynamicMapping, Mapping, MultiTenantMapping,
                         NestedMapping, ParityWorld, cluster_bitmap)

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

# Accelerator-lineage kinds (the JAX package's jitted per-call engine covers
# only the original paper roster and routes these to the segment oracle;
# the port's ``run_method`` runs every kind through the lane program).
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


def run_method(spec: MethodSpec, m: Mapping, trace: np.ndarray, *,
               device="cuda") -> SimResult:
    """Simulate one method over (mapping, trace) and collect paper metrics.

    One lane of :func:`repro_torch.core.sweep.run_sweep` with the cache
    off: the TLB-sweep kernel on the card (``device="cuda"``, the default;
    raises ``RuntimeError`` without a card, never running the oracle or
    the plain version instead), its plain torch version with
    ``device="cpu"``.  Every kind runs there, the accelerator kinds
    included, and the result — ``name``, counters, coverage and ppn —
    equals the JAX package's ``run_method`` (``tests/test_torch_oracle.py``).
    """
    from .sweep import SweepCell, run_sweep   # sweep imports this module
    cell = SweepCell(spec, m, np.asarray(trace))
    return run_sweep([cell], cache=False, device=device).results[0]


# ---------------------------------------------------------------------------
# Segment-driven pure-python oracle (dynamic AND multi-tenant worlds)
# ---------------------------------------------------------------------------
#
# ``run_method_dynamic`` / ``run_method_multitenant`` are the correctness
# references for mid-trace remaps and for multi-tenant context switching: a
# plain numpy state machine with the exact semantics of the lane program,
# plus (a) paper-correct translation coherence — entering an epoch whose
# events dirtied pages, every structure (L1, 2MB L1, L2, RMM ranges,
# clustered side-TLB) drops every entry whose covered range contains a vpn
# whose translation died, and the shootdown cost is charged — and (b)
# ASID-correct context switching: every entry in every structure carries
# the ASID it was filled under, lookups only hit entries of the live ASID,
# and a switch either bulk-flushes (``ctx_policy="flush"``) or relies on
# the tags (``"tag"``, with targeted invalidation of recycled ASIDs).
# Both run over one shared segment loop (:func:`_run_segments`); the
# batched lanes of :mod:`repro_torch.core.sweep` must match it bit for bit
# (tests/test_torch_oracle.py).  It is deliberately written without torch
# so an engine bug cannot hide in shared machinery.


def _as_dynamic(world) -> DynamicMapping:
    if isinstance(world, DynamicMapping):
        return world
    return DynamicMapping((world,), (0,), name=world.name)


@dataclasses.dataclass
class _OracleSegment:
    """One schedule segment of the oracle: mapping + per-entry records live
    from trace step ``lo``, entered with optional coherence/switch work."""

    lo: int
    m: Mapping
    fill: np.ndarray                      # [n_pages, 4] fill profile
    clus: Optional[np.ndarray]            # [n_pages] cluster bitmap
    asid: int = 0
    switch: bool = False                  # address space changed: charge it
    flush_all: bool = False               # wipe every structure on entry
    flush_asid: bool = False              # wipe entries tagged asid (recycle)
    dirty: Optional[np.ndarray] = None    # bool[n_pages] shootdown set


def _segs_dynamic(spec: MethodSpec, world) -> list:
    # lazy: lane_program imports this module
    from .lane_program import _fill_profile, _fill_profile_key

    dyn = _as_dynamic(world)
    fkey = _fill_profile_key(spec)
    has_clus = spec.side == "cluster"
    segs = []
    for e, m in enumerate(dyn.epochs):
        dirty = dyn.dirty(e) if e >= 1 else None
        if dirty is not None and not dirty.any():
            dirty = None
        segs.append(_OracleSegment(
            lo=dyn.boundaries[e], m=m,
            fill=_fill_profile(m, fkey, m.n_pages),
            clus=cluster_bitmap(m) if has_clus else None,
            dirty=dirty))
    return segs


def run_method_dynamic(spec: MethodSpec, world, trace: np.ndarray,
                       on_step=None, on_event=None) -> SimResult:
    """Simulate one method over a (possibly dynamic) world, pure python."""
    return _run_segments(spec, _segs_dynamic(spec, world), trace,
                         on_step=on_step, on_event=on_event)


def run_method_multitenant(spec: MethodSpec, world: MultiTenantMapping,
                           trace: np.ndarray, on_step=None, on_event=None
                           ) -> SimResult:
    """Simulate one method over a multi-tenant world, pure python.

    Every trace entry is a vpn of the tenant scheduled at that step
    (:meth:`~repro_torch.core.page_table.MultiTenantMapping.tenant_at`);
    whether a context switch flushes or relies on ASID tags is
    ``spec.ctx_policy``.  The sweep engine's switch-segmented lanes must
    match this bit for bit (``tests/test_torch_oracle.py``)."""
    return _run_segments(spec, _segs_multitenant(spec, world), trace,
                         on_step=on_step, on_event=on_event)


def _segs_multitenant(spec: MethodSpec, world: MultiTenantMapping) -> list:
    # lazy: lane_program imports this module
    from .lane_program import _fill_profile, _fill_profile_key

    assert isinstance(world, MultiTenantMapping)
    fkey = _fill_profile_key(spec)
    has_clus = spec.side == "cluster"
    fill_of: dict = {}
    clus_of: dict = {}
    segs = []
    for s in range(world.n_segments):
        tid = world.tenant_ids[s]
        m = world.tenants[tid]
        if tid not in fill_of:
            fill_of[tid] = _fill_profile(m, fkey, m.n_pages)
            clus_of[tid] = cluster_bitmap(m) if has_clus else None
        sw = world.switches(s)
        segs.append(_OracleSegment(
            lo=world.boundaries[s], m=m, fill=fill_of[tid],
            clus=clus_of[tid], asid=world.asids[s], switch=sw,
            flush_all=sw and spec.ctx_policy == "flush",
            flush_asid=world.recycled[s] and spec.ctx_policy == "tag"))
    return segs


def run_method_nested(spec: MethodSpec, world: NestedMapping,
                      trace: np.ndarray, on_step=None, on_event=None
                      ) -> SimResult:
    """Simulate one method over a nested (guest → host) world, pure python.

    Segments are the union grid of
    :meth:`~repro_torch.core.page_table.NestedMapping.plan_segments` — VM
    schedule × guest epochs × host epochs — so one oracle loop discharges
    the dynamic × multi-tenant combination: a VM switch is a context
    switch under ``spec.ctx_policy``, and a guest- or host-level remap is
    a coherence turnover over the *composed* dirty set, charged under
    ``spec.coh_policy``.  The sweep engine's nested lanes must match this
    bit for bit (``tests/test_torch_oracle.py``, the fuzz twin)."""
    return _run_segments(spec, _segs_nested(spec, world), trace,
                         on_step=on_step, on_event=on_event)


def _segs_nested(spec: MethodSpec, world: NestedMapping) -> list:
    # lazy: lane_program imports this module
    from .lane_program import _fill_profile, _fill_profile_key

    assert isinstance(world, NestedMapping)
    fkey = _fill_profile_key(spec)
    has_clus = spec.side == "cluster"
    fill_of: dict = {}
    clus_of: dict = {}
    segs = []
    for ns in world.plan_segments():
        m = ns.mapping
        key = id(m)                      # composed views are memoized
        if key not in fill_of:
            fill_of[key] = _fill_profile(m, fkey, m.n_pages)
            clus_of[key] = cluster_bitmap(m) if has_clus else None
        segs.append(_OracleSegment(
            lo=ns.lo, m=m, fill=fill_of[key], clus=clus_of[key],
            asid=ns.asid, switch=ns.switch,
            flush_all=ns.switch and spec.ctx_policy == "flush",
            flush_asid=ns.recycled and spec.ctx_policy == "tag",
            dirty=ns.dirty))
    return segs


def _base_segments(spec: MethodSpec, base) -> list:
    """Oracle segment plan for any (non-parity) base world."""
    if isinstance(base, NestedMapping):
        return _segs_nested(spec, base)
    if isinstance(base, MultiTenantMapping):
        return _segs_multitenant(spec, base)
    return _segs_dynamic(spec, base)     # handles static too


def run_method_parity(spec: MethodSpec, world: ParityWorld,
                      trace: np.ndarray, on_step=None, on_event=None
                      ) -> SimResult:
    """Simulate one method over a parity-fault world, pure python.

    Each ``(step, vpn)`` fault is lowered to an extra segment boundary at
    ``step`` that keeps the live mapping, fill profile and ASID — so no
    context-switch work happens — and, under ``par_policy="parity"``,
    carries a single-vpn dirty set: entering it runs the standard
    detect-invalidate pass (every entry covering the vpn dies; a |K|=k
    entry loses up to ``2^k`` translations where Base loses one) charged
    like a coherence turnover under ``spec.coh_policy``, and subsequent
    accesses re-walk and refill — the detect-invalidate-rewalk recovery.
    Under ``par_policy="ecc"`` the fault segment carries no dirty set and
    the whole run is bit-identical to the fault-free run by construction.
    The sweep engine's parity-spliced lanes must match this bit for bit
    (``tests/test_torch_oracle.py``)."""
    assert isinstance(world, ParityWorld)
    segs = _base_segments(spec, world.base)
    for t, vpn in world.faults:
        # the segment live at step t: the last one with lo <= t
        live_i = max(i for i, sg in enumerate(segs) if sg.lo <= t)
        live = segs[live_i]
        assert 0 <= vpn < live.m.n_pages, (t, vpn, live.m.n_pages)
        dirty = None
        if spec.par_policy == "parity":
            dirty = np.zeros(live.m.n_pages, bool)
            dirty[vpn] = True
        segs.insert(live_i + 1, _OracleSegment(
            lo=t, m=live.m, fill=live.fill, clus=live.clus,
            asid=live.asid, dirty=dirty))
    return _run_segments(spec, segs, trace, on_step=on_step,
                         on_event=on_event)


def _run_segments(spec: MethodSpec, segs, trace: np.ndarray,
                  on_step=None, on_event=None) -> SimResult:
    """The shared oracle loop: one TLB, a segment schedule, ASID tags.

    ``on_step(dict)`` (when given) receives one record per access —
    ``{t, vpn, asid, level, ppn, walk, evict, probes, cycles}`` with
    ``level`` in ``l1|l2reg|l2coal|side|walk`` — and ``on_event(dict)``
    one record per segment-entry action (``kind`` in ``switch|shootdown``
    with the invalidated-entry count): the golden-trace suite
    (``tests/goldens``) pins these step sequences so a parity failure
    localizes to a step instead of an end-of-run counter diff.
    """
    trace = np.asarray(trace, np.int64)
    T = int(trace.shape[0])
    Ks = spec.K
    k_hat = spec.index_shift
    set_mask = spec.l2_sets - 1
    miss_chain = miss_chain_cycles(spec)
    is_colt = spec.kind == "colt"
    is_thp = spec.kind == "thp"
    has_rmm = spec.side == "rmm"
    has_clus = spec.side == "cluster"
    is_subr = spec.kind == "subregion"
    has_ctlb = spec.kind == "cache-tlb"
    use_dead = spec.kind == "dead-protect"

    # -- state ------------------------------------------------------------
    l1_tag = np.full((L1_SETS, L1_WAYS), -1, np.int64)
    l1_ppn = np.full((L1_SETS, L1_WAYS), -1, np.int64)
    l1_lru = np.zeros((L1_SETS, L1_WAYS), np.int64)
    l1_asid = np.zeros((L1_SETS, L1_WAYS), np.int64)
    l1h_tag = np.full((L1H_SETS, L1H_WAYS), -1, np.int64)
    l1h_ppn = np.full((L1H_SETS, L1H_WAYS), -1, np.int64)
    l1h_lru = np.zeros((L1H_SETS, L1H_WAYS), np.int64)
    l1h_asid = np.zeros((L1H_SETS, L1H_WAYS), np.int64)
    l2_tag = np.full((spec.l2_sets, spec.l2_ways), -1, np.int64)
    l2_k = np.full((spec.l2_sets, spec.l2_ways), INVALID, np.int64)
    l2_contig = np.zeros((spec.l2_sets, spec.l2_ways), np.int64)
    l2_ppn = np.full((spec.l2_sets, spec.l2_ways), -1, np.int64)
    l2_lru = np.zeros((spec.l2_sets, spec.l2_ways), np.int64)
    l2_asid = np.zeros((spec.l2_sets, spec.l2_ways), np.int64)
    l2_aux = np.zeros((spec.l2_sets, spec.l2_ways), np.int64)
    rmm_start = np.full(RMM_ENTRIES, -1, np.int64)
    rmm_len = np.zeros(RMM_ENTRIES, np.int64)
    rmm_ppn = np.full(RMM_ENTRIES, -1, np.int64)
    rmm_lru = np.zeros(RMM_ENTRIES, np.int64)
    rmm_asid = np.zeros(RMM_ENTRIES, np.int64)
    cl_tag = np.full((CLUS_SETS, CLUS_WAYS), -1, np.int64)
    cl_bm = np.zeros((CLUS_SETS, CLUS_WAYS), np.int64)
    cl_lru = np.zeros((CLUS_SETS, CLUS_WAYS), np.int64)
    cl_asid = np.zeros((CLUS_SETS, CLUS_WAYS), np.int64)
    ctlb_tag = np.full((CTLB_SETS, CTLB_WAYS), -1, np.int64)
    ctlb_ppn = np.full((CTLB_SETS, CTLB_WAYS), -1, np.int64)
    ctlb_lru = np.zeros((CTLB_SETS, CTLB_WAYS), np.int64)
    ctlb_asid = np.zeros((CTLB_SETS, CTLB_WAYS), np.int64)
    dp_ctr = np.zeros(DP_TABLE, np.int64)
    pred = int(Ks[0]) if Ks else 0
    cur_asid = segs[0].asid

    n_l1 = n_reg = n_coal = n_walk = n_probe = n_pred = 0
    cycles = cov = n_shoot = 0
    sample_every = max(T // N_COV_SAMPLES, 1)
    cov_samples = np.zeros(N_COV_SAMPLES, np.int64)
    out = np.empty(T, np.int64)
    seg_i = 0

    def shootdown(t: int, dirty: np.ndarray, n_pages: int):
        """Invalidate every entry covering a dirty vpn; charge the cost.

        Coherence invalidation is ASID-blind: a translation died for
        whichever address space held it (in single-space worlds every
        entry carries ASID 0 anyway)."""
        nonlocal n_shoot, cycles, cov
        dcum = np.concatenate([[0], np.cumsum(dirty)])

        def rng_dirty(lo, ln):
            lo_ = np.clip(lo, 0, n_pages)
            hi_ = np.clip(lo + ln, 0, n_pages)
            return (dcum[hi_] - dcum[lo_]) > 0

        n_inv = 0
        cov_loss = 0
        valid2 = l2_k != INVALID
        # k == HUGE means "2MB entry, tag is vpn >> 9" only on THP lanes;
        # for K-bit Aligned, k = 9 is an ordinary alignment class whose tag
        # is the window base vpn.
        huge2 = is_thp & (l2_k == HUGE)
        lo2 = np.where(huge2, l2_tag << 9, l2_tag)
        # a subregion entry covers its whole aligned window: invalidation is
        # conservative over [tag, tag + SUBR_PAGES) (a cleared bitmap bit is
        # only ever a miss, never a stale translation, so over-invalidating
        # is safe and keeps the range query uniform)
        ln2 = np.where(huge2, 512,
                       np.where(is_subr & (l2_k == KSUBR), SUBR_PAGES,
                                np.where(l2_k == REGULAR, 1,
                                         np.maximum(l2_contig, 1))))
        stale2 = valid2 & rng_dirty(np.maximum(lo2, 0), ln2)
        n_inv += int(stale2.sum())
        cov_loss += int(l2_contig[stale2].sum())
        l2_k[stale2] = INVALID

        v1 = l1_tag >= 0
        stale1 = v1 & rng_dirty(np.maximum(l1_tag, 0), 1)
        n_inv += int(stale1.sum())
        l1_tag[stale1] = -1

        vh = l1h_tag >= 0
        staleh = vh & rng_dirty(np.maximum(l1h_tag, 0) << 9, 512)
        n_inv += int(staleh.sum())
        l1h_tag[staleh] = -1

        vr = rmm_len > 0
        staler = vr & rng_dirty(np.maximum(rmm_start, 0), rmm_len)
        n_inv += int(staler.sum())
        cov_loss += int(rmm_len[staler].sum())
        rmm_start[staler] = -1
        rmm_len[staler] = 0
        rmm_ppn[staler] = -1

        vc = cl_bm != 0
        stalec = vc & rng_dirty(np.maximum(cl_tag, 0) << 3, 8)
        n_inv += int(stalec.sum())
        cl_bm[stalec] = 0

        vt = ctlb_tag >= 0
        stalet = vt & rng_dirty(np.maximum(ctlb_tag, 0), 1)
        n_inv += int(stalet.sum())
        cov_loss += int(stalet.sum())
        ctlb_tag[stalet] = -1
        # the dead-entry counter table holds predictions, not translations:
        # nothing to invalidate

        n_shoot += n_inv
        if spec.coh_policy == "hw-coherence":
            # directory-tracked: targeted port writes only, no IPI stall
            cycles += LAT_INVALIDATE * n_inv
        else:
            cycles += LAT_SHOOTDOWN + LAT_INVALIDATE * n_inv
        cov -= cov_loss
        if on_event is not None:
            on_event(dict(t=t, kind="shootdown", invalidated=n_inv))

    def ctx_switch(t: int, seg: _OracleSegment):
        """Enter a schedule segment: set the live ASID, charge the switch,
        and flush — everything (``flush_all``) or the recycled ASID's stale
        entries (``flush_asid``).  Flushes are bulk valid-bit clears (no
        per-entry port writes); the refill misses are the real cost."""
        nonlocal cur_asid, n_shoot, cycles, cov
        cur_asid = seg.asid
        n_inv = 0
        if seg.flush_all or seg.flush_asid:
            def kill(valid, asid_arr):
                mask = np.asarray(valid)
                if not seg.flush_all:
                    mask = mask & (asid_arr == seg.asid)
                return mask

            k2 = kill(l2_k != INVALID, l2_asid)
            n_inv += int(k2.sum())
            cov -= int(l2_contig[k2].sum())
            l2_k[k2] = INVALID
            k1 = kill(l1_tag >= 0, l1_asid)
            n_inv += int(k1.sum())
            l1_tag[k1] = -1
            kh = kill(l1h_tag >= 0, l1h_asid)
            n_inv += int(kh.sum())
            l1h_tag[kh] = -1
            kr = kill(rmm_len > 0, rmm_asid)
            n_inv += int(kr.sum())
            cov -= int(rmm_len[kr].sum())
            rmm_start[kr] = -1
            rmm_len[kr] = 0
            rmm_ppn[kr] = -1
            kc = kill(cl_bm != 0, cl_asid)
            n_inv += int(kc.sum())
            cl_bm[kc] = 0
            kt = kill(ctlb_tag >= 0, ctlb_asid)
            n_inv += int(kt.sum())
            cov -= int(kt.sum())
            ctlb_tag[kt] = -1
            n_shoot += n_inv
        if seg.switch:
            cycles += LAT_CTX_SWITCH
        if on_event is not None and (seg.switch or n_inv):
            on_event(dict(t=t, kind="switch", asid=seg.asid,
                          invalidated=n_inv))

    for t in range(T):
        while seg_i + 1 < len(segs) and t == segs[seg_i + 1].lo:
            seg_i += 1
            seg = segs[seg_i]
            if seg.switch or seg.flush_all or seg.flush_asid \
                    or seg.asid != cur_asid:
                ctx_switch(t, seg)
            if seg.dirty is not None:
                # the dirty array fixes the vpn range it covers (nested
                # worlds union dirty sets over ALL guests, whose footprint
                # may exceed the scheduled guest's)
                shootdown(t, seg.dirty, int(seg.dirty.shape[0]))
        seg = segs[seg_i]
        m = seg.m
        n_pages = m.n_pages
        vpn = int(trace[t])
        ppn_true = int(m.ppn[vpn])
        frec = seg.fill[vpn]
        fill_tag, fill_k, fill_contig, fill_ppn = (int(frec[0]), int(frec[1]),
                                                   int(frec[2]), int(frec[3]))
        fill_aux = int(frec[4])

        # ---------------- L1 ---------------------------------------------
        s1 = vpn & (L1_SETS - 1)
        hits1 = (l1_tag[s1] == vpn) & (l1_asid[s1] == cur_asid)
        l1_hit = bool(hits1.any())
        l1_way = int(np.argmax(hits1))
        hv = vpn >> 9
        s1h = hv & (L1H_SETS - 1)
        hitsh = (l1h_tag[s1h] == hv) & (l1h_asid[s1h] == cur_asid)
        l1h_hit = is_thp and bool(hitsh.any())
        l1h_way = int(np.argmax(hitsh))
        l1_served = l1_hit or l1h_hit
        l1_out = (int(l1_ppn[s1, l1_way]) if l1_hit
                  else int(l1h_ppn[s1h, l1h_way]) + (vpn & 511))

        # ---------------- L2 probes --------------------------------------
        s2 = (vpn >> k_hat) & set_mask
        tags = l2_tag[s2]
        kcls = l2_k[s2]
        contig = l2_contig[s2]
        pbase = l2_ppn[s2]
        valid = (kcls != INVALID) & (l2_asid[s2] == cur_asid)
        probes_used = 0
        pred_ok = 0
        hit_k = -1
        coal_hit = False
        coal_ppn = -1
        s2h = hv & set_mask
        if is_colt:
            diff = vpn - tags
            cover = valid & (diff >= 0) & (diff < contig)
            l2h = bool(cover.any())
            way = int(np.argmax(cover))
            reg_hit = l2h and int(contig[way]) == 1
            coal_hit = l2h and int(contig[way]) > 1
            l2_ppn_val = int(pbase[way]) + (vpn - int(tags[way]))
            touch_set, tw = s2, way
        elif is_thp:
            huge_ways = (l2_k[s2h] == HUGE) & (l2_tag[s2h] == hv) & \
                (l2_asid[s2h] == cur_asid)
            reg_ways = (kcls == REGULAR) & (tags == vpn) & valid
            huge_hit = bool(huge_ways.any())
            hw = int(np.argmax(huge_ways))
            rw = int(np.argmax(reg_ways))
            any_reg = bool(reg_ways.any())
            reg_hit = any_reg or huge_hit
            l2h = reg_hit
            l2_ppn_val = (int(pbase[rw]) if any_reg
                          else int(l2_ppn[s2h, hw]) + (vpn - (hv << 9)))
            touch_set = s2 if any_reg else s2h
            tw = rw if any_reg else hw
        elif is_subr:
            # subregion entry: tag is the aligned window base; the per-entry
            # bitmap (AUX plane) says which window pages it serves
            base = vpn & ~(SUBR_PAGES - 1)
            off = vpn & (SUBR_PAGES - 1)
            cover = valid & (kcls == KSUBR) & (tags == base) & \
                (((l2_aux[s2] >> off) & 1) == 1)
            l2h = bool(cover.any())
            way = int(np.argmax(cover))
            reg_hit = l2h and int(contig[way]) == 1
            coal_hit = l2h and int(contig[way]) > 1
            l2_ppn_val = int(pbase[way]) + off
            touch_set, tw = s2, way
        else:
            reg_ways = (kcls == REGULAR) & (tags == vpn) & valid
            reg_hit = bool(reg_ways.any())
            rw = int(np.argmax(reg_ways))
            if Ks:
                if spec.use_predictor:
                    order = [pred] + [k for k in Ks if k != pred]
                else:
                    order = list(Ks)
            else:
                order = []
            first_probe_k = order[0] if order else -1
            coal_way = 0
            for k_val in order:
                if not reg_hit and not coal_hit:
                    probes_used += 1
                    vk = vpn & ~((1 << k_val) - 1)
                    m_ways = ((kcls == k_val) & (tags == vk) & valid
                              & (contig > (vpn - vk)))
                    if bool(m_ways.any()):
                        coal_way = int(np.argmax(m_ways))
                        coal_ppn = int(pbase[coal_way]) + (vpn - vk)
                        hit_k = k_val
                        coal_hit = True
            l2h = reg_hit or coal_hit
            l2_ppn_val = int(pbase[rw]) if reg_hit else coal_ppn
            if spec.use_predictor and coal_hit and hit_k == first_probe_k:
                pred_ok = 1
            touch_set = s2
            tw = rw if reg_hit else coal_way

        # ---------------- side structures --------------------------------
        side_hit = False
        side_ppn = -1
        if has_rmm:
            d_r = vpn - rmm_start
            in_rng = (d_r >= 0) & (d_r < rmm_len) & (rmm_asid == cur_asid)
            if bool(in_rng.any()):
                side_hit = True
                sw = int(np.argmax(in_rng))
                side_ppn = int(rmm_ppn[sw]) + int(d_r[sw])
        cwd = vpn >> 3
        sc = cwd & (CLUS_SETS - 1)
        if has_clus:
            bit = (cl_bm[sc] >> (vpn & 7)) & 1
            c_ways = (cl_tag[sc] == cwd) & (bit == 1) & \
                (cl_asid[sc] == cur_asid)
            if bool(c_ways.any()):
                side_hit = True
                side_ppn = ppn_true
        ctlb_hit = False
        sct = vpn & (CTLB_SETS - 1)
        ctlb_way = 0
        if has_ctlb and not (l1_served or l2h):
            t_ways = (ctlb_tag[sct] == vpn) & (ctlb_asid[sct] == cur_asid)
            if bool(t_ways.any()):
                side_hit = ctlb_hit = True
                ctlb_way = int(np.argmax(t_ways))
                side_ppn = int(ctlb_ppn[sct, ctlb_way])

        walk = not (l1_served or l2h or side_hit)

        # ---------------- latency ----------------------------------------
        if l1_served:
            cyc = 0
        elif reg_hit:
            cyc = LAT_L2_REG
        elif coal_hit:
            cyc = LAT_COAL + LAT_EXTRA_PROBE * max(probes_used - 1, 0)
        elif side_hit:
            cyc = LAT_CTLB if ctlb_hit else LAT_COAL
        else:
            cyc = miss_chain + LAT_WALK

        # ---------------- L2 fill ----------------------------------------
        served_huge = is_thp and fill_k == HUGE
        dp_bypass = False
        if use_dead and walk:
            dp_idx = vpn & (DP_TABLE - 1)
            dp_bypass = int(dp_ctr[dp_idx]) == 0   # never re-referenced yet
            dp_ctr[dp_idx] = min(int(dp_ctr[dp_idx]) + 1, 3)
        evict = False
        if walk and not dp_bypass:
            fill_set = s2h if served_huge else s2
            valid_row = l2_k[fill_set] != INVALID
            score = np.where(valid_row, l2_lru[fill_set], NEG)
            victim = int(np.argmin(score))
            evict = bool(valid_row[victim])
            evicted = int(l2_contig[fill_set, victim]) if evict else 0
            if has_ctlb and evict:
                # Victima move: the evicted on-chip entry drops into the
                # cache-backed tier instead of dying (its own LRU victim
                # within the tag-indexed set pays the 1-page coverage loss)
                ev_tag = int(l2_tag[fill_set, victim])
                ev_ppn = int(l2_ppn[fill_set, victim])
                ev_asid = int(l2_asid[fill_set, victim])
                sct_v = ev_tag & (CTLB_SETS - 1)
                vrow_t = ctlb_tag[sct_v] >= 0
                victim_t = int(np.argmin(np.where(vrow_t, ctlb_lru[sct_v],
                                                  NEG)))
                cov += 1 - (1 if vrow_t[victim_t] else 0)
                ctlb_tag[sct_v, victim_t] = ev_tag
                ctlb_ppn[sct_v, victim_t] = ev_ppn
                ctlb_lru[sct_v, victim_t] = t
                ctlb_asid[sct_v, victim_t] = ev_asid
            l2_tag[fill_set, victim] = fill_tag
            l2_k[fill_set, victim] = fill_k
            l2_contig[fill_set, victim] = fill_contig
            l2_ppn[fill_set, victim] = fill_ppn
            l2_lru[fill_set, victim] = t
            l2_asid[fill_set, victim] = cur_asid
            l2_aux[fill_set, victim] = fill_aux
            cov += fill_contig - evicted
        elif l2h and not l1_served:
            l2_lru[touch_set, tw] = t
        if ctlb_hit:
            ctlb_lru[sct, ctlb_way] = t

        # ---------------- side fills -------------------------------------
        if has_rmm:
            rs_v = int(m.run_start[vpn])
            rl_v = int(m.run_len[vpn])
            if walk:
                vrm = rmm_len > 0
                victim_r = int(np.argmin(np.where(vrm, rmm_lru, NEG)))
                ev_len = int(rmm_len[victim_r]) if vrm[victim_r] else 0
                rmm_start[victim_r] = rs_v
                rmm_len[victim_r] = rl_v
                rmm_ppn[victim_r] = int(
                    m.ppn[min(max(rs_v, 0), n_pages - 1)])
                rmm_lru[victim_r] = t
                rmm_asid[victim_r] = cur_asid
                cov += rl_v - ev_len
            elif side_hit:
                rmm_lru[sw] = t
        if has_clus:
            bm = int(seg.clus[vpn])
            if walk and bm != (1 << (vpn & 7)):
                vrow = cl_bm[sc] != 0
                victim_c = int(np.argmin(np.where(vrow, cl_lru[sc], NEG)))
                cl_tag[sc, victim_c] = cwd
                cl_bm[sc, victim_c] = bm
                cl_lru[sc, victim_c] = t
                cl_asid[sc, victim_c] = cur_asid
            elif side_hit:
                hit_cway = int(np.argmax((cl_tag[sc] == cwd)
                                         & (cl_asid[sc] == cur_asid)))
                cl_lru[sc, hit_cway] = t

        # ---------------- L1 fills ---------------------------------------
        if is_thp:
            if not l1_served and served_huge:
                vrh = l1h_tag[s1h] >= 0
                vich = int(np.argmin(np.where(vrh, l1h_lru[s1h], NEG)))
                l1h_tag[s1h, vich] = hv
                l1h_ppn[s1h, vich] = fill_ppn
                l1h_lru[s1h, vich] = t
                l1h_asid[s1h, vich] = cur_asid
            if l1_served and bool(hitsh.any()) and not l1_hit:
                l1h_lru[s1h, l1h_way] = t
            do1 = not l1_served and not served_huge
        else:
            do1 = not l1_served
        if do1:
            vr1 = l1_tag[s1] >= 0
            vic1 = int(np.argmin(np.where(vr1, l1_lru[s1], NEG)))
            l1_tag[s1, vic1] = vpn
            l1_ppn[s1, vic1] = ppn_true
            l1_lru[s1, vic1] = t
            l1_asid[s1, vic1] = cur_asid
        if l1_hit:
            l1_lru[s1, l1_way] = t

        # ---------------- predictor update -------------------------------
        if spec.use_predictor and Ks:
            if coal_hit:
                pred = hit_k
            elif walk and fill_k >= 0:
                pred = fill_k

        # ---------------- accounting -------------------------------------
        n_l1 += l1_served
        n_reg += reg_hit and not l1_served
        n_coal += (coal_hit or side_hit) and not reg_hit and not l1_served
        n_walk += walk
        if coal_hit and not l1_served:
            n_probe += probes_used
        if not l1_served:
            n_pred += pred_ok
        if dp_bypass:
            n_pred += 1            # dead-protect: bypassed fills ride C_PRED
        cycles += cyc
        slot = min(t // sample_every, N_COV_SAMPLES - 1)
        if t % sample_every == sample_every - 1:
            cov_samples[slot] = cov

        out[t] = (l1_out if l1_served
                  else l2_ppn_val if l2h
                  else side_ppn if side_hit
                  else ppn_true)
        if on_step is not None:
            level = ("l1" if l1_served else "l2reg" if reg_hit
                     else "l2coal" if coal_hit else "side" if side_hit
                     else "walk")
            on_step(dict(t=t, vpn=vpn, asid=cur_asid, level=level,
                         ppn=int(out[t]), walk=bool(walk),
                         evict=bool(evict), probes=int(probes_used),
                         cycles=int(cyc)))

    return SimResult(
        name=spec.name, accesses=T, l1_hits=int(n_l1),
        l2_regular_hits=int(n_reg), l2_coalesced_hits=int(n_coal),
        walks=int(n_walk), aligned_probes=int(n_probe),
        pred_correct=int(n_pred), cycles=int(cycles),
        coverage_mean=float(np.mean(cov_samples)), ppn=out,
        shootdowns=int(n_shoot))
