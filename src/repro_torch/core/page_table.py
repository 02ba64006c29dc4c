"""Contiguity-annotated page table (paper §2, Definition 1 and §3.1).

A memory mapping for a process is modelled as a dense array ``ppn`` over a
virtual footprint of ``n_pages`` pages: ``ppn[vpn]`` is the physical page
number backing virtual page ``vpn`` (``-1`` = unmapped).

From ``ppn`` we derive, exactly as the paper's OS would by scanning the page
table:

* ``run_start[vpn]`` / ``run_len[vpn]``: the *contiguity chunk* (Def. 1)
  containing ``vpn`` — the maximal range of pages contiguous in both VA and
  PA.  The per-PTE ``contiguity`` field of §3.1 is
  ``run_start[vpn] + run_len[vpn] - vpn``.
* the contiguity-chunk list and the contiguity histogram used by Algorithm 3.

Mappings are not static: demand paging, compaction, THP promotion/splitting
and allocation churn — the very mechanisms the paper credits for *producing*
mixed contiguity — rewrite translations mid-run.  :class:`MappingEvent`
models one such OS action, and :class:`DynamicMapping` is an epoch sequence:
``epochs[e]`` is the live mapping for trace steps in
``[boundaries[e], boundaries[e+1])``, with ``events[e]`` the event batch
applied on entering epoch ``e``.  Translation coherence (the shootdown
semantics of Yan et al., "Hardware Translation Coherence for Virtualized
Systems") is derived from the *snapshot diff*: entering epoch ``e``, every
vpn in :meth:`DynamicMapping.dirty` lost its old translation, and any TLB
structure holding an entry that covers a dirty vpn must invalidate it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

UNMAPPED = -1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A virtual→physical page mapping with derived contiguity metadata."""

    ppn: np.ndarray        # int64[n_pages], -1 where unmapped
    run_start: np.ndarray  # int64[n_pages], start vpn of containing chunk
    run_len: np.ndarray    # int64[n_pages], size of containing chunk
    name: str = "mapping"

    @property
    def n_pages(self) -> int:
        return int(self.ppn.shape[0])

    def contiguity(self, vpn) -> np.ndarray:
        """Per-PTE contiguity field (§3.1): pages contiguously mapped starting
        at ``vpn``, *including* ``vpn`` itself.  0 for unmapped pages."""
        vpn = np.asarray(vpn)
        mapped = self.ppn[vpn] != UNMAPPED
        return np.where(mapped, self.run_start[vpn] + self.run_len[vpn] - vpn, 0)


def compute_runs(ppn: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized contiguity-chunk extraction.

    A chunk boundary occurs at ``i`` when ``ppn[i] != ppn[i-1] + 1`` or when
    either side is unmapped.
    """
    ppn = np.asarray(ppn, dtype=np.int64)
    n = ppn.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    mapped = ppn != UNMAPPED
    cont_with_prev = np.zeros(n, dtype=bool)
    cont_with_prev[1:] = mapped[1:] & mapped[:-1] & (ppn[1:] == ppn[:-1] + 1)
    # run id increments where a new run starts
    new_run = ~cont_with_prev
    run_id = np.cumsum(new_run) - 1
    starts = np.flatnonzero(new_run)
    run_start = starts[run_id]
    counts = np.bincount(run_id)
    run_len = counts[run_id]
    # unmapped pages belong to no chunk
    run_len = np.where(mapped, run_len, 0)
    run_start = np.where(mapped, run_start, np.arange(n))
    return run_start.astype(np.int64), run_len.astype(np.int64)


def make_mapping(ppn: np.ndarray, name: str = "mapping") -> Mapping:
    run_start, run_len = compute_runs(ppn)
    return Mapping(ppn=np.asarray(ppn, np.int64), run_start=run_start,
                   run_len=run_len, name=name)


def contiguity_chunks(m: Mapping) -> List[Tuple[int, int]]:
    """All contiguity chunks as ``(start_vpn, size)`` (Definition 1)."""
    mapped = m.ppn != UNMAPPED
    starts = np.unique(m.run_start[mapped])
    return [(int(s), int(m.run_len[s])) for s in starts]


def contiguity_histogram(m: Mapping) -> Dict[int, int]:
    """The OS-maintained contiguity histogram (paper §3.3): chunk size → count.

    Mirrors the structure consumed by Algorithm 3: a list of (size, freq).
    """
    chunks = contiguity_chunks(m)
    hist: Dict[int, int] = {}
    for _, size in chunks:
        hist[size] = hist.get(size, 0) + 1
    return hist


def huge_page_backed(m: Mapping) -> np.ndarray:
    """bool[n_pages]: vpn lies inside a promotable 2MB huge page.

    THP can promote a 512-page window when (a) the window is fully contiguous
    and (b) the physical base is itself 512-aligned (x86 2MB pages require
    PA alignment).
    """
    n = m.n_pages
    base = np.arange(n, dtype=np.int64) & ~np.int64(511)
    ok = base + 512 <= n
    b = np.minimum(base, n - 1)
    contig_at_base = np.where(m.ppn[b] != UNMAPPED,
                              m.run_start[b] + m.run_len[b] - b, 0)
    aligned_pa = (m.ppn[b] & 511) == 0
    return ok & (contig_at_base >= 512) & aligned_pa


# ---------------------------------------------------------------------------
# Dynamic mappings: OS events that rewrite translations mid-trace
# ---------------------------------------------------------------------------

EVENT_KINDS = ("map", "unmap", "remap", "promote", "split", "compact")


@dataclasses.dataclass(frozen=True)
class MappingEvent:
    """One OS action on a virtual range ``[vpn, vpn + n)``.

    ``kind`` is a semantic label (all kinds except ``unmap`` are writes of a
    new backing):

    * ``map``     — demand-fault new pages in (previously unmapped);
    * ``unmap``   — release pages (``MADV_DONTNEED`` / free);
    * ``remap``   — migrate pages to new frames (NUMA balancing, swap);
    * ``promote`` — THP promotion: re-back a 512-window contiguously;
    * ``split``   — THP split: scatter pages out of a huge run;
    * ``compact`` — kcompactd migration into a dense region.

    ``ppn`` is the new physical backing: an ``int`` base of a contiguous
    frame range, an explicit array of ``n`` frames, or ``None`` for
    ``unmap``.
    """

    kind: str
    vpn: int
    n: int = 1
    ppn: Union[int, np.ndarray, None] = None

    def __post_init__(self):
        assert self.kind in EVENT_KINDS, self.kind
        assert self.n > 0 and self.vpn >= 0
        if self.kind == "unmap":
            assert self.ppn is None
        else:
            assert self.ppn is not None

    def new_ppns(self) -> np.ndarray:
        """The ``n`` frames this event installs (-1s for ``unmap``)."""
        if self.kind == "unmap":
            return np.full(self.n, UNMAPPED, np.int64)
        if isinstance(self.ppn, np.ndarray):
            assert self.ppn.shape[0] == self.n
            return np.asarray(self.ppn, np.int64)
        return np.arange(self.ppn, self.ppn + self.n, dtype=np.int64)


def apply_event(ppn: np.ndarray, ev: MappingEvent) -> np.ndarray:
    """Functionally apply one event to a ``ppn`` array (returns a copy)."""
    out = np.asarray(ppn, np.int64).copy()
    assert ev.vpn + ev.n <= out.shape[0], "event outside the virtual footprint"
    out[ev.vpn: ev.vpn + ev.n] = ev.new_ppns()
    return out


def events_from_diff(prev: np.ndarray, cur: np.ndarray
                     ) -> List[MappingEvent]:
    """Derive the run-grouped event list that turns ``prev`` into ``cur``.

    Used by recorders that snapshot a live system (the KV-churn driver)
    instead of logging semantic events: consecutive differing vpns of the
    same category become one ``map``/``unmap``/``remap`` event.
    """
    prev = np.asarray(prev, np.int64)
    cur = np.asarray(cur, np.int64)
    assert prev.shape == cur.shape
    diff = prev != cur
    cat = np.where(~diff, 0,
                   np.where(prev == UNMAPPED, 1,           # map
                            np.where(cur == UNMAPPED, 2,   # unmap
                                     3)))                  # remap
    out: List[MappingEvent] = []
    n = prev.shape[0]
    boundaries = np.flatnonzero(np.diff(cat) != 0) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    kinds = {1: "map", 2: "unmap", 3: "remap"}
    for s, e in zip(starts, ends):
        c = int(cat[s])
        if c == 0:
            continue
        if c == 2:
            out.append(MappingEvent("unmap", int(s), int(e - s)))
        else:
            out.append(MappingEvent(kinds[c], int(s), int(e - s),
                                    ppn=cur[s:e].copy()))
    return out


@dataclasses.dataclass(frozen=True)
class DynamicMapping:
    """An epoch sequence: ``epochs[e]`` is live for trace steps in
    ``[boundaries[e], boundaries[e+1])``; ``events[e]`` is the event batch
    applied on entering epoch ``e`` (``events[0]`` is empty).

    All epochs share one virtual footprint (``n_pages``).  The *dirty set*
    of epoch ``e`` — vpns whose old translation died — is derived from the
    snapshot diff, so invalidation correctness never depends on the event
    log being complete.
    """

    epochs: Tuple[Mapping, ...]
    boundaries: Tuple[int, ...]
    events: Tuple[Tuple[MappingEvent, ...], ...] = ()
    name: str = "dynamic"

    def __post_init__(self):
        assert len(self.epochs) >= 1
        assert len(self.boundaries) == len(self.epochs)
        assert self.boundaries[0] == 0
        assert all(a < b for a, b in zip(self.boundaries,
                                         self.boundaries[1:])), \
            "epoch boundaries must be strictly ascending"
        if not self.events:
            object.__setattr__(
                self, "events", tuple(() for _ in self.epochs))
        assert len(self.events) == len(self.epochs)
        n = self.epochs[0].n_pages
        assert all(m.n_pages == n for m in self.epochs), \
            "all epochs must share one virtual footprint"

    @property
    def n_pages(self) -> int:
        return self.epochs[0].n_pages

    @property
    def n_epochs(self) -> int:
        return len(self.epochs)

    def epoch_at(self, t: int) -> int:
        """Index of the epoch live at trace step ``t``."""
        return int(np.searchsorted(self.boundaries, t, side="right") - 1)

    def dirty(self, e: int) -> np.ndarray:
        """bool[n_pages]: vpns whose translation died entering epoch ``e``
        (previously mapped, now unmapped or re-backed) — the shootdown set."""
        assert 1 <= e < self.n_epochs
        prev, cur = self.epochs[e - 1].ppn, self.epochs[e].ppn
        return (prev != UNMAPPED) & (prev != cur)

    def dirty_count(self, e: int) -> int:
        return int(self.dirty(e).sum())


def build_dynamic_mapping(initial_ppn: np.ndarray,
                          schedule: Sequence[
                              Tuple[int, Sequence[MappingEvent]]],
                          name: str = "dynamic") -> DynamicMapping:
    """Replay an event schedule into a :class:`DynamicMapping`.

    ``schedule`` is ``[(boundary_t, events), ...]`` with strictly ascending
    ``boundary_t > 0``: at trace step ``boundary_t`` the events are applied
    (in order) and a new epoch begins.
    """
    ppn = np.asarray(initial_ppn, np.int64)
    epochs = [make_mapping(ppn, name=f"{name}@0")]
    boundaries = [0]
    events: List[Tuple[MappingEvent, ...]] = [()]
    for t, evs in schedule:
        cur = epochs[-1].ppn
        for ev in evs:
            cur = apply_event(cur, ev)
        epochs.append(make_mapping(cur, name=f"{name}@{int(t)}"))
        boundaries.append(int(t))
        events.append(tuple(evs))
    return DynamicMapping(tuple(epochs), tuple(boundaries), tuple(events),
                          name=name)


def dynamic_from_snapshots(snaps: Sequence[Mapping],
                           boundaries: Sequence[int],
                           name: str = "dynamic") -> DynamicMapping:
    """Wrap recorded snapshots; events are derived per epoch by diffing."""
    events = [()] + [tuple(events_from_diff(a.ppn, b.ppn))
                     for a, b in zip(snaps, snaps[1:])]
    return DynamicMapping(tuple(snaps), tuple(int(b) for b in boundaries),
                          tuple(events), name=name)


# ---------------------------------------------------------------------------
# Multi-tenant address spaces: many processes time-sharing one TLB
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiTenantMapping:
    """Several address spaces time-sharing one TLB under a context-switch
    schedule (the serving-stack conclusion of the paper's "diverse
    contiguity": every tenant brings its *own* contiguity signature).

    ``tenants[i]`` is tenant ``i``'s full address space (VPNs are
    per-tenant: the same vpn means different translations in different
    tenants).  The schedule is a segment sequence: during trace steps
    ``[boundaries[s], boundaries[s+1])`` tenant ``tenant_ids[s]`` runs under
    ASID ``asids[s]``.  The ASID is the *hardware tag* the OS assigned for
    that scheduling quantum — a finite resource, so departing tenants'
    ASIDs get recycled (``recycled[s]`` is True when segment ``s`` reuses
    an ASID whose previous holder was a *different* tenant; correctness
    then requires the OS to invalidate that ASID's stale entries before
    the segment runs, exactly like a Linux ASID-generation rollover).

    How a context switch treats the TLB is NOT a property of the world but
    of the hardware policy under test —
    :attr:`repro_torch.core.simulator.MethodSpec.ctx_policy`:

    * ``"flush"`` — switching flushes every structure (untagged hardware);
    * ``"tag"``   — entries are ASID-tagged and survive switches; lookups
      only hit entries whose tag matches the live ASID, and only recycled
      ASIDs pay a targeted invalidation.
    """

    tenants: Tuple[Mapping, ...]
    boundaries: Tuple[int, ...]      # strictly ascending, [0] == 0
    tenant_ids: Tuple[int, ...]      # per segment: index into tenants
    asids: Tuple[int, ...]           # per segment: ASID label assigned
    name: str = "multitenant"
    recycled: Tuple[bool, ...] = ()  # derived: segment reuses a dead ASID

    def __post_init__(self):
        assert len(self.tenants) >= 1
        ns = len(self.boundaries)
        assert len(self.tenant_ids) == ns and len(self.asids) == ns
        assert ns >= 1 and self.boundaries[0] == 0
        assert all(a < b for a, b in zip(self.boundaries,
                                         self.boundaries[1:])), \
            "segment boundaries must be strictly ascending"
        assert all(0 <= t < len(self.tenants) for t in self.tenant_ids)
        assert all(a >= 0 for a in self.asids)
        # a resident tenant keeps its ASID until it is descheduled: adjacent
        # same-tenant segments must share one ASID.  Allowing a silent
        # relabel would make every resident entry unhittable through the
        # ASID compare with no flush charged — a free, invisible TLB wipe
        # no hardware policy exhibits.
        assert all(self.asids[s] == self.asids[s - 1]
                   for s in range(1, ns)
                   if self.tenant_ids[s] == self.tenant_ids[s - 1]), \
            "adjacent same-tenant segments must share one ASID"
        if not self.recycled:
            holder: Dict[int, int] = {}
            rec = []
            for s in range(ns):
                a, t = self.asids[s], self.tenant_ids[s]
                rec.append(a in holder and holder[a] != t)
                holder[a] = t
            object.__setattr__(self, "recycled", tuple(rec))
        assert len(self.recycled) == ns

    @property
    def n_pages(self) -> int:
        """Largest tenant footprint (engines pad every record to it)."""
        return max(m.n_pages for m in self.tenants)

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    @property
    def n_segments(self) -> int:
        return len(self.boundaries)

    def segment_at(self, t: int) -> int:
        """Index of the schedule segment live at trace step ``t``."""
        return int(np.searchsorted(self.boundaries, t, side="right") - 1)

    def tenant_at(self, t: int) -> Mapping:
        return self.tenants[self.tenant_ids[self.segment_at(t)]]

    def switches(self, s: int) -> bool:
        """True when entering segment ``s`` changes the running address
        space (a context switch is charged; under ``flush`` the TLB is
        wiped)."""
        return s > 0 and self.tenant_ids[s] != self.tenant_ids[s - 1]

    def n_switches(self) -> int:
        return sum(self.switches(s) for s in range(self.n_segments))

    def merged_contiguity_histogram(self) -> Dict[int, int]:
        """Union histogram over all tenants — what an OS aggregating
        per-process contiguity stats would feed Algorithm 3."""
        hist: Dict[int, int] = {}
        for m in self.tenants:
            for size, freq in contiguity_histogram(m).items():
                hist[size] = hist.get(size, 0) + freq
        return hist


def build_multitenant_mapping(tenants: Sequence[Mapping],
                              schedule: Sequence[Tuple[int, int, int]],
                              name: str = "multitenant"
                              ) -> MultiTenantMapping:
    """Build a :class:`MultiTenantMapping` from ``(t, tenant_id, asid)``
    triples (strictly ascending ``t``, first at 0).  Consecutive segments
    with identical ``(tenant_id, asid)`` are merged — schedulers emit one
    entry per quantum and a tenant may run back-to-back quanta.  Adjacent
    same-tenant segments with *different* ASIDs are rejected by the
    constructor: a resident tenant keeps its ASID until descheduled."""
    assert schedule and schedule[0][0] == 0
    bounds: List[int] = []
    tids: List[int] = []
    asids: List[int] = []
    for t, tid, asid in schedule:
        if bounds and tids[-1] == tid and asids[-1] == asid:
            continue
        bounds.append(int(t))
        tids.append(int(tid))
        asids.append(int(asid))
    return MultiTenantMapping(tuple(tenants), tuple(bounds), tuple(tids),
                              tuple(asids), name=name)


# ---------------------------------------------------------------------------
# Nested (guest → host) translation: two-level worlds under virtualization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NestedSegment:
    """One union-grid segment of a nested world.

    The union grid is the merge of the VM schedule boundaries, every
    guest's epoch boundaries, and the host's epoch boundaries: within one
    segment nothing about the composed translation or the running VM
    changes.  ``mapping`` is the *composed* guest-VPN → host-PPN view of
    the scheduled guest, and ``dirty`` (when not ``None``) is the set of
    guest VPNs — unioned over ALL guests, coherence is ASID-blind — whose
    composed translation died entering this segment.
    """

    lo: int
    guest_id: int
    asid: int
    switch: bool
    recycled: bool
    mapping: Mapping
    dirty: Optional[np.ndarray]


@dataclasses.dataclass(frozen=True)
class NestedMapping:
    """Two-level (guest → host) translation worlds: each tenant is a VM.

    ``guests[i]`` is VM ``i``'s guest page table as a
    :class:`DynamicMapping` over guest VPNs: ``guests[i].epochs[e].ppn[v]``
    is a *guest* PPN.  ``host`` is the hypervisor's table mapping guest
    PPNs to host PPNs, itself a :class:`DynamicMapping` — host-level
    remap/compaction/balloon events rewrite frames the guests never
    touched.  A translation the TLB may cache is the *composition*
    ``host.ppn[guest.ppn[v]]``, so contiguity (what K-bit alignment
    exploits) can fracture at either level, and a host event dirties
    composed translations **by host-side position** — every guest VPN
    whose backing guest PPN the host moved, across every VM.

    The VM schedule mirrors :class:`MultiTenantMapping`: during trace
    steps ``[boundaries[s], boundaries[s+1])`` guest ``guest_ids[s]`` runs
    under ASID ``asids[s]`` (vCPU tags), with ``recycled`` derived the
    same way.  :meth:`plan_segments` flattens all three time axes into one
    union grid consumed by both the oracle
    (:func:`repro_torch.core.simulator.run_method_nested`) and the batched lane
    engine — the composed dirty sets are computed HERE, once, so every
    executor invalidates identically.

    *How* an invalidation is paid is not a property of the world but of
    :attr:`repro_torch.core.simulator.MethodSpec.coh_policy`: IPI-style
    ``"shootdown"`` or directory-tracked ``"hw-coherence"``.
    """

    guests: Tuple[DynamicMapping, ...]
    host: DynamicMapping
    boundaries: Tuple[int, ...]      # strictly ascending, [0] == 0
    guest_ids: Tuple[int, ...]       # per segment: index into guests
    asids: Tuple[int, ...]           # per segment: ASID (vCPU tag)
    name: str = "nested"
    recycled: Tuple[bool, ...] = ()  # derived: segment reuses a dead ASID

    def __post_init__(self):
        assert len(self.guests) >= 1
        ns = len(self.boundaries)
        assert len(self.guest_ids) == ns and len(self.asids) == ns
        assert ns >= 1 and self.boundaries[0] == 0
        assert all(a < b for a, b in zip(self.boundaries,
                                         self.boundaries[1:])), \
            "schedule boundaries must be strictly ascending"
        assert all(0 <= g < len(self.guests) for g in self.guest_ids)
        assert all(a >= 0 for a in self.asids)
        # same invariant as MultiTenantMapping: a resident VM keeps its
        # ASID until descheduled
        assert all(self.asids[s] == self.asids[s - 1]
                   for s in range(1, ns)
                   if self.guest_ids[s] == self.guest_ids[s - 1]), \
            "adjacent same-guest segments must share one ASID"
        if not self.recycled:
            holder: Dict[int, int] = {}
            rec = []
            for s in range(ns):
                a, g = self.asids[s], self.guest_ids[s]
                rec.append(a in holder and holder[a] != g)
                holder[a] = g
            object.__setattr__(self, "recycled", tuple(rec))
        assert len(self.recycled) == ns
        object.__setattr__(self, "_composed_cache", {})
        object.__setattr__(self, "_segments_cache", None)

    @property
    def n_pages(self) -> int:
        """Largest guest footprint (engines pad every record to it)."""
        return max(g.n_pages for g in self.guests)

    @property
    def n_guests(self) -> int:
        return len(self.guests)

    @property
    def n_segments(self) -> int:
        return len(self.boundaries)

    def segment_at(self, t: int) -> int:
        """Index of the schedule segment live at trace step ``t``."""
        return int(np.searchsorted(self.boundaries, t, side="right") - 1)

    def switches(self, s: int) -> bool:
        return s > 0 and self.guest_ids[s] != self.guest_ids[s - 1]

    def n_switches(self) -> int:
        return sum(self.switches(s) for s in range(self.n_segments))

    def composed(self, guest_id: int, g_epoch: int, h_epoch: int) -> Mapping:
        """The composed guest-VPN → host-PPN :class:`Mapping` (memoized).

        A guest VPN is mapped iff the guest maps it AND its guest PPN
        falls inside the host table AND the host maps that frame;
        contiguity runs are recomputed on the composition, so a
        host-level fracture breaks a composed chunk even where the guest
        side stayed perfectly contiguous.
        """
        key = (guest_id, g_epoch, h_epoch)
        hit = self._composed_cache.get(key)
        if hit is None:
            g = self.guests[guest_id].epochs[g_epoch].ppn
            h = self.host.epochs[h_epoch].ppn
            gp = np.clip(g, 0, h.shape[0] - 1)
            ok = (g != UNMAPPED) & (g < h.shape[0])
            hit = make_mapping(
                np.where(ok, h[gp], UNMAPPED),
                name=f"{self.name}:g{guest_id}e{g_epoch}h{h_epoch}")
            self._composed_cache[key] = hit
        return hit

    def composed_at(self, t: int) -> Mapping:
        """The scheduled guest's composed view live at trace step ``t``."""
        gid = self.guest_ids[self.segment_at(t)]
        return self.composed(gid, self.guests[gid].epoch_at(t),
                             self.host.epoch_at(t))

    def _dirty_at(self, lo: int) -> Optional[np.ndarray]:
        """Union composed dirty set entering the union-grid boundary ``lo``
        (``None`` when no composed translation died).  ASID-blind by
        design: a shootdown invalidates a stale range for whichever VM
        cached it, exactly like the single-space dynamic worlds."""
        he0, he1 = self.host.epoch_at(lo - 1), self.host.epoch_at(lo)
        dirty = np.zeros(self.n_pages, bool)
        hit = False
        for gid, g in enumerate(self.guests):
            ge0, ge1 = g.epoch_at(lo - 1), g.epoch_at(lo)
            if ge0 == ge1 and he0 == he1:
                continue
            prev = self.composed(gid, ge0, he0).ppn
            cur = self.composed(gid, ge1, he1).ppn
            d = (prev != UNMAPPED) & (prev != cur)
            if d.any():
                dirty[: d.shape[0]] |= d
                hit = True
        return dirty if hit else None

    def plan_segments(self) -> Tuple[NestedSegment, ...]:
        """Flatten schedule × guest epochs × host epochs into the union
        grid (memoized).  Both the oracle and the lane engine consume
        exactly this plan, so a dirty set or a switch can never differ
        between executors."""
        if self._segments_cache is not None:
            return self._segments_cache
        grid = set(self.boundaries) | set(self.host.boundaries)
        for g in self.guests:
            grid.update(g.boundaries)
        segs = []
        prev_gid = None
        for lo in sorted(grid):
            s = self.segment_at(lo)
            gid = self.guest_ids[s]
            comp = self.composed(gid, self.guests[gid].epoch_at(lo),
                                 self.host.epoch_at(lo))
            segs.append(NestedSegment(
                lo=int(lo), guest_id=gid, asid=self.asids[s],
                switch=prev_gid is not None and gid != prev_gid,
                recycled=self.recycled[s] and lo == self.boundaries[s],
                mapping=comp,
                dirty=self._dirty_at(lo) if lo > 0 else None))
            prev_gid = gid
        out = tuple(segs)
        object.__setattr__(self, "_segments_cache", out)
        return out

    def merged_contiguity_histogram(self) -> Dict[int, int]:
        """Union histogram over the initial composed views — what a
        hypervisor aggregating per-VM contiguity stats feeds Algorithm 3."""
        hist: Dict[int, int] = {}
        for gid in range(self.n_guests):
            for size, freq in contiguity_histogram(
                    self.composed(gid, 0, 0)).items():
                hist[size] = hist.get(size, 0) + freq
        return hist


def _as_dynamic_layer(m) -> DynamicMapping:
    if isinstance(m, DynamicMapping):
        return m
    return DynamicMapping((m,), (0,), name=m.name)


def build_nested_mapping(guests, host,
                         schedule: Sequence[Tuple[int, int, int]],
                         name: str = "nested") -> NestedMapping:
    """Build a :class:`NestedMapping` from ``(t, guest_id, asid)`` triples
    (strictly ascending ``t``, first at 0; consecutive identical segments
    merged like :func:`build_multitenant_mapping`).  ``guests`` entries and
    ``host`` may be plain :class:`Mapping`\\ s — each is wrapped as a
    single-epoch :class:`DynamicMapping` layer."""
    assert schedule and schedule[0][0] == 0
    bounds: List[int] = []
    gids: List[int] = []
    asids: List[int] = []
    for t, gid, asid in schedule:
        if bounds and gids[-1] == gid and asids[-1] == asid:
            continue
        bounds.append(int(t))
        gids.append(int(gid))
        asids.append(int(asid))
    return NestedMapping(tuple(_as_dynamic_layer(g) for g in guests),
                         _as_dynamic_layer(host), tuple(bounds),
                         tuple(gids), tuple(asids), name=name)


@dataclasses.dataclass(frozen=True)
class ParityWorld:
    """A base world plus a schedule of mid-trace TLB parity-flip faults.

    Soft errors poison *live TLB state*, not the page table: at trace step
    ``t`` a parity fault flips a bit in whatever entry currently covers
    ``vpn``.  The mapping itself stays correct, so the world wraps any
    existing base world — static :class:`Mapping`, :class:`DynamicMapping`,
    :class:`MultiTenantMapping` or :class:`NestedMapping` — unchanged, and
    only adds the fault schedule.  What a fault *costs* is the method's
    :attr:`~repro_torch.core.simulator.MethodSpec.par_policy`:

    * ``"parity"`` — detect-invalidate-rewalk.  The flipped entry (and any
      other entry covering the vpn) is invalidated; a coalesced |K|=k
      entry thereby loses up to ``2^k`` translations where Base loses one.
      That multiplied blast radius is the paper-grounded robustness trade
      of coalescing.
    * ``"ecc"`` — idealized in-place correction: no entry is lost and the
      run is bit-identical to the fault-free run by construction.

    ``faults`` is a tuple of ``(step, vpn)`` pairs with strictly ascending
    steps.  Steps must be positive and must not collide with the base
    world's own segment boundaries — a fault step becomes an extra segment
    boundary when lowered, and a collision would silently merge the fault
    with an epoch turnover or context switch.
    """

    base: object                   # Mapping | Dynamic/MultiTenant/Nested
    faults: Tuple[Tuple[int, int], ...]
    name: str = "parity"

    def __post_init__(self):
        assert not isinstance(self.base, ParityWorld), "no nesting"
        faults = tuple((int(t), int(v)) for t, v in self.faults)
        object.__setattr__(self, "faults", faults)
        steps = [t for t, _ in faults]
        assert steps == sorted(set(steps)), \
            f"fault steps must be strictly ascending: {steps}"
        assert all(t > 0 for t in steps), f"fault steps must be > 0: {steps}"
        assert all(v >= 0 for _, v in faults), "fault vpns must be mapped"
        clash = set(steps) & set(self.base_boundaries())
        assert not clash, \
            f"fault steps collide with base segment boundaries: {clash}"

    def base_boundaries(self) -> Tuple[int, ...]:
        """Trace positions where the BASE world already turns a segment."""
        if isinstance(self.base, (DynamicMapping, MultiTenantMapping)):
            return tuple(self.base.boundaries)
        if isinstance(self.base, NestedMapping):
            return tuple(sg.lo for sg in self.base.plan_segments())
        return (0,)


def cluster_bitmap(m: Mapping, cluster_bits: int = 3) -> np.ndarray:
    """Per-vpn bitmap for the Cluster TLB [Pham et al., HPCA'14].

    For each vpn, bit ``j`` of ``bitmap[vpn]`` is set when page ``j`` of the
    8-page virtual window containing ``vpn`` maps into the *same* aligned
    physical cluster as ``vpn`` itself (ppn >> cluster_bits equal).
    """
    n = m.n_pages
    w = 1 << cluster_bits
    pad = (-n) % w
    ppn = np.concatenate([m.ppn, np.full(pad, UNMAPPED, np.int64)])
    win = ppn.reshape(-1, w)                      # [n_win, w]
    pclus = np.where(win != UNMAPPED, win >> cluster_bits, -2)
    # bitmap from the perspective of each page in the window
    same = pclus[:, :, None] == pclus[:, None, :]   # [n_win, w(self), w(other)]
    bits = (same & (pclus[:, None, :] >= 0)) << np.arange(w)[None, None, :]
    bm = bits.sum(axis=2).astype(np.int64).reshape(-1)[:n]
    return np.where(m.ppn != UNMAPPED, bm, 0)
