"""The per-lane TLB program, batched over lanes on torch tensors.

The port of the JAX package's ``core/lane_program.py``.  A *lane* is one
``(method, mapping, trace)`` cell of a sweep; this module defines what a
lane is, in three layers:

1. **Packing** (:func:`pack_lanes`, :func:`init_batched_state`) — numpy,
   copied from the reference: dedup worlds/traces, precompute the
   per-``(world, epoch)`` map/fill/cluster records, pad every method onto
   one array layout, and bucket shapes exactly as the reference does (so
   the packed batches, and the results, are the same key for key).  For
   the card (``record_plan=True``) the fill and cluster records are not
   built here: each is a row of a :class:`RecordPlan` (its map record, its
   source's size, its profile and K classes), and the card derives the
   records from the uploaded map records
   (``kernels/tlb_sweep/ops.py::build_records``).
2. **The step** (:func:`step_access`, :func:`shoot_lane`,
   :func:`switch_lane`) — rewritten on ``torch.int32`` tensors with a
   leading lane axis: ``torch.where`` and per-lane gathers/scatters in
   place of ``vmap`` and ``.at[].set``.  Every conditional write stays an
   unconditional write of old-or-new.  These functions are the plain
   version of the CUDA kernel (``kernels/tlb_sweep``), which computes the
   same step for one lane per thread block.
3. **The block plan** (:func:`build_block_plan`) — numpy, copied; the
   kernel walks the trace in order and does not need it, but it is kept so
   the packed timeline stays comparable with the reference.

Bit-exactness contract: every counter, coverage sample and translated PPN
equals the JAX package's ``run_sweep`` (``tests/test_torch_sweep.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tracing import span
from .page_table import (DynamicMapping, Mapping, MultiTenantMapping,
                         NestedMapping, ParityWorld, cluster_bitmap,
                         huge_page_backed, next_pow2 as _next_pow2)
from .plane_layout import (FILL_REC_WIDTH, MAP_REC_WIDTH, PLANE_FIELDS,
                           PLANE_WIDTH)
from .simulator import (CLUS_SETS, CLUS_WAYS, CTLB_SETS, CTLB_WAYS, DP_TABLE,
                        HUGE, INVALID, KSUBR, L1_SETS, L1_WAYS,
                        L1H_SETS, L1H_WAYS, LAT_COAL, LAT_CTLB,
                        LAT_CTX_SWITCH, LAT_EXTRA_PROBE, LAT_INVALIDATE,
                        LAT_L2_REG, LAT_SHOOTDOWN, LAT_WALK, N_COV_SAMPLES,
                        NEG, REGULAR, RMM_ENTRIES, SUBR_PAGES, MethodSpec,
                        miss_chain_cycles)

BIG = 2**30  # victim score for padded ways: never evictable

# Shape buckets, kept exactly as the reference has them so both packages
# pack a sweep into the same batches (the reference pads so repeated
# sweeps reuse one compiled executable).  Traces are padded to the next
# power of two with a small floor; lane counts to the next power of two up
# to LANE_SHARE_MAX and to multiples of LANE_BUCKET beyond it, then to a
# device multiple.  K slots are padded to a fixed minimum (inert ``-1``
# classes probe inertly).
TRACE_FLOOR = 256
LANE_FLOOR = 32
LANE_BUCKET = 32
LANE_SHARE_MAX = 64
KMIN_SLOTS = 4
# fill-record counts vary the most across suites (one record per distinct
# (world, epoch, fill profile)); a higher floor folds the common bench
# sizes onto {32, 64}
FILL_REC_FLOOR = 32

# packed-field indices, derived from the one layout table
# (:mod:`repro_torch.core.plane_layout`).  Every structure carries the
# ASID its entry was filled under as its last non-sidecar field: probes require an
# ASID match (trivially true on single-address-space worlds, where
# everything is ASID 0), and the context-switch pass
# (:func:`switch_lane`) clears by it.  L2 AUX holds per-kind sidecar
# data: the subregion contiguity bitmap (bit j = page tag+j shares the
# entry's VA->PA delta); 0 for other kinds.
TAG, KCLS, CONTIG, PPN, LRU, L2_ASID, AUX = range(PLANE_WIDTH["l2"])
assert PLANE_FIELDS["l2"] == ("tag", "kcls", "contig", "ppn", "lru",
                              "asid", "aux")
# dirty record: [P+1] = prefix sum of the epoch's dirty-vpn bitmap
# counters: [9] = l1_hits, reg_hits, coal_hits, walks, probes, pred_correct,
#                 cycles, cov, shootdowns
N_COUNTERS = 9
(C_L1, C_REG, C_COAL, C_WALK, C_PROBE, C_PRED, C_CYC, C_COV,
 C_SHOOT) = range(9)

# The per-lane scalars consumed by step_access/shoot_lane (plus the
# ``kvals`` vector).  The plain executor builds its lane dict from this
# tuple, the kernel op packs its params row from ``PARAM_KEYS`` beside it.
STEP_KEYS = ("kvals", "use_pred", "is_colt", "is_thp", "has_rmm",
             "has_cluster", "set_mask", "n_ways", "k_hat", "miss_chain",
             "sample_every", "is_subr", "has_ctlb", "use_dead", "coh_hw")


TRACE_LINEAR_BUCKET = 1 << 14


def bucket_trace_len(n: int) -> int:
    """Trace-length bucket: power of two with a small floor up to 16k (a
    ~200-step smoke trace pays a 256-step scan, not a 4096-step one), then
    multiples of 16k — pow2 padding would cost up to +100% inert steps on
    the 120–150k-access paper traces, where run time dominates."""
    if n <= TRACE_LINEAR_BUCKET:
        return max(TRACE_FLOOR, _next_pow2(n))
    return -(-n // TRACE_LINEAR_BUCKET) * TRACE_LINEAR_BUCKET


def bucket_lane_count(n: int, device_count: int = 1) -> int:
    """Lane-count bucket, always a multiple of the device count (so the
    pmap path shards every batch).  Bench-sized batches (>= 8 cells) pad to
    {LANE_FLOOR, LANE_SHARE_MAX} power-of-two buckets so the common suite
    sizes share one compiled executable; beyond LANE_SHARE_MAX they are
    chunked by run_sweep, and the remainder chunks land back in these
    buckets.  Tiny batches (a user comparing a handful of specs) stay
    near-exact — inert pad lanes are cheap per step but not free over a
    100k-step trace."""
    if n >= 8:
        L = max(_next_pow2(n), LANE_FLOOR) if n <= LANE_SHARE_MAX \
            else -(-n // LANE_BUCKET) * LANE_BUCKET
    else:
        L = max(_next_pow2(n), 4)
    if device_count > 1:
        L = -(-L // device_count) * device_count
    return L


# Record-count padding budget: stacks are padded to power-of-two record
# counts (with a floor) so sweeps of similar shape share one compiled
# executable — the big cold-time lever for smoke/CI tiers — but never at
# more than this many padded bytes per stack, so paper-scale footprints
# (where run time dominates anyway) degrade gracefully to exact counts.
REC_FLOOR = 8
REC_PAD_BUDGET = 64 << 20


def _pad_count(n: int, rec_bytes: int, floor: int = REC_FLOOR,
               budget: int = REC_PAD_BUDGET) -> int:
    """The count bucket ``n`` records of ``rec_bytes`` each are padded to."""
    b = max(floor, _next_pow2(n))
    while b > n and b * rec_bytes > budget:
        b //= 2
    return max(b, n)


def _pad_stack(recs: List[np.ndarray], floor: int = REC_FLOOR,
               budget: int = REC_PAD_BUDGET) -> np.ndarray:
    """Stack ``recs`` padded with zero records to a shared count bucket."""
    n = len(recs)
    b = _pad_count(n, recs[0].nbytes, floor, budget)
    pad = [np.zeros_like(recs[0])] * (b - n)
    return np.stack(recs + pad)


# ---------------------------------------------------------------------------
# Precomputed per-vpn records (fill policy is trace-independent)
# ---------------------------------------------------------------------------


def _map_record(m: Mapping, P: int) -> np.ndarray:
    """[P, 4] int32: ppn, run_start, run_len, ppn[run_start] (RMM fill)."""
    n = m.n_pages
    rec = np.zeros((P, MAP_REC_WIDTH), np.int32)
    rec[:, 0] = -1
    rec[:n, 0] = m.ppn
    rec[:n, 1] = m.run_start
    rec[:n, 2] = m.run_len
    rec[:n, 3] = m.ppn[np.clip(m.run_start, 0, n - 1)]
    return rec


def _fill_profile_key(spec: MethodSpec):
    if spec.kind in ("kaligned", "anchor"):
        return ("ka", spec.K)
    if spec.kind in ("colt", "thp"):
        return (spec.kind,)
    if spec.kind == "subregion":
        return ("subr",)
    return ("reg",)


def _fill_profile(m: Mapping, key, P: int) -> np.ndarray:
    """[P, 5] int32 fill record (tag, k, contig, ppn, aux): what
    Algorithm 1 / COLT / THP / the subregion policy / the regular policy
    would install on a walk at each vpn."""
    n = m.n_pages
    vpn = np.arange(n, dtype=np.int64)
    ppn = m.ppn
    rs, rl = m.run_start, m.run_len

    def contig_at(v):
        v = np.clip(v, 0, n - 1)
        return np.where(ppn[v] >= 0, rs[v] + rl[v] - v, 0)

    tag = vpn.copy()
    kcls = np.full(n, REGULAR, np.int64)
    contig = np.ones(n, np.int64)
    fppn = ppn.copy()
    aux = np.zeros(n, np.int64)
    if key[0] == "ka":
        chosen = np.zeros(n, bool)
        for k in key[1]:                    # descending; first cover wins
            vk = vpn & ~((1 << k) - 1)
            sc = np.minimum(contig_at(vk), 1 << k)
            take = (sc > (vpn - vk)) & ~chosen
            tag = np.where(take, vk, tag)
            kcls = np.where(take, k, kcls)
            contig = np.where(take, sc, contig)
            fppn = np.where(take, ppn[np.clip(vk, 0, n - 1)], fppn)
            chosen |= take
    elif key[0] == "colt":
        w8 = vpn & ~np.int64(7)
        re = rs + rl
        tag = np.maximum(rs, w8)
        contig = np.maximum(np.minimum(re, w8 + 8) - tag, 1)
        kcls = np.where(contig > 1, 3, REGULAR)
        fppn = ppn[np.clip(tag, 0, n - 1)]
    elif key[0] == "thp":
        huge = huge_page_backed(m)
        hv = vpn >> 9
        tag = np.where(huge, hv, vpn)
        kcls = np.where(huge, HUGE, REGULAR)
        contig = np.where(huge, 512, 1)
        fppn = ppn[np.clip(np.where(huge, hv << 9, vpn), 0, n - 1)]
    elif key[0] == "subr":
        # subregion entries: one entry covers the aligned SUBR_PAGES
        # window around vpn; bit j of the bitmap says page base+j shares
        # this vpn's VA->PA delta (so base_ppn + j translates it).
        base = vpn & ~np.int64(SUBR_PAGES - 1)
        delta = ppn - vpn
        bitmap = np.zeros(n, np.int64)
        for j in range(SUBR_PAGES):
            pj = np.clip(base + j, 0, n - 1)
            ok = (base + j < n) & (ppn[pj] >= 0) & (ppn[pj] - pj == delta)
            bitmap |= ok.astype(np.int64) << j
        mapped = ppn >= 0
        popc = sum((bitmap >> j) & 1 for j in range(SUBR_PAGES))
        tag = np.where(mapped, base, tag)
        kcls = np.where(mapped, KSUBR, kcls)
        contig = np.where(mapped, popc, contig)
        fppn = np.where(mapped, ppn - (vpn - base), fppn)
        aux = np.where(mapped, bitmap, 0)

    rec = np.zeros((P, FILL_REC_WIDTH), np.int32)
    rec[:n, 0] = tag
    rec[:n, 1] = kcls
    rec[:n, 2] = contig
    rec[:n, 3] = fppn
    rec[:n, 4] = aux
    rec[n:, 1] = REGULAR
    return rec


# ---------------------------------------------------------------------------
# The record plan: the fill and cluster records as the card builds them
# ---------------------------------------------------------------------------

# One int32 row per record of the fill and cluster stacks: its map record
# (an index of the ``maps`` stack), its source's ``n_pages``, its profile
# code, then its K classes (``-1`` past the last).  The CUDA kernel
# (``kernels/tlb_sweep/csrc/tlb_records.cuh``) spells the columns and the
# codes as ``#define``s that ``tests/test_torch_records.py`` holds to these.
PLAN_FIELDS = ("map", "n_pages", "code")
PLAN_MAP, PLAN_PAGES, PLAN_CODE = range(len(PLAN_FIELDS))
# profile codes; "zero" is a pad record (all zero, as _pad_stack pads)
REC_CODES = ("zero", "regular", "kaligned", "colt", "thp", "subregion",
             "cluster")
REC_CODE = {name: i for i, name in enumerate(REC_CODES)}
_KEY_CODE = {"reg": REC_CODE["regular"], "ka": REC_CODE["kaligned"],
             "colt": REC_CODE["colt"], "thp": REC_CODE["thp"],
             "subr": REC_CODE["subregion"], "clus": REC_CODE["cluster"]}
_ZERO_ROW = (0, 0, REC_CODE["zero"], ())


@dataclasses.dataclass(frozen=True)
class RecordPlan:
    """What the card needs to build a batch's fill and cluster stacks.

    ``rows[:n_fill]`` are the fill stack's records in its order
    (``[n_fill, P, FILL_REC_WIDTH]``), ``rows[n_fill:]`` the cluster
    stack's (``[n_clus, clus_width]``), pad records included, each a row
    of ``PLAN_FIELDS`` then the K classes.  It is host data, like the
    segment bounds: the wrapper reads the shapes from it and uploads the
    rows itself."""

    rows: np.ndarray          # [n_fill + n_clus, len(PLAN_FIELDS) + kw]
    n_fill: int
    clus_width: int           # vpns a cluster record holds: P, or 1

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes

    @property
    def n_real(self) -> int:
        """Records that are not pads: the ones built from a map record."""
        return int((self.rows[:, PLAN_CODE] != REC_CODE["zero"]).sum())


def _plan_row(map_id: int, m: Mapping, key) -> tuple:
    """The plan row of the record of profile ``key`` over source ``m``
    (``("clus",)`` for a cluster bitmap)."""
    return (map_id, m.n_pages, _KEY_CODE[key[0]],
            tuple(key[1]) if key[0] == "ka" else ())


def _record_plan(fill_rows: List[tuple], clus_rows: List[tuple], P: int,
                 clus_width: int) -> RecordPlan:
    """The rows padded to the counts ``_pad_stack`` pads the stacks to."""
    word = np.dtype(np.int32).itemsize
    n_fill = _pad_count(len(fill_rows), P * FILL_REC_WIDTH * word,
                        floor=FILL_REC_FLOOR)
    n_clus = _pad_count(len(clus_rows), clus_width * word)
    kw = max([KMIN_SLOTS] + [len(r[3]) for r in fill_rows])
    nf = len(PLAN_FIELDS)
    rows = np.zeros((n_fill + n_clus, nf + kw), np.int32)
    rows[:, nf:] = -1                   # pads: map 0, 0 pages, code zero
    for i, (mid, n, code, ks) in [*enumerate(fill_rows),
                                  *enumerate(clus_rows, n_fill)]:
        rows[i, :nf] = (mid, n, code)
        rows[i, nf: nf + len(ks)] = ks
    return RecordPlan(rows=rows, n_fill=n_fill, clus_width=clus_width)


# ---------------------------------------------------------------------------
# Lane packing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _WorldPlan:
    """One world decomposed into its schedule-segment sequence.

    ``sources`` are the distinct Mappings records are built from (epoch
    snapshots of a dynamic world; tenant address spaces of a multi-tenant
    one; deduped composed guest-over-host views of a nested one; the
    single mapping of a static one).  Per schedule segment ``i``:
    ``src_idx[i]`` is the live source, ``asids[i]`` the live ASID,
    ``switch[i]`` whether entering it changes the address space,
    ``recycled[i]`` whether its ASID was last held by a different tenant,
    and ``dirty[i]`` the vpn dirty bitmap the coherence pass must sweep on
    entering it (``None`` when nothing turned stale — dynamic worlds dirty
    by guest vpn, nested worlds by composed diff so host-level remaps
    surface too).  ``parity[i]`` marks segments spliced in by a
    :class:`~repro_torch.core.page_table.ParityWorld` fault: their dirty set is
    a soft error, not a remap, so lanes whose spec runs ``par_policy=
    "ecc"`` (in-place correction) skip the invalidation pass for exactly
    those segments while remap coherence stays untouched.
    """

    sources: Tuple[Mapping, ...]
    bounds: Tuple[int, ...]
    src_idx: Tuple[int, ...]
    asids: Tuple[int, ...]
    switch: Tuple[bool, ...]
    recycled: Tuple[bool, ...]
    dirty: Tuple[Optional[np.ndarray], ...]
    parity: Tuple[bool, ...]


def _world_plan(world) -> _WorldPlan:
    if isinstance(world, ParityWorld):
        p = _world_plan(world.base)
        bounds = list(p.bounds)
        src_idx = list(p.src_idx)
        asids = list(p.asids)
        switch = list(p.switch)
        recycled = list(p.recycled)
        dirty = list(p.dirty)
        parity = [False] * len(bounds)
        for t, vpn in world.faults:
            # the segment live at fault time; collisions with base bounds
            # are excluded by the ParityWorld constructor
            i = int(np.searchsorted(np.asarray(bounds), t,
                                    side="right") - 1)
            d = np.zeros(p.sources[src_idx[i]].n_pages, bool)
            d[vpn] = True
            bounds.insert(i + 1, t)
            src_idx.insert(i + 1, src_idx[i])
            asids.insert(i + 1, asids[i])
            switch.insert(i + 1, False)
            recycled.insert(i + 1, False)
            dirty.insert(i + 1, d)
            parity.insert(i + 1, True)
        return _WorldPlan(p.sources, tuple(bounds), tuple(src_idx),
                          tuple(asids), tuple(switch), tuple(recycled),
                          tuple(dirty), tuple(parity))
    if isinstance(world, DynamicMapping):
        n = world.n_epochs
        dirty = (None,) + tuple(
            world.dirty(e) if world.dirty_count(e) else None
            for e in range(1, n))
        return _WorldPlan(world.epochs, world.boundaries, tuple(range(n)),
                          (0,) * n, (False,) * n, (False,) * n, dirty,
                          (False,) * n)
    if isinstance(world, MultiTenantMapping):
        n = world.n_segments
        return _WorldPlan(world.tenants, world.boundaries, world.tenant_ids,
                          world.asids,
                          tuple(world.switches(s) for s in range(n)),
                          world.recycled, (None,) * n, (False,) * n)
    if isinstance(world, NestedMapping):
        segs = world.plan_segments()
        sources: List[Mapping] = []
        src_of: Dict[int, int] = {}
        src_idx: List[int] = []
        for ns in segs:
            if id(ns.mapping) not in src_of:      # composed views memoized
                src_of[id(ns.mapping)] = len(sources)
                sources.append(ns.mapping)
            src_idx.append(src_of[id(ns.mapping)])
        n = len(segs)
        return _WorldPlan(tuple(sources), tuple(ns.lo for ns in segs),
                          tuple(src_idx), tuple(ns.asid for ns in segs),
                          tuple(ns.switch for ns in segs),
                          tuple(ns.recycled for ns in segs),
                          tuple(ns.dirty for ns in segs), (False,) * n)
    return _WorldPlan((world,), (0,), (0,), (0,), (False,), (False,),
                      (None,), (False,))


def pack_lanes(cells: Sequence["SweepCellLike"], device_count: int = 1,
               record_plan: bool = False):
    """Dedup worlds/traces/fill-profiles; pack per-lane params to arrays.

    Every world is a schedule-segment *sequence* (a static ``Mapping`` is
    one segment; a :class:`~repro_torch.core.page_table.DynamicMapping` one per
    epoch; a :class:`~repro_torch.core.page_table.MultiTenantMapping` one per
    scheduling quantum); map/fill/cluster records are built per ``(world,
    source mapping)`` and lanes carry a per-segment record index, so
    static, dynamic and multi-tenant lanes share one compiled program (a
    tenant scheduled many times reuses ONE record set).  The segment
    grid — the sorted union of every lane's boundaries — is returned as a
    static tuple; a batch with no segmented lane collapses to one segment
    and never runs the shootdown/switch pass.  Returns ``(lanes, stacks,
    (L, max_sets, max_ways), seg_bounds)``.

    With ``record_plan`` the ``fills`` and ``clus`` stacks are left to the
    card: ``stacks["plan"]``, a :class:`RecordPlan`, stands in their place
    and every other array is the same.
    """
    worlds: List = []
    world_index: Dict[int, int] = {}
    traces: List[np.ndarray] = []
    trace_index: Dict[int, int] = {}
    for c in cells:
        if id(c.mapping) not in world_index:
            world_index[id(c.mapping)] = len(worlds)
            worlds.append(c.mapping)
        if id(c.trace) not in trace_index:
            trace_index[id(c.trace)] = len(traces)
            traces.append(c.trace)

    plans: Dict[int, _WorldPlan] = {w: _world_plan(m)
                                    for w, m in enumerate(worlds)}

    P = _next_pow2(max(m.n_pages for p in plans.values()
                       for m in p.sources))
    T = bucket_trace_len(max(t.shape[0] for t in traces))

    # map records: one per (world, source mapping)
    map_recs: List[np.ndarray] = []
    map_rec_id: Dict[Tuple[int, int], int] = {}
    for w, p in plans.items():
        for e, m in enumerate(p.sources):
            map_rec_id[(w, e)] = len(map_recs)
            map_recs.append(_map_record(m, P))

    # fill records: one per (world, source, fill profile)
    fill_recs: List[np.ndarray] = []
    fill_rec_id: Dict[Tuple[int, int, tuple], int] = {}
    with span("sweep.pack.fills"):
        for c in cells:
            w = world_index[id(c.mapping)]
            key = _fill_profile_key(c.spec)
            for e, m in enumerate(plans[w].sources):
                fk = (w, e, key)
                if fk not in fill_rec_id:
                    fill_rec_id[fk] = len(fill_recs)
                    fill_recs.append(
                        _plan_row(map_rec_id[(w, e)], m, key) if record_plan
                        else _fill_profile(m, key, P))

    # cluster bitmaps: one per (world, source).  The stack is always P wide
    # (not 1) so suites with and without cluster lanes share an executable;
    # the budget guard below shrinks it back for paper-scale footprints.
    need_clus = any(c.spec.side == "cluster" for c in cells)
    clus_wide = need_clus or P * 4 * REC_FLOOR <= REC_PAD_BUDGET
    clus_width = P if clus_wide else 1
    clus_recs: List = [_ZERO_ROW if record_plan
                       else np.zeros(clus_width, np.int32)]
    clus_rec_id: Dict[Tuple[int, int], int] = {}
    with span("sweep.pack.clusters"):
        for c in cells:
            if c.spec.side != "cluster":
                continue
            w = world_index[id(c.mapping)]
            for e, m in enumerate(plans[w].sources):
                if (w, e) not in clus_rec_id:
                    clus_rec_id[(w, e)] = len(clus_recs)
                    if record_plan:
                        clus_recs.append(_plan_row(map_rec_id[(w, e)], m,
                                                   ("clus",)))
                        continue
                    rec = np.zeros(P, np.int32)
                    rec[: m.n_pages] = cluster_bitmap(m)
                    clus_recs.append(rec)

    # dirty records (prefix sums): one per (world, segment) whose plan
    # carries a dirty bitmap (dynamic epochs e >= 1 with churn; nested
    # segments whose composed view diverged at either level)
    dirty_recs: List[np.ndarray] = [np.zeros(P + 1, np.int32)]
    dirty_rec_id: Dict[Tuple[int, int], int] = {}
    for w, p in plans.items():
        for e, d in enumerate(p.dirty):
            if d is None:
                continue
            dc = np.zeros(P + 1, np.int32)
            nd = min(int(d.shape[0]), P)   # beyond P no entry can cover
            np.cumsum(d[:nd], out=dc[1: nd + 1])
            dc[nd + 1:] = dc[nd]
            dirty_rec_id[(w, e)] = len(dirty_recs)
            dirty_recs.append(dc)

    n_tr = len(traces)
    if n_tr * T * 4 * 2 <= REC_PAD_BUDGET:
        n_tr = max(REC_FLOOR, _next_pow2(n_tr))
    trace_stack = np.zeros((n_tr, T), np.int32)
    for i, t in enumerate(traces):
        trace_stack[i, : t.shape[0]] = t

    # segment grid: union of all schedule boundaries, static per compile
    grid = sorted({int(b) for w in range(len(worlds))
                   for b in plans[w].bounds[1:]})
    seg_bounds = tuple([0] + grid + [T])
    n_segs = len(seg_bounds) - 1

    L = bucket_lane_count(len(cells), device_count)
    max_sets = max(c.spec.l2_sets for c in cells)
    max_ways = max(c.spec.l2_ways for c in cells)
    maxk = max([len(c.spec.K) for c in cells] + [KMIN_SLOTS])

    lanes = dict(
        is_colt=np.zeros(L, bool), is_thp=np.zeros(L, bool),
        is_subr=np.zeros(L, bool), has_ctlb=np.zeros(L, bool),
        use_dead=np.zeros(L, bool), coh_hw=np.zeros(L, bool),
        has_rmm=np.zeros(L, bool),
        has_cluster=np.zeros(L, bool), use_pred=np.zeros(L, bool),
        kvals=np.full((L, maxk), -1, np.int32),
        set_mask=np.zeros(L, np.int32), n_ways=np.ones(L, np.int32),
        k_hat=np.zeros(L, np.int32), miss_chain=np.zeros(L, np.int32),
        pred0=np.zeros(L, np.int32), asid0=np.zeros(L, np.int32),
        seg_map=np.zeros((L, n_segs), np.int32),
        seg_fill=np.zeros((L, n_segs), np.int32),
        seg_clus=np.zeros((L, n_segs), np.int32),
        seg_shoot=np.zeros((L, n_segs), bool),
        seg_dirty=np.zeros((L, n_segs), np.int32),
        seg_asid=np.zeros((L, n_segs), np.int32),
        seg_switch=np.zeros((L, n_segs), bool),
        seg_fall=np.zeros((L, n_segs), bool),
        seg_fasid=np.zeros((L, n_segs), bool),
        trace_id=np.zeros(L, np.int32), t_real=np.zeros(L, np.int32),
        sample_every=np.ones(L, np.int32),
    )
    for i, c in enumerate(cells):
        s = c.spec
        w = world_index[id(c.mapping)]
        p = plans[w]
        key = _fill_profile_key(s)
        lanes["is_colt"][i] = s.kind == "colt"
        lanes["is_thp"][i] = s.kind == "thp"
        lanes["is_subr"][i] = s.kind == "subregion"
        lanes["has_ctlb"][i] = s.kind == "cache-tlb"
        lanes["use_dead"][i] = s.kind == "dead-protect"
        lanes["coh_hw"][i] = s.coh_policy == "hw-coherence"
        lanes["has_rmm"][i] = s.side == "rmm"
        lanes["has_cluster"][i] = s.side == "cluster"
        lanes["use_pred"][i] = s.use_predictor
        lanes["kvals"][i, : len(s.K)] = s.K
        lanes["set_mask"][i] = s.l2_sets - 1
        lanes["n_ways"][i] = s.l2_ways
        lanes["k_hat"][i] = s.index_shift
        lanes["miss_chain"][i] = miss_chain_cycles(s)
        lanes["pred0"][i] = s.K[0] if s.K else 0
        lanes["asid0"][i] = p.asids[0]
        lanes["trace_id"][i] = trace_index[id(c.trace)]
        lanes["t_real"][i] = c.trace.shape[0]
        lanes["sample_every"][i] = max(c.trace.shape[0] // N_COV_SAMPLES, 1)
        for seg in range(n_segs):
            lo = seg_bounds[seg]
            e = int(np.searchsorted(p.bounds, lo, side="right") - 1)
            src = p.src_idx[e]
            lanes["seg_map"][i, seg] = map_rec_id[(w, src)]
            lanes["seg_fill"][i, seg] = fill_rec_id[(w, src, key)]
            lanes["seg_clus"][i, seg] = clus_rec_id.get((w, src), 0)
            lanes["seg_asid"][i, seg] = p.asids[e]
            # `turned` = this grid segment starts at one of the LANE's own
            # boundaries (the union grid also cuts at other lanes')
            turned = seg > 0 and e >= 1 and lo == p.bounds[e]
            # a parity-fault dirty set is a soft error, not a remap: ecc
            # lanes correct it in place and skip the invalidation pass
            ecc_skip = p.parity[e] and s.par_policy == "ecc"
            if turned and (w, e) in dirty_rec_id and not ecc_skip:
                lanes["seg_shoot"][i, seg] = True
                lanes["seg_dirty"][i, seg] = dirty_rec_id[(w, e)]
            if turned:
                lanes["seg_switch"][i, seg] = p.switch[e]
                lanes["seg_fall"][i, seg] = (p.switch[e]
                                             and s.ctx_policy == "flush")
                lanes["seg_fasid"][i, seg] = (p.recycled[e]
                                              and s.ctx_policy == "tag")
    with span("sweep.pack.stack"):
        if record_plan:
            stacks = dict(maps=_pad_stack(map_recs),
                          dirty=_pad_stack(dirty_recs), trace=trace_stack,
                          plan=_record_plan(fill_recs, clus_recs, P,
                                            clus_width))
        else:
            stacks = dict(maps=_pad_stack(map_recs),
                          fills=_pad_stack(fill_recs, floor=FILL_REC_FLOOR),
                          clus=_pad_stack(clus_recs),
                          dirty=_pad_stack(dirty_recs), trace=trace_stack)
    return lanes, stacks, (L, max_sets, max_ways), seg_bounds


def needs_switch_pass(lanes) -> bool:
    """True when some lane's schedule actually switches, flushes or
    relabels an ASID — knowable statically at pack time.  Backends compile
    the segment-entry switch pass only then, so static and dynamic-only
    batches (whose flags are all False by construction) pay nothing for
    the multi-tenant machinery."""
    return bool(np.asarray(lanes["seg_switch"]).any()
                or np.asarray(lanes["seg_fall"]).any()
                or np.asarray(lanes["seg_fasid"]).any()
                or (np.asarray(lanes["seg_asid"])
                    != np.asarray(lanes["asid0"])[:, None]).any())


def init_batched_state(L: int, max_sets: int, max_ways: int, pred0,
                       asid0=None, *, with_ctlb: bool = False,
                       with_dp: bool = False):
    """``with_ctlb``/``with_dp`` size the cache-backed tier and the
    dead-entry counter table: full geometry when some lane in the batch
    is ``cache-tlb``/``dead-protect``, degenerate ``(1, 1)``-style arrays
    otherwise (the step indexes them shape-generically and its lane flags
    gate every read/write, so absent kinds pay one inert element)."""
    def packed(shape, init_tag):
        a = np.zeros(shape, np.int32)
        a[..., 0] = init_tag
        return a

    l2 = np.zeros((L, max_sets, max_ways, PLANE_WIDTH["l2"]), np.int32)
    l2[..., TAG] = -1
    l2[..., KCLS] = INVALID
    l2[..., PPN] = -1
    cs, cw = (CTLB_SETS, CTLB_WAYS) if with_ctlb else (1, 1)
    return dict(
        t=np.zeros(L, np.int32),
        l1=packed((L, L1_SETS, L1_WAYS, PLANE_WIDTH["l1"]), -1),
        l1h=packed((L, L1H_SETS, L1H_WAYS, PLANE_WIDTH["l1h"]), -1),
        l2=l2,
        rmm=packed((L, RMM_ENTRIES, PLANE_WIDTH["rmm"]), -1),
        clus=packed((L, CLUS_SETS, CLUS_WAYS, PLANE_WIDTH["clus"]), -1),
        ctlb=packed((L, cs, cw, PLANE_WIDTH["ctlb"]), -1),
        dp=np.zeros((L, DP_TABLE if with_dp else 1), np.int32),
        pred=np.asarray(pred0, np.int32).copy(),
        asid=(np.zeros(L, np.int32) if asid0 is None
              else np.asarray(asid0, np.int32).copy()),
        counters=np.zeros((L, N_COUNTERS), np.int32),
        cov_samples=np.zeros((L, N_COV_SAMPLES), np.int32),
    )



# ---------------------------------------------------------------------------
# Batched torch helpers
# ---------------------------------------------------------------------------
#
# The reference writes the step for ONE lane and vmaps it; here every
# function takes a leading lane axis ``L`` and indexes per lane with
# ``arange(L)``.  All state and every intermediate stays ``torch.int32``:
# a ``torch.where`` whose two branches are both Python ints would give
# int64, so one branch is always an int32 tensor (``_i32``).


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=like.device)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none is True —
    ``jnp.argmax`` over a bool mask.  Callers only use the index under a
    gate that implies a True exists (or read an inert value)."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device).expand(mask.shape)
    first = torch.where(mask, idx, n).amin(-1)
    return torch.where(first == n, 0, first)


def _first_min(score: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (``jnp.argmin``)."""
    return _first_true(score == score.amin(-1, keepdim=True))


def _cond_set(arr: torch.Tensor, idx, value, pred: torch.Tensor
              ) -> torch.Tensor:
    """Out-of-place per-lane point/row write of ``value`` where ``pred``:
    an unconditional write of old-or-new, as in the reference.  ``idx``
    starts with the lane index; ``value`` is ``[L]`` or ``[L, width]``."""
    out = arr.clone()
    old = out[idx]
    p = pred.view((-1,) + (1,) * (old.dim() - 1))
    out[idx] = torch.where(p, value, old)
    return out


# ---------------------------------------------------------------------------
# The per-access step: the union of every kind's datapath, selected per lane
# ---------------------------------------------------------------------------


def step_access(lane, st, vpn, mrec, frec, bm, active):
    """One translation of EVERY lane; returns ``(new_state, out_ppn [L])``.

    * ``lane`` — dict of per-lane scalars ``[L]`` (+ ``kvals [L, maxk]``);
    * ``st`` — the batched state dict (``l2 [L, sets, ways, 7]`` etc.,
      ``t``/``pred``/``asid [L]``, ``counters [L, 9]``,
      ``cov_samples [L, 64]``); not modified;
    * ``vpn [L]`` — the accessed virtual page of each lane;
    * ``mrec [L, 4]`` / ``frec [L, 5]`` — the map/fill records at ``vpn``;
    * ``bm [L]`` — the cluster bitmap word at ``vpn``;
    * ``active [L]`` — False for padded steps: no state writes, no counters.
    """
    L = vpn.shape[0]
    ar = torch.arange(L, device=vpn.device)
    kvals = lane["kvals"]
    maxk = kvals.shape[1]
    use_pred = lane["use_pred"]
    is_colt, is_thp = lane["is_colt"], lane["is_thp"]
    is_subr = lane["is_subr"]
    is_generic = ~is_colt & ~is_thp & ~is_subr
    has_rmm, has_cluster = lane["has_rmm"], lane["has_cluster"]
    has_ctlb, use_dead = lane["has_ctlb"], lane["use_dead"]
    set_mask = lane["set_mask"]
    k_hat = lane["k_hat"]
    n_ways_total = st["l2"].shape[2]
    way_idx = torch.arange(n_ways_total, dtype=torch.int32,
                           device=vpn.device)
    way_ok = way_idx[None, :] < lane["n_ways"][:, None]
    zero = _i32(0, vpn)
    neg = _i32(NEG, vpn)

    def probe_order(pred_k):
        """[pred_k, remaining K desc] when predicting, else K as packed
        (padded positions stay -1 and probe inertly)."""
        order = [torch.where(use_pred, pred_k, kvals[:, 0])]
        not_pred = kvals != pred_k[:, None]
        csum = torch.cumsum(not_pred.to(torch.int32), 1, dtype=torch.int32)
        for pos in range(1, maxk):
            sel = not_pred & (csum == pos)
            spec_k = torch.where(sel.any(1), kvals[ar, _first_true(sel)],
                                 _i32(-1, vpn))
            order.append(torch.where(use_pred, spec_k, kvals[:, pos]))
        return order

    t = st["t"]
    ppn_true, rs_v, rl_v, rmm_fill_ppn = mrec.unbind(1)
    fill_tag, fill_k, fill_contig, fill_ppn, fill_aux = frec.unbind(1)
    new = dict(st)

    cur = st["asid"]
    cur_ = cur[:, None]
    vpn_ = vpn[:, None]

    # ---------------- L1 (regular + gated 2MB array) ----------------
    s1 = (vpn & (L1_SETS - 1)).long()
    l1row = st["l1"][ar, s1]                       # [L, ways, 4]
    l1_ways_hit = (l1row[..., 0] == vpn_) & (l1row[..., 3] == cur_)
    l1_hit = l1_ways_hit.any(1)
    l1_way = _first_true(l1_ways_hit)
    hv = vpn >> 9
    s1h = (hv & (L1H_SETS - 1)).long()
    l1hrow = st["l1h"][ar, s1h]
    h_ways_hit = (l1hrow[..., 0] == hv[:, None]) & (l1hrow[..., 3] == cur_)
    l1h_hit = is_thp & h_ways_hit.any(1)
    l1h_way = _first_true(h_ways_hit)
    l1_served = l1_hit | l1h_hit
    l1_out_ppn = torch.where(l1_hit, l1row[ar, l1_way, 1],
                             l1hrow[ar, l1h_way, 1] + (vpn & 511))

    # ---------------- L2 probes (all kinds, selected) ---------------
    s2 = ((vpn >> k_hat) & set_mask).long()
    row = st["l2"][ar, s2]                         # [L, W, 7]
    tags, kcls, contig, pbase = (row[..., TAG], row[..., KCLS],
                                 row[..., CONTIG], row[..., PPN])
    valid = (kcls != INVALID) & (row[..., L2_ASID] == cur_)

    # colt branch
    diff = vpn_ - tags
    cover = valid & (diff >= 0) & (diff < contig)
    colt_hit = cover.any(1)
    colt_way = _first_true(cover)
    colt_contig = contig[ar, colt_way]
    colt_reg = colt_hit & (colt_contig == 1)
    colt_coal = colt_hit & (colt_contig > 1)
    colt_ppn = pbase[ar, colt_way] + (vpn - tags[ar, colt_way])

    # thp branch (dual-set probe on the same packed array)
    s2h = (hv & set_mask).long()
    row_h = st["l2"][ar, s2h]
    huge_ways = (row_h[..., KCLS] == HUGE) & (row_h[..., TAG] == hv[:, None]) \
        & (row_h[..., L2_ASID] == cur_)
    reg_ways = (kcls == REGULAR) & (tags == vpn_) & valid
    reg_any = reg_ways.any(1)
    huge_hit = huge_ways.any(1)
    hw = _first_true(huge_ways)
    rw = _first_true(reg_ways)
    thp_reg = reg_any | huge_hit
    thp_ppn = torch.where(reg_any, pbase[ar, rw],
                          row_h[ar, hw, PPN] + (vpn - (hv << 9)))
    thp_touch_ways = torch.where(reg_any[:, None], reg_ways, huge_ways)
    thp_touch_set = torch.where(reg_any, s2, s2h)

    # subregion branch: one entry covers the aligned SUBR_PAGES window;
    # the AUX bitmap says which offsets share the entry's VA->PA delta
    sub_base = vpn & ~(SUBR_PAGES - 1)
    sub_off = vpn & (SUBR_PAGES - 1)
    sub_cover = valid & (kcls == KSUBR) & (tags == sub_base[:, None]) & \
        (((row[..., AUX] >> sub_off[:, None]) & 1) == 1)
    subr_hit = sub_cover.any(1)
    subr_way = _first_true(sub_cover)
    subr_contig = contig[ar, subr_way]
    subr_reg = subr_hit & (subr_contig == 1)
    subr_coal = subr_hit & (subr_contig > 1)
    subr_ppn = pbase[ar, subr_way] + sub_off

    # generic branch: regular probe + padded aligned-probe chain
    gen_reg = reg_any
    probes_used = torch.zeros_like(vpn)
    hit_k = torch.full_like(vpn, -1)
    gen_coal = torch.zeros_like(active)
    coal_ppn = torch.full_like(vpn, -1)
    coal_way = torch.zeros_like(rw)
    first_probe_k = hit_k
    for pos, k_val in enumerate(probe_order(st["pred"])):
        sh = k_val.clamp_min(0)
        vk = torch.where(k_val >= 0, vpn & ~((1 << sh) - 1), _i32(-10, vpn))
        m_ways = (kcls == k_val[:, None]) & (tags == vk[:, None]) & valid & \
            (contig > (vpn - vk)[:, None])
        live = ~gen_reg & ~gen_coal & (k_val >= 0)
        m_hit = m_ways.any(1) & live
        probes_used = probes_used + live.to(torch.int32)
        mw = _first_true(m_ways)
        coal_ppn = torch.where(m_hit, pbase[ar, mw] + (vpn - vk), coal_ppn)
        coal_way = torch.where(m_hit, mw, coal_way)
        hit_k = torch.where(m_hit, k_val, hit_k)
        if pos == 0:
            first_probe_k = k_val
        gen_coal = gen_coal | m_hit

    # per-lane branch selection
    reg_hit = torch.where(is_colt, colt_reg,
                          torch.where(is_thp, thp_reg,
                                      torch.where(is_subr, subr_reg,
                                                  gen_reg)))
    coal_hit = torch.where(is_generic, gen_coal,
                           (colt_coal & is_colt) | (subr_coal & is_subr))
    l2_hit = reg_hit | coal_hit
    l2_ppn_val = torch.where(
        is_colt, colt_ppn,
        torch.where(is_thp, thp_ppn,
                    torch.where(is_subr, subr_ppn,
                                torch.where(gen_reg, pbase[ar, rw],
                                            coal_ppn))))
    pred_ok = (use_pred & gen_coal & (hit_k == first_probe_k)).to(torch.int32)
    touch_set = torch.where(is_thp, thp_touch_set, s2)
    tw = torch.where(
        is_colt, colt_way,
        torch.where(is_thp, _first_true(thp_touch_ways),
                    torch.where(is_subr, subr_way,
                                torch.where(gen_reg, rw, coal_way))))
    probes_used = torch.where(is_generic, probes_used, zero)

    # ---------------- side structures (gated) -----------------------
    rmm = st["rmm"]
    d_r = vpn_ - rmm[..., 0]
    in_rng = (d_r >= 0) & (d_r < rmm[..., 1]) & (rmm[..., 4] == cur_)
    rmm_hit = has_rmm & in_rng.any(1)
    sw = _first_true(in_rng)
    rmm_ppn_val = rmm[ar, sw, 2] + d_r[ar, sw]

    cwd = vpn >> 3
    sc = (cwd & (CLUS_SETS - 1)).long()
    crow = st["clus"][ar, sc]                      # [L, 5, 4]
    bit = (crow[..., 1] >> (vpn & 7)[:, None]) & 1
    c_ways = (crow[..., 0] == cwd[:, None]) & (bit == 1) & \
        (crow[..., 3] == cur_)
    cl_hit = has_cluster & c_ways.any(1)

    # cache-backed tier (Victima lineage): probed only past an L1+L2 miss
    ctlb_sets = st["ctlb"].shape[1]                # degenerate (1, 1) unused
    sct = (vpn & (ctlb_sets - 1)).long()
    trow = st["ctlb"][ar, sct]
    t_ways = (trow[..., 0] == vpn_) & (trow[..., 3] == cur_)
    ctlb_hit = has_ctlb & ~l1_served & ~l2_hit & t_ways.any(1)
    ctlb_way = _first_true(t_ways)

    side_hit = rmm_hit | cl_hit | ctlb_hit
    side_ppn = torch.where(rmm_hit, rmm_ppn_val,
                           torch.where(ctlb_hit, trow[ar, ctlb_way, 1],
                                       ppn_true))

    hit_any = l1_served | l2_hit | side_hit
    walk = ~hit_any
    wr = walk & active  # gate for every state write below

    # ---------------- latency (per-lane miss chain) -----------------
    cyc = torch.where(
        l1_served, zero,
        torch.where(reg_hit, _i32(LAT_L2_REG, vpn),
                    torch.where(coal_hit,
                                LAT_COAL + LAT_EXTRA_PROBE
                                * (probes_used - 1).clamp_min(0),
                                torch.where(side_hit,
                                            torch.where(
                                                ctlb_hit,
                                                _i32(LAT_CTLB, vpn),
                                                _i32(LAT_COAL, vpn)),
                                            lane["miss_chain"]
                                            + LAT_WALK))))

    # ---------------- L2 fill (precomputed record; LRU victim) ------
    # dead-protect: a walk whose vpn's counter is still 0 (never
    # re-referenced) bypasses the L2 fill; the counter saturates at 3
    dp_n = st["dp"].shape[1]                       # degenerate 1 unused
    dp_idx = (vpn & (dp_n - 1)).long()
    dp_ctr = st["dp"][ar, dp_idx]
    dp_bypass = use_dead & walk & (dp_ctr == 0)
    new["dp"] = _cond_set(st["dp"], (ar, dp_idx), (dp_ctr + 1).clamp_max(3),
                          use_dead & wr)

    served_huge = is_thp & (fill_k == HUGE)
    fill_set = torch.where(served_huge, s2h, s2)
    frow = st["l2"][ar, fill_set]
    valid_row = frow[..., KCLS] != INVALID
    score = torch.where(way_ok, torch.where(valid_row, frow[..., LRU], neg),
                        _i32(BIG, vpn))
    victim = _first_min(score)
    fill_wr = wr & ~dp_bypass
    v_valid = valid_row[ar, victim]
    evicted_contig = torch.where(v_valid, frow[ar, victim, CONTIG], zero)
    fill_vec = torch.stack([fill_tag, fill_k, fill_contig, fill_ppn, t, cur,
                            fill_aux], 1)
    l2n = _cond_set(st["l2"], (ar, fill_set, victim), fill_vec, fill_wr)
    # the LRU touch lands in the already-filled array (may hit the same cell)
    new["l2"] = _cond_set(l2n, (ar, touch_set, tw, LRU), t,
                          l2_hit & ~walk & ~l1_served & active)
    cov_delta = torch.where(fill_wr, fill_contig - evicted_contig, zero)

    # Victima move: a valid L2 victim drops into the cache-backed tier
    mv = fill_wr & has_ctlb & v_valid
    ev_tag = frow[ar, victim, TAG]
    sct_v = (ev_tag & (ctlb_sets - 1)).long()
    vt_row = st["ctlb"][ar, sct_v]
    vrow_t = vt_row[..., 0] >= 0
    victim_t = _first_min(torch.where(vrow_t, vt_row[..., 2], neg))
    ctlb_vec = torch.stack([ev_tag, frow[ar, victim, PPN], t,
                            frow[ar, victim, L2_ASID]], 1)
    ctn = _cond_set(st["ctlb"], (ar, sct_v, victim_t), ctlb_vec, mv)
    new["ctlb"] = _cond_set(ctn, (ar, sct, ctlb_way, 2), t,
                            ctlb_hit & active)
    cov_delta = cov_delta + torch.where(
        mv, 1 - vrow_t[ar, victim_t].to(torch.int32), zero)

    # ---------------- side fills (gated) ----------------------------
    rmm_len = rmm[..., 1]
    victim_r = _first_min(torch.where(rmm_len > 0, rmm[..., 3], neg))
    vr_len = rmm_len[ar, victim_r]
    ev_len = torch.where(vr_len > 0, vr_len, zero)
    rmm_wr = wr & has_rmm
    rmm_vec = torch.stack([rs_v, rl_v, rmm_fill_ppn, t, cur], 1)
    rmmn = _cond_set(rmm, (ar, victim_r), rmm_vec, rmm_wr)
    new["rmm"] = _cond_set(rmmn, (ar, sw, 3), t, rmm_hit & active)
    cov_delta = cov_delta + torch.where(rmm_wr, rl_v - ev_len, zero)

    clusterable = bm != (1 << (vpn & 7))
    fill_c = wr & clusterable & has_cluster
    vrow = crow[..., 1] != 0
    victim_c = _first_min(torch.where(vrow, crow[..., 2], neg))
    cl_vec = torch.stack([cwd, bm, t, cur], 1)
    cln = _cond_set(st["clus"], (ar, sc, victim_c), cl_vec, fill_c)
    hit_cway = _first_true((crow[..., 0] == cwd[:, None])
                           & (crow[..., 3] == cur_))
    new["clus"] = _cond_set(cln, (ar, sc, hit_cway, 2), t, cl_hit & active)

    # ---------------- L1 fills --------------------------------------
    do1h = ~l1_served & served_huge & active
    vrh = l1hrow[..., 0] >= 0
    vich = _first_min(torch.where(vrh, l1hrow[..., 2], neg))
    l1h_vec = torch.stack([hv, fill_ppn, t, cur], 1)
    l1hn = _cond_set(st["l1h"], (ar, s1h, vich), l1h_vec, do1h)
    new["l1h"] = _cond_set(
        l1hn, (ar, s1h, l1h_way, 2), t,
        is_thp & l1_served & h_ways_hit.any(1) & ~l1_hit & active)

    do1 = ~l1_served & ~served_huge & active
    vr1 = l1row[..., 0] >= 0
    vic1 = _first_min(torch.where(vr1, l1row[..., 2], neg))
    l1_vec = torch.stack([vpn, ppn_true, t, cur], 1)
    l1n = _cond_set(st["l1"], (ar, s1, vic1), l1_vec, do1)
    new["l1"] = _cond_set(l1n, (ar, s1, l1_way, 2), t, l1_hit & active)

    # ---------------- predictor update (gated) ----------------------
    upd = use_pred & active
    new["pred"] = torch.where(
        upd & gen_coal, hit_k,
        torch.where(upd & walk & (fill_k >= 0), fill_k, st["pred"]))

    # ---------------- accounting (one packed add) -------------------
    act = active
    i32 = torch.int32
    delta = torch.stack([
        (l1_served & act).to(i32),
        (reg_hit & ~l1_served & act).to(i32),
        ((coal_hit | side_hit) & ~reg_hit & ~l1_served & act).to(i32),
        (walk & act).to(i32),
        torch.where(coal_hit & ~l1_served & act, probes_used, zero),
        # dead-protect rides C_PRED: bypassed fills count as predictions
        torch.where(~l1_served & act, pred_ok, zero)
        + (dp_bypass & act).to(i32),
        torch.where(act, cyc, zero),
        cov_delta,
        torch.zeros_like(vpn),
    ], 1)
    new["counters"] = st["counters"] + delta
    new["t"] = t + act.to(i32)
    se = lane["sample_every"]
    # the sample slot uses the pre-increment t and the post-add counters
    slot = (t // se).clamp_max(N_COV_SAMPLES - 1).long()
    new["cov_samples"] = _cond_set(st["cov_samples"], (ar, slot),
                                   new["counters"][:, C_COV],
                                   (t % se == se - 1) & active)

    out_ppn = torch.where(
        l1_served, l1_out_ppn,
        torch.where(l2_hit, l2_ppn_val,
                    torch.where(side_hit, side_ppn, ppn_true)))
    return new, out_ppn


def _rng_dirty(dc: torch.Tensor, lo: torch.Tensor, ln) -> torch.Tensor:
    """Per lane: does ``[lo, lo+ln)`` (both ends clipped to ``[0, P]``)
    hold a dirty vpn?  ``dc [L, P+1]`` is the dirty-bitmap prefix sum."""
    Pn = dc.shape[1] - 1
    L = lo.shape[0]
    lo_ = lo.clamp(0, Pn).reshape(L, -1).long()
    hi_ = (lo + ln).clamp(0, Pn).reshape(L, -1).long()
    d = torch.gather(dc, 1, hi_) - torch.gather(dc, 1, lo_)
    return (d > 0).reshape(lo.shape)


def _lane_bcast(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.view((-1,) + (1,) * (like.dim() - 1))


def _set_field(arr: torch.Tensor, field: int, value) -> torch.Tensor:
    out = arr.clone()
    out[..., field] = value
    return out


def shoot_lane(lane, st, dc, do):
    """Translation coherence on epoch turnover, every lane (gated per lane
    by ``do [L]``): drop every entry — in every structure — whose covered
    vpn range contains a dirty vpn of the entered epoch (``dc [L, P+1]`` =
    the epoch's dirty-bitmap prefix sums), charge the coherence cost, and
    release the dropped reach.  Both ``coh_policy`` values drop the
    identical entry set; IPI-style ``shootdown`` also pays the
    ``LAT_SHOOTDOWN`` broadcast stall, ``hw-coherence`` (``lane['coh_hw']``)
    only the per-entry ``LAT_INVALIDATE``."""
    is_thp, is_subr = lane["is_thp"], lane["is_subr"]
    new = dict(st)
    i32 = torch.int32

    def dsum(x):
        return x.reshape(x.shape[0], -1).sum(1, dtype=i32)

    l2 = st["l2"]
    tagv, kv, cgv = l2[..., TAG], l2[..., KCLS], l2[..., CONTIG]
    do2 = _lane_bcast(do, kv)
    # k == HUGE is a 2MB entry (tag = vpn >> 9) only on THP lanes;
    # K-bit Aligned lanes use k = 9 as a plain alignment class.
    # Subregion entries cover their whole SUBR_PAGES window (conservative:
    # a dirty page under a cleared bitmap bit still drops the entry).
    huge2 = _lane_bcast(is_thp, kv) & (kv == HUGE)
    subr2 = _lane_bcast(is_subr, kv) & (kv == KSUBR)
    span = torch.where(
        huge2, _i32(512, kv),
        torch.where(subr2, _i32(SUBR_PAGES, kv),
                    torch.where(kv == REGULAR, _i32(1, kv),
                                cgv.clamp_min(1))))
    stale2 = (kv != INVALID) & do2 & _rng_dirty(
        dc, torch.where(huge2, tagv << 9, tagv).clamp_min(0), span)
    new["l2"] = _set_field(l2, KCLS, torch.where(stale2, _i32(INVALID, kv),
                                                 kv))
    n_inv = dsum(stale2)
    cov_loss = dsum(torch.where(stale2, cgv, 0))

    l1 = st["l1"]
    t1 = l1[..., 0]
    stale1 = (t1 >= 0) & _lane_bcast(do, t1) & _rng_dirty(
        dc, t1.clamp_min(0), 1)
    new["l1"] = _set_field(l1, 0, torch.where(stale1, -1, t1))
    n_inv = n_inv + dsum(stale1)

    l1h = st["l1h"]
    th = l1h[..., 0]
    staleh = (th >= 0) & _lane_bcast(do, th) & _rng_dirty(
        dc, th.clamp_min(0) << 9, 512)
    new["l1h"] = _set_field(l1h, 0, torch.where(staleh, -1, th))
    n_inv = n_inv + dsum(staleh)

    rmm = st["rmm"]
    rs0, rl0 = rmm[..., 0], rmm[..., 1]
    staler = (rl0 > 0) & _lane_bcast(do, rl0) & _rng_dirty(
        dc, rs0.clamp_min(0), rl0)
    rmm2 = rmm.clone()
    rmm2[..., 0] = torch.where(staler, -1, rs0)
    rmm2[..., 1] = torch.where(staler, 0, rl0)
    rmm2[..., 2] = torch.where(staler, -1, rmm[..., 2])
    new["rmm"] = rmm2
    n_inv = n_inv + dsum(staler)
    cov_loss = cov_loss + dsum(torch.where(staler, rl0, 0))

    cl = st["clus"]
    ct, cb = cl[..., 0], cl[..., 1]
    stalec = (cb != 0) & _lane_bcast(do, cb) & _rng_dirty(
        dc, ct.clamp_min(0) << 3, 8)
    new["clus"] = _set_field(cl, 1, torch.where(stalec, 0, cb))
    n_inv = n_inv + dsum(stalec)

    # cache-backed tier holds 4KB translations: tag-range-1 stale pass
    # (the dead-entry counter table holds predictions, nothing to drop)
    ctb = st["ctlb"]
    tt = ctb[..., 0]
    stalet = (tt >= 0) & _lane_bcast(do, tt) & _rng_dirty(
        dc, tt.clamp_min(0), 1)
    new["ctlb"] = _set_field(ctb, 0, torch.where(stalet, -1, tt))
    n_inv = n_inv + dsum(stalet)
    cov_loss = cov_loss + dsum(stalet)

    add = torch.zeros_like(st["counters"])
    add[:, C_SHOOT] = n_inv
    add[:, C_CYC] = (torch.where(do & ~lane["coh_hw"],
                                 _i32(LAT_SHOOTDOWN, n_inv), 0)
                     + n_inv * LAT_INVALIDATE)
    add[:, C_COV] = -cov_loss
    new["counters"] = st["counters"] + add
    return new


def switch_lane(st, new_asid, do_switch, flush_all, flush_asid):
    """Context switch at segment entry, every lane (multi-tenant worlds).

    Sets the live ASID from per-``(lane, segment)`` data (``new_asid [L]``
    equals the current ASID when a lane has no boundary here, so the
    unconditional write is a no-op), charges ``LAT_CTX_SWITCH`` where the
    address space changed (``do_switch``), and bulk-clears entries — every
    structure under ``flush_all``, or only entries tagged ``new_asid``
    under ``flush_asid`` (a recycled ASID).  Dropped entries are counted in
    the shootdown counter; flushes cost no per-entry cycles."""
    new = dict(st)
    i32 = torch.int32

    def kill(valid, asid_col):
        fa = _lane_bcast(flush_all, valid)
        fs = _lane_bcast(flush_asid, valid)
        return valid & (fa | (fs & (asid_col == _lane_bcast(new_asid,
                                                             asid_col))))

    def dsum(x):
        return x.reshape(x.shape[0], -1).sum(1, dtype=i32)

    l2 = st["l2"]
    kv = l2[..., KCLS]
    k2 = kill(kv != INVALID, l2[..., L2_ASID])
    new["l2"] = _set_field(l2, KCLS, torch.where(k2, _i32(INVALID, kv), kv))
    n_inv = dsum(k2)
    cov_loss = dsum(torch.where(k2, l2[..., CONTIG], 0))

    l1 = st["l1"]
    t1 = l1[..., 0]
    k1 = kill(t1 >= 0, l1[..., 3])
    new["l1"] = _set_field(l1, 0, torch.where(k1, -1, t1))
    n_inv = n_inv + dsum(k1)

    l1h = st["l1h"]
    th = l1h[..., 0]
    kh = kill(th >= 0, l1h[..., 3])
    new["l1h"] = _set_field(l1h, 0, torch.where(kh, -1, th))
    n_inv = n_inv + dsum(kh)

    rmm = st["rmm"]
    rl0 = rmm[..., 1]
    kr = kill(rl0 > 0, rmm[..., 4])
    rmm2 = rmm.clone()
    rmm2[..., 0] = torch.where(kr, -1, rmm[..., 0])
    rmm2[..., 1] = torch.where(kr, 0, rl0)
    rmm2[..., 2] = torch.where(kr, -1, rmm[..., 2])
    new["rmm"] = rmm2
    n_inv = n_inv + dsum(kr)
    cov_loss = cov_loss + dsum(torch.where(kr, rl0, 0))

    cl = st["clus"]
    cb = cl[..., 1]
    kc = kill(cb != 0, cl[..., 3])
    new["clus"] = _set_field(cl, 1, torch.where(kc, 0, cb))
    n_inv = n_inv + dsum(kc)

    # cache-backed tier is ASID-tagged like everything else; the
    # dead-entry counter table is a predictor and survives switches
    ctb = st["ctlb"]
    tt = ctb[..., 0]
    kt = kill(tt >= 0, ctb[..., 3])
    new["ctlb"] = _set_field(ctb, 0, torch.where(kt, -1, tt))
    n_inv = n_inv + dsum(kt)
    cov_loss = cov_loss + dsum(kt)

    new["asid"] = new_asid.to(i32)
    add = torch.zeros_like(st["counters"])
    add[:, C_SHOOT] = n_inv
    add[:, C_CYC] = torch.where(do_switch, _i32(LAT_CTX_SWITCH, n_inv), 0)
    add[:, C_COV] = -cov_loss
    new["counters"] = st["counters"] + add
    return new


# ---------------------------------------------------------------------------
# The block plan: the static time-blocked timeline both backends execute
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static execution timeline for one packed batch.

    Every epoch segment ``[seg_bounds[s], seg_bounds[s+1])`` is padded to a
    whole number of ``tb``-step blocks, so a block never straddles a
    segment boundary and the per-segment record ids stay constant within a
    block.  Padded slots (``tpos >= blk_hi``) are fully inert.  The first
    block of every segment ``s > 0`` carries the shootdown flag; whether a
    given lane actually shoots there stays per-lane data
    (``lanes['seg_shoot']``).
    """

    tb: int                   # block size (trace steps per block)
    n_blocks: int             # total blocks across all segments
    blk_seg: np.ndarray       # [NB]    segment id of each block
    blk_shoot: np.ndarray     # [NB]    block enters a segment with s > 0
    blk_hi: np.ndarray        # [NB]    end bound of the block's segment
    tpos: np.ndarray          # [NB*TB] original t per padded slot
    slot_of_t: np.ndarray     # [T]     padded slot per original t


def build_block_plan(seg_bounds: Tuple[int, ...], tb: int) -> BlockPlan:
    T = seg_bounds[-1]
    blk_seg, blk_shoot, blk_hi, tpos = [], [], [], []
    slot_of_t = np.zeros(T, np.int32)
    for s, (lo, hi) in enumerate(zip(seg_bounds, seg_bounds[1:])):
        nb = -(-(hi - lo) // tb)
        for b in range(nb):
            blk_seg.append(s)
            blk_shoot.append(b == 0 and s > 0)
            blk_hi.append(hi)
            for j in range(tb):
                t = lo + b * tb + j
                if t < hi:
                    slot_of_t[t] = len(tpos)
                tpos.append(t)
    return BlockPlan(
        tb=tb, n_blocks=len(blk_seg),
        blk_seg=np.asarray(blk_seg, np.int32),
        blk_shoot=np.asarray(blk_shoot, bool),
        blk_hi=np.asarray(blk_hi, np.int32),
        tpos=np.asarray(tpos, np.int32),
        slot_of_t=slot_of_t)


class SweepCellLike:  # pragma: no cover - typing aid only
    """Anything with ``.spec``, ``.mapping``, ``.trace`` (see SweepCell)."""

    spec: MethodSpec
    mapping: object
    trace: np.ndarray
