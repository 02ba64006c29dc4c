"""Dynamic scenarios: live MappingEvent streams instead of frozen snapshots.

The workload and adversarial families record churn and then *flatten* it
into one static mapping — coalesced entries never face the event that
actually stresses them: a remap invalidating a range one aligned entry
covers.  Each scenario here re-emits its source's churn as a
:class:`repro_torch.core.page_table.DynamicMapping`: epoch snapshots + the
event stream between them + the trace positions where each epoch begins.  The
static recordings (``kv-churn``, ``adv-compaction``, ``adv-thp-split``)
stay registered for parity.

* ``dyn-kv-churn``    — the paged KV cache with churn left ON between trace
  segments: the :class:`~repro_torch.serve.scheduler.KVScheduler` event tap
  records admit/preempt/release while the buddy pool reassigns frames, so
  block-table entries cached by the TLB genuinely die mid-trace.
* ``dyn-compaction``  — incremental ``kcompactd`` passes: every epoch
  migrates a fresh fraction of the chunks into the dense region, shooting
  down whatever reach the TLBs built over the previous epoch.
* ``dyn-thp-split``   — progressive THP splitting: each epoch punches new
  holes into surviving huge runs (COW / ``MADV_DONTNEED``), the failure
  mode 2MB-entry schemes are most exposed to.

All builders are deterministic in the request seeds.  ``meta`` reports the
event mix, per-epoch dirty-page counts and epoch boundaries.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Tuple

import numpy as np

from ..core.mappings import demand_mapping
from ..core.page_table import (MappingEvent, apply_event, build_dynamic_mapping,
                               contiguity_chunks, contiguity_histogram,
                               dynamic_from_snapshots, make_mapping,
                               next_pow2 as _next_pow2)
from ..core.traces import generate_trace
from .base import ScenarioData, ScenarioRequest, scenario
from .workload import _ChurnDriver, _episode_seed, _record_decode_sweep

N_EPOCHS = 4
INTER_EPOCH_CHURN = 8      # scheduler steps of live churn between segments


def _dyn_meta(dyn, extra=None):
    meta = {
        "n_epochs": dyn.n_epochs,
        "boundaries": list(dyn.boundaries),
        "events": dict(Counter(ev.kind for evs in dyn.events for ev in evs)),
        "dirty_pages": [dyn.dirty_count(e) for e in range(1, dyn.n_epochs)],
        "contiguity_histogram": contiguity_histogram(dyn.epochs[0]),
    }
    meta.update(extra or {})
    return meta


def _epoch_trace_segments(dyn, req: ScenarioRequest) -> np.ndarray:
    """Per-epoch multiscale traces over the epoch's own mapping, stitched at
    the boundaries (each access touches a page mapped in its epoch)."""
    bounds = dyn.boundaries + (req.trace_len,)
    parts = []
    for e in range(dyn.n_epochs):
        n = bounds[e + 1] - bounds[e]
        parts.append(generate_trace("multiscale", 0, n,
                                    seed=req.trace_seed * 131 + e,
                                    mapping=dyn.epochs[e]))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# KV-cache serving churn, left live between trace segments
# ---------------------------------------------------------------------------


@scenario("dyn-kv-churn", family="dynamic",
          description="paged KV cache with serving churn ON between decode "
                      "segments: KVScheduler event tap + buddy frame "
                      "reassignment produce mid-trace remaps",
          contiguity="mixed buddy runs whose backing dies and reappears "
                     "across epochs")
def _dyn_kv_churn(req: ScenarioRequest) -> ScenarioData:
    pool = int(min(max(req.n_pages, 1 << 10), 1 << 14))
    drv = _ChurnDriver(pool, "buddy_best", _episode_seed(req))
    taps: Counter = Counter()
    drv.sched.event_tap = lambda kind, rid: taps.update([kind])
    drv.churn()
    # fixed per-slot VA stride for the whole episode (sequences never exceed
    # pool//2 prompt + 8 decode pages, see _ChurnDriver._draw_request)
    stride = _next_pow2(drv.pool // 2 + 9)
    seg = max(req.trace_len // N_EPOCHS, 1)

    snaps = []
    bounds: List[int] = []
    rec_all: List[Tuple[int, int]] = []
    for e in range(N_EPOCHS):
        if e:
            drv.churn(INTER_EPOCH_CHURN)
        rec = _record_decode_sweep(drv, seg)[:seg]
        if not rec:
            break
        bounds.append(len(rec_all))
        rec_all.extend(rec)
        # snapshot AFTER the segment: within a segment sequences only grow
        # (allow_churn=False), so every recorded access is mapped here and
        # no recorded translation changed since the segment began
        snaps.append(drv.snapshot_mapping(stride, name=f"dyn-kv-churn@{e}"))
    dyn = dynamic_from_snapshots(snaps, bounds, name="dyn-kv-churn")
    arr = np.asarray(rec_all, dtype=np.int64)
    trace = arr[:, 0] * stride + arr[:, 1]
    meta = _dyn_meta(dyn, {
        "pool_pages": drv.pool,
        "sched_events": dict(taps),
        "preemptions": drv.sched.preemptions,
        "extends": drv.extends,
        "completions": drv.completions,
    })
    return ScenarioData("dyn-kv-churn", dyn.epochs[0], trace, meta=meta,
                        dynamic=dyn)


# ---------------------------------------------------------------------------
# Incremental OS events over a demand mapping
# ---------------------------------------------------------------------------


@scenario("dyn-compaction", family="dynamic",
          description="kcompactd running live: each epoch migrates a fresh "
                      "fraction of the chunks into one dense region, "
                      "invalidating previously coalesced reach",
          contiguity="progressively bimodal: the compacted run grows every "
                     "epoch while the rest stays fragmented")
def _dyn_compaction(req: ScenarioRequest) -> ScenarioData:
    m0 = demand_mapping(req.n_pages, seed=req.map_seed)
    rng = np.random.default_rng(req.map_seed + 1)
    seg = max(req.trace_len // N_EPOCHS, 2)
    ppn = m0.ppn
    dest = int(ppn.max()) + 2
    schedule = []
    for e in range(1, N_EPOCHS):
        chunks = contiguity_chunks(make_mapping(ppn))
        picked = rng.random(len(chunks)) < 0.25
        evs = []
        for (start, size), take in zip(chunks, picked):
            if not take:
                continue
            evs.append(MappingEvent("compact", start, size, ppn=dest))
            dest += size           # contiguous with the previous migrant
        schedule.append((e * seg, evs))
        for ev in evs:
            ppn = apply_event(ppn, ev)
    dyn = build_dynamic_mapping(m0.ppn, schedule, name="dyn-compaction")
    trace = _epoch_trace_segments(dyn, req)
    return ScenarioData("dyn-compaction", dyn.epochs[0], trace,
                        meta=_dyn_meta(dyn), dynamic=dyn)


@scenario("dyn-thp-split", family="dynamic",
          description="progressive THP splitting: every epoch punches new "
                      "holes into surviving huge runs (COW / MADV_DONTNEED "
                      "analogue)",
          contiguity="512-page runs shattered a little further each epoch")
def _dyn_thp_split(req: ScenarioRequest) -> ScenarioData:
    m0 = demand_mapping(req.n_pages, seed=req.map_seed, thp=True)
    rng = np.random.default_rng(req.map_seed + 1)
    seg = max(req.trace_len // N_EPOCHS, 2)
    ppn = m0.ppn
    scatter = int(ppn.max()) + 2
    schedule = []
    for e in range(1, N_EPOCHS):
        evs = []
        for start, size in contiguity_chunks(make_mapping(ppn)):
            if size < 64 or rng.random() >= 0.4:
                continue
            holes = np.unique(rng.integers(1, size,
                                           size=int(rng.integers(1, 4))))
            for h in holes:
                evs.append(MappingEvent("split", start + int(h), 1,
                                        ppn=scatter))
                scatter += 2       # remapped far away: the run breaks
        schedule.append((e * seg, evs))
        for ev in evs:
            ppn = apply_event(ppn, ev)
    dyn = build_dynamic_mapping(m0.ppn, schedule, name="dyn-thp-split")
    trace = _epoch_trace_segments(dyn, req)
    return ScenarioData("dyn-thp-split", dyn.epochs[0], trace,
                        meta=_dyn_meta(dyn), dynamic=dyn)
