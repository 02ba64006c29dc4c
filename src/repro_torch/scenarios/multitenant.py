"""Multi-tenant scenarios: many address spaces time-sharing one TLB.

The ROADMAP north star is a serving system under heavy traffic from many
users — which at the translation layer means many tenants context-switching
on one TLB, each bringing its *own* contiguity signature (the paper's
"mixed contiguity" taken to its serving-stack conclusion).  Each scenario
here produces a :class:`repro_torch.core.page_table.MultiTenantMapping`: per-
tenant address spaces drawn from the Table-3 synthetic families, plus a
context-switch schedule **derived from the serving stack's own scheduling
core** — a :class:`repro_torch.serve.scheduler.KVScheduler` runs decode
rounds over the tenants (admission, batch slots, preemption under pool pressure),
and every decode quantum of a running tenant becomes one schedule segment.
ASIDs are the scheduler's batch slots, so ASID *recycling* (a departed
tenant's slot re-assigned to a newcomer) falls out of slot reuse exactly
the way it does in the real engine.

* ``mt-serve-mix``    — four resident tenants drawn from the
  small/medium/large/mixed contiguity families, round-robin decode
  quanta: different tenants exhibit *different* contiguity types
  simultaneously.
* ``mt-churn``        — a stream of tenants arriving and departing under
  pool pressure (admission control + preemption), so batch slots — and
  with them ASIDs — are recycled to new tenants mid-trace.
* ``mt-flush-vs-tag`` — few small-footprint tenants under a deliberately
  switch-heavy schedule: the world where the ``ctx_policy`` knob
  (flush-on-switch vs ASID tags) separates most; sweep it under both.

All builders are deterministic in the request seeds.  ``meta`` reports the
schedule (segments, switches, recycles), the scheduler's event taps, and
the merged contiguity histogram Algorithm 3 should see.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from ..core.page_table import Mapping, build_multitenant_mapping
from ..kvcache.allocator import PagedKVAllocator
from ..serve.scheduler import KVScheduler
from .base import ScenarioData, ScenarioRequest, scenario
from .synthetic import SYNTH_KINDS
from .workload import _episode_seed

#: decode rounds a tenant runs before completing (mt-churn keeps this small
#: so slots actually recycle within a smoke-length trace)
RESIDENT_ROUNDS = 1_000_000


def _tenant_worlds(kinds: List[str], req: ScenarioRequest,
                   tenant_pages: int) -> Tuple[List[Mapping],
                                               List[np.ndarray]]:
    """One synthetic (mapping, trace stream) per tenant, seeded per tenant
    so equal-kind tenants still get independent address spaces."""
    from .base import get_scenario
    maps: List[Mapping] = []
    streams: List[np.ndarray] = []
    for i, kind in enumerate(kinds):
        d = get_scenario(f"synth-{kind}").materialize(
            n_pages=tenant_pages, trace_len=req.trace_len,
            map_seed=req.map_seed * 17 + i + 1,
            trace_seed=req.trace_seed * 31 + i + 1)
        maps.append(d.mapping)
        streams.append(np.asarray(d.trace))
    return maps, streams


class _DecodeRoundScheduler:
    """Runs KVScheduler decode rounds over tenants; emits the segment list.

    Tenants are scheduler requests: admitted FCFS under KV-capacity
    control, preempted youngest-first under pool pressure, released after
    their round budget — the same policy code
    :class:`repro_torch.serve.engine.ServingEngine` runs.  Each round, every
    running tenant decodes one quantum; the quantum is one schedule
    segment under the tenant's batch slot as ASID.
    """

    def __init__(self, pool_pages: int, max_batch: int):
        self.alloc = PagedKVAllocator(pool_pages, alloc_policy="buddy_best")
        self.sched = KVScheduler(self.alloc, max_batch)
        self.taps: Counter = Counter()
        self.sched.event_tap = lambda kind, rid: self.taps.update([kind])
        self.need: Dict[int, int] = {}
        self.rounds_left: Dict[int, int] = {}

    def enqueue(self, rid: int, need_pages: int, rounds: int) -> None:
        self.need[rid] = max(int(need_pages), 1)
        self.rounds_left[rid] = max(int(rounds), 1)
        self.sched.enqueue(rid)

    def run(self, quantum: int, total: int,
            arrivals=None) -> List[Tuple[int, int, int]]:
        """Emit ``(t, tenant_id, asid)`` segments until ``total`` steps.

        ``arrivals(round_idx)`` may enqueue more tenants (mt-churn)."""
        schedule: List[Tuple[int, int, int]] = []
        t = 0
        rnd = 0
        while t < total:
            if arrivals is not None:
                arrivals(rnd)
            self.sched.admit(lambda rid: self.need[rid])
            running = list(self.sched.running)
            if not running:
                break
            for rid in running:
                if t >= total:
                    break
                schedule.append((t, rid, self.sched.slot_of(rid)))
                t += quantum
                self.rounds_left[rid] -= 1
                if self.rounds_left[rid] <= 0:
                    self.sched.release(rid)
            rnd += 1
        return schedule


def _assemble(name: str, maps: List[Mapping], streams: List[np.ndarray],
              schedule: List[Tuple[int, int, int]], req: ScenarioRequest,
              drv: _DecodeRoundScheduler, kinds: List[str]) -> ScenarioData:
    """Stitch per-tenant trace streams along the schedule; build the world."""
    mt = build_multitenant_mapping(maps, schedule, name=name)
    bounds = list(mt.boundaries) + [req.trace_len]
    cursor = [0] * len(maps)
    parts: List[np.ndarray] = []
    for s in range(mt.n_segments):
        tid = mt.tenant_ids[s]
        n = bounds[s + 1] - bounds[s]
        stream = streams[tid]
        idx = (np.arange(cursor[tid], cursor[tid] + n)) % stream.shape[0]
        parts.append(stream[idx])
        cursor[tid] += n
    trace = np.concatenate(parts)[: req.trace_len]
    meta = {
        "tenant_kinds": list(kinds),
        "n_tenants": mt.n_tenants,
        "n_segments": mt.n_segments,
        "switches": mt.n_switches(),
        "recycles": int(sum(mt.recycled)),
        "asids": sorted(set(mt.asids)),
        "sched_events": dict(drv.taps),
        "preemptions": drv.sched.preemptions,
        "contiguity_histogram": mt.merged_contiguity_histogram(),
    }
    return ScenarioData(name, mt.tenants[0], trace, meta=meta,
                        multitenant=mt)


def _tenant_pages(req: ScenarioRequest, n_tenants: int) -> int:
    return int(max(req.n_pages // n_tenants, 256))


@scenario("mt-serve-mix", family="multitenant",
          description="four resident tenants (small/medium/large/mixed "
                      "contiguity families) round-robin decoding under the "
                      "KVScheduler; ASIDs are batch slots",
          contiguity="four different per-tenant signatures interleaved "
                     "through one TLB")
def _mt_serve_mix(req: ScenarioRequest) -> ScenarioData:
    kinds = list(SYNTH_KINDS)
    maps, streams = _tenant_worlds(kinds, req, _tenant_pages(req, 4))
    quantum = max(req.trace_len // 40, 8)
    # pool sized so all four tenants stay resident: switching pressure
    # comes from the round-robin quanta, not from churn
    drv = _DecodeRoundScheduler(pool_pages=1 << 10, max_batch=4)
    for i in range(4):
        drv.enqueue(i, need_pages=64, rounds=RESIDENT_ROUNDS)
    schedule = drv.run(quantum, req.trace_len)
    return _assemble("mt-serve-mix", maps, streams, schedule, req, drv,
                     kinds)


@scenario("mt-churn", family="multitenant",
          description="tenants arrive and depart under pool pressure "
                      "(KVScheduler admission + preemption); departed "
                      "tenants' batch slots — their ASIDs — are recycled "
                      "to newcomers",
          contiguity="rotating cast of per-tenant signatures; ASID "
                     "recycling forces targeted invalidation under tags")
def _mt_churn(req: ScenarioRequest) -> ScenarioData:
    n_tenants = 8
    kinds = [SYNTH_KINDS[i % len(SYNTH_KINDS)] for i in range(n_tenants)]
    maps, streams = _tenant_worlds(kinds, req, _tenant_pages(req, 4))
    quantum = max(req.trace_len // 56, 8)
    rng = np.random.default_rng(_episode_seed(req))
    # pool fits ~2 of 3 batch slots: admission control blocks some heads
    # and preempts the youngest running tenant for others, so slots (=
    # ASIDs) recycle and tenants bounce between slots
    drv = _DecodeRoundScheduler(pool_pages=512, max_batch=3)
    next_rid = [0]

    def arrivals(rnd: int) -> None:
        while next_rid[0] < n_tenants and len(drv.sched.waiting) < 2:
            rid = next_rid[0]
            next_rid[0] += 1
            drv.enqueue(rid, need_pages=int(rng.integers(160, 256)),
                        rounds=int(rng.integers(3, 7)))

    schedule = drv.run(quantum, req.trace_len, arrivals=arrivals)
    return _assemble("mt-churn", maps, streams, schedule, req, drv, kinds)


@scenario("mt-flush-vs-tag", family="multitenant",
          description="three small-footprint tenants under a deliberately "
                      "switch-heavy round-robin schedule — the world where "
                      "the flush-vs-tag ctx_policy knob separates most; "
                      "sweep it under both policies",
          contiguity="small per-tenant working sets that fit in the TLB: "
                     "tags retain them across switches, flushes refault")
def _mt_flush_vs_tag(req: ScenarioRequest) -> ScenarioData:
    kinds = ["small", "medium", "small"]
    maps, streams = _tenant_worlds(kinds, req,
                                   _tenant_pages(req, 16))
    quantum = max(req.trace_len // 96, 4)
    drv = _DecodeRoundScheduler(pool_pages=1 << 9, max_batch=3)
    for i in range(3):
        drv.enqueue(i, need_pages=32, rounds=RESIDENT_ROUNDS)
    schedule = drv.run(quantum, req.trace_len)
    return _assemble("mt-flush-vs-tag", maps, streams, schedule, req, drv,
                     kinds)
