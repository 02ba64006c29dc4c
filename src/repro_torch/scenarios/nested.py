"""Nested scenarios: guest→host two-level translation worlds (VMs).

Under virtualization the paper's mixed contiguity gets strictly harder: a
translation is guest-VPN → guest-PPN → host-PPN, and the contiguity K-bit
alignment exploits can fracture at *either* level.  Each scenario here
produces a :class:`repro_torch.core.page_table.NestedMapping`: per-VM guest
page tables drawn from the Table-3 synthetic families, composed over one host
layer the hypervisor rewrites mid-trace, plus a VM schedule derived from
the serving stack's own :class:`~repro_torch.serve.scheduler.KVScheduler` —
tenants-as-VMs, vCPU ASIDs as batch slots, exactly the multi-tenant
machinery one level up.

* ``nested-vm-mix``          — three resident VMs with different guest
  contiguity signatures round-robin decoding over one host layer; a
  single host migration event mid-trace dirties composed translations of
  VMs that never ran an OS event of their own.
* ``nested-host-compaction`` — the hypervisor's defragmenter runs live:
  every host epoch migrates scattered guest-frame ranges into one dense
  region.  Guests see nothing; every composed entry over a moved frame
  dies.  The world where the ``coh_policy`` knob separates most — sweep
  it under both ``shootdown`` and ``hw-coherence``.
* ``nested-balloon``         — a balloon driver inflates in one VM (its
  frames scatter page-by-page to reclaim contiguous host memory), then
  deflates and the host re-compacts them — composed contiguity shatters
  and returns while the *guest* table never changes.

All builders are deterministic in the request seeds.  ``meta`` reports the
VM schedule, host event mix, per-boundary composed dirty counts, and the
merged composed contiguity histogram Algorithm 3 should see.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

from ..core.page_table import (MappingEvent, Mapping, NestedMapping,
                               build_dynamic_mapping, build_nested_mapping)
from .base import ScenarioData, ScenarioRequest, scenario
from .multitenant import (RESIDENT_ROUNDS, _DecodeRoundScheduler,
                          _tenant_worlds)


def _guest_pages(req: ScenarioRequest, n_guests: int) -> int:
    return int(max(req.n_pages // (2 * n_guests), 256))


def _host_identity(maps: Sequence[Mapping]) -> np.ndarray:
    """Identity host table covering every guest PPN (a fresh VM's frames
    are host-contiguous until the hypervisor starts moving them)."""
    hmax = max(int(np.max(np.asarray(m.ppn))) for m in maps) + 8
    return np.arange(hmax, dtype=np.int64)


def _assemble_nested(name: str, world: NestedMapping,
                     streams: List[np.ndarray], req: ScenarioRequest,
                     drv: _DecodeRoundScheduler, kinds: List[str],
                     host_events) -> ScenarioData:
    """Stitch per-VM trace streams along the VM schedule; build meta.

    Host events only *move frames* (no unmap), so a guest's mapped-VPN set
    is invariant across host epochs and each VM's synthetic stream stays
    valid in every composed view.
    """
    bounds = list(world.boundaries) + [req.trace_len]
    cursor = [0] * world.n_guests
    parts: List[np.ndarray] = []
    for s in range(world.n_segments):
        gid = world.guest_ids[s]
        n = bounds[s + 1] - bounds[s]
        stream = streams[gid]
        idx = np.arange(cursor[gid], cursor[gid] + n) % stream.shape[0]
        parts.append(stream[idx])
        cursor[gid] += n
    trace = np.concatenate(parts)[: req.trace_len]
    segs = world.plan_segments()
    meta = {
        "guest_kinds": list(kinds),
        "n_guests": world.n_guests,
        "n_schedule_segments": world.n_segments,
        "n_union_segments": len(segs),
        "switches": world.n_switches(),
        "recycles": int(sum(world.recycled)),
        "asids": sorted(set(world.asids)),
        "host_epochs": world.host.n_epochs,
        "host_events": dict(Counter(ev.kind for evs in host_events
                                    for ev in evs)),
        "dirty_pages": [int(s.dirty.sum()) for s in segs
                        if s.dirty is not None],
        "sched_events": dict(drv.taps),
        "contiguity_histogram": world.merged_contiguity_histogram(),
    }
    return ScenarioData(name, world.composed(world.guest_ids[0], 0, 0),
                        trace, meta=meta, nested=world)


def _host_layer(maps: Sequence[Mapping],
                schedule: List[Tuple[int, List[MappingEvent]]]):
    h0 = _host_identity(maps)
    return build_dynamic_mapping(h0, schedule, name="host"), h0


@scenario("nested-vm-mix", family="nested",
          description="three resident VMs (small/medium/large guest "
                      "contiguity) round-robin decoding under the "
                      "KVScheduler over one host layer; a mid-trace host "
                      "migration dirties composed entries of VMs that ran "
                      "no OS event of their own",
          contiguity="three per-VM signatures composed over one host "
                     "layer; one host event fractures them mid-trace")
def _nested_vm_mix(req: ScenarioRequest) -> ScenarioData:
    kinds = ["small", "medium", "large"]
    maps, streams = _tenant_worlds(kinds, req, _guest_pages(req, 3))
    quantum = max(req.trace_len // 36, 8)
    drv = _DecodeRoundScheduler(pool_pages=1 << 10, max_batch=3)
    for i in range(3):
        drv.enqueue(i, need_pages=64, rounds=RESIDENT_ROUNDS)
    schedule = drv.run(quantum, req.trace_len)
    # one NUMA-balancing-style host migration: a frame range VM 0 happens
    # to own moves; the guests' own tables never change
    rng = np.random.default_rng(req.map_seed + 7)
    hmax = _host_identity(maps).size
    live = np.asarray(maps[0].ppn)
    p0 = int(live[live >= 0][rng.integers(0, (live >= 0).sum())])
    p0 = min(p0, hmax - 64)
    h_evs = [MappingEvent("remap", p0, 64, ppn=hmax)]
    host, _ = _host_layer(maps, [(req.trace_len // 2, h_evs)])
    world = build_nested_mapping(maps, host, schedule, name="nested-vm-mix")
    return _assemble_nested("nested-vm-mix", world, streams, req, drv,
                            kinds, [h_evs])


@scenario("nested-host-compaction", family="nested",
          description="hypervisor defragmenter live: every host epoch "
                      "migrates scattered guest-frame ranges into one "
                      "dense region, killing composed entries guests "
                      "never touched — sweep under both coh_policy values",
          contiguity="composed chunks die in storms at host epochs; "
                     "host-side runs densify while guest views fracture")
def _nested_host_compaction(req: ScenarioRequest) -> ScenarioData:
    kinds = ["medium", "mixed"]
    maps, streams = _tenant_worlds(kinds, req, _guest_pages(req, 2))
    quantum = max(req.trace_len // 24, 8)
    drv = _DecodeRoundScheduler(pool_pages=1 << 10, max_batch=2)
    for i in range(2):
        drv.enqueue(i, need_pages=64, rounds=RESIDENT_ROUNDS)
    schedule = drv.run(quantum, req.trace_len)

    rng = np.random.default_rng(req.map_seed + 13)
    h0 = _host_identity(maps)
    dest = int(h0.size)
    live = np.unique(np.concatenate(
        [np.asarray(m.ppn)[np.asarray(m.ppn) >= 0] for m in maps]))
    n_epochs = 4
    seg = max(req.trace_len // n_epochs, 2)
    h_sched: List[Tuple[int, List[MappingEvent]]] = []
    for e in range(1, n_epochs):
        evs = []
        # migrate a handful of 32-frame windows around live guest frames
        for p in live[rng.integers(0, live.size, 6)]:
            start = int(min(p, h0.size - 32))
            evs.append(MappingEvent("compact", start, 32, ppn=dest))
            dest += 32             # contiguous with the previous migrant
        h_sched.append((e * seg, evs))
    host = build_dynamic_mapping(h0, h_sched, name="host-compaction")
    world = build_nested_mapping(maps, host, schedule,
                                 name="nested-host-compaction")
    return _assemble_nested("nested-host-compaction", world, streams, req,
                            drv, kinds, [evs for _, evs in h_sched])


@scenario("nested-balloon", family="nested",
          description="balloon driver: inflate scatters one VM's frames "
                      "page-by-page (host reclaims contiguous memory), "
                      "deflate re-compacts them — the guest table never "
                      "changes while composed contiguity shatters and "
                      "returns",
          contiguity="one VM's composed runs shatter to singletons at "
                     "inflate and re-densify at deflate")
def _nested_balloon(req: ScenarioRequest) -> ScenarioData:
    kinds = ["large", "small"]
    maps, streams = _tenant_worlds(kinds, req, _guest_pages(req, 2))
    quantum = max(req.trace_len // 24, 8)
    drv = _DecodeRoundScheduler(pool_pages=1 << 10, max_batch=2)
    for i in range(2):
        drv.enqueue(i, need_pages=64, rounds=RESIDENT_ROUNDS)
    schedule = drv.run(quantum, req.trace_len)

    rng = np.random.default_rng(req.map_seed + 29)
    h0 = _host_identity(maps)
    victim = np.asarray(maps[0].ppn)
    victim = np.unique(victim[victim >= 0])
    picked = victim[rng.integers(0, victim.size, 48)]
    scatter = int(h0.size)
    inflate = []
    for p in np.unique(picked):
        # page-by-page to far-apart frames: every composed run through p
        # breaks (the dyn-thp-split scatter pattern, one level down)
        inflate.append(MappingEvent("remap", int(p), 1, ppn=scatter))
        scatter += 2
    # deflate: the same frames come back contiguous (host re-compacted)
    deflate = [MappingEvent("compact", int(p), 1, ppn=scatter + i)
               for i, p in enumerate(np.unique(picked))]
    t1, t2 = max(req.trace_len // 3, 1), max(2 * req.trace_len // 3, 2)
    host = build_dynamic_mapping(h0, [(t1, inflate), (t2, deflate)],
                                 name="host-balloon")
    world = build_nested_mapping(maps, host, schedule,
                                 name="nested-balloon")
    return _assemble_nested("nested-balloon", world, streams, req, drv,
                            kinds, [inflate, deflate])
