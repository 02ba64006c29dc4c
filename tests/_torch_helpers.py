"""Shared builders for the PyTorch-port tests.

Every world is built from seeds by a function that takes the package's
modules as arguments, so the JAX package (``repro.core``) and the port
(``repro_torch.core``) build the same world from the same numpy draws.
This module imports neither package itself: the card-only tests use it
on a machine that has no JAX.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np

COUNTERS = ("accesses", "l1_hits", "l2_regular_hits", "l2_coalesced_hits",
            "walks", "aligned_probes", "pred_correct", "cycles",
            "coverage_mean", "shootdowns")


def pkg(core_pkg):
    """The modules a builder needs, from ``repro.core`` or
    ``repro_torch.core`` (imported by the caller)."""
    import importlib
    name = core_pkg.__name__
    mods = {m: importlib.import_module(f"{name}.{m}")
            for m in ("page_table", "mappings", "traces", "baselines",
                      "simulator", "sweep")}
    return SimpleNamespace(**mods)


def convert_spec(spec, simulator_module):
    """A ``MethodSpec`` of one package as the other's, field by field."""
    return simulator_module.MethodSpec(**dataclasses.asdict(spec))


def all_kinds(p):
    """The 11 specs of ``tests/test_backends.py``: all 10 kinds, K-aligned
    with and without the predictor."""
    b = p.baselines
    return [b.base_spec(), b.thp_spec(), b.colt_spec(), b.cluster_spec(),
            b.rmm_spec(), b.anchor_spec(6), b.kaligned_spec([9, 6, 4]),
            b.kaligned_spec([6, 4], use_predictor=False, name="ka-nopred"),
            b.subregion_spec(), b.cache_tlb_spec(), b.dead_protect_spec()]


def static_world(p):
    """``tests/test_backends.py``'s static world: demand mapping, 400
    multiscale accesses."""
    m = p.mappings.demand_mapping(1 << 10, seed=11)
    tr = p.traces.generate_trace("multiscale", 0, 400, seed=4, mapping=m)
    return m, tr


def dynamic_world(p):
    """``tests/test_backends.py``'s dynamic world: a remap at t=150, a
    split and an unmap at t=370, 520 random accesses."""
    pt = p.page_table
    n = 1 << 10
    ppn0 = np.arange(n, dtype=np.int64) + 7
    ev1 = [pt.MappingEvent("remap", 0, 128, ppn=100_000)]
    ev2 = [pt.MappingEvent("split", 128, 64,
                           ppn=np.arange(200_000, 200_000 + 64 * 3, 3)),
           pt.MappingEvent("unmap", 768, 32)]
    dyn = pt.build_dynamic_mapping(ppn0, [(150, ev1), (370, ev2)],
                                   name="hot")
    rng = np.random.default_rng(3)
    return dyn, rng.integers(0, 512, size=520).astype(np.int64)


def multitenant_world(p):
    """``tests/test_multitenant.py``'s hand world: three tenants, seven
    quanta, tenant 2 recycling tenant 0's ASID; 470 accesses."""
    pt = p.page_table
    ta = p.mappings.demand_mapping(1 << 10, seed=1)
    tb = pt.make_mapping(np.arange(1 << 10, dtype=np.int64) + 3,
                         name="contig")
    tc = p.mappings.demand_mapping(1 << 9, seed=7, thp=True)
    mt = pt.build_multitenant_mapping(
        [ta, tb, tc],
        [(0, 0, 0), (60, 1, 1), (130, 0, 0), (200, 1, 1),
         (260, 2, 0), (330, 1, 1), (400, 2, 0)], name="mt-hand")
    rng = np.random.default_rng(5)
    bounds = list(mt.boundaries) + [470]
    parts = []
    for s in range(mt.n_segments):
        m = mt.tenants[mt.tenant_ids[s]]
        mv = np.flatnonzero(m.ppn >= 0)
        parts.append(mv[rng.integers(0, mv.size, bounds[s + 1] - bounds[s])])
    return mt, np.concatenate(parts).astype(np.int64)


def nested_world(p):
    """``tests/test_nested.py``'s 2-guest nested world: a guest remap at
    t=120, a host remap at t=200; 330 accesses."""
    pt = p.page_table
    n = 512
    g0_base = p.mappings.demand_mapping(n, seed=11)
    g1 = p.mappings.demand_mapping(n, seed=13, thp=True)
    fresh = int(g0_base.ppn.max()) + 2
    g0 = pt.build_dynamic_mapping(
        g0_base.ppn, [(120, [pt.MappingEvent("remap", 40, 30, ppn=fresh)])],
        name="g0")
    hmax = max(int(np.max(np.asarray(m.ppn))) for m in
               (g0.epochs[0], g0.epochs[1], g1)) + 40
    host = pt.build_dynamic_mapping(
        np.arange(hmax, dtype=np.int64),
        [(200, [pt.MappingEvent("remap", 480, 96, ppn=hmax + 5)])],
        name="host")
    world = pt.build_nested_mapping(
        [g0, g1], host, [(0, 0, 0), (90, 1, 1), (180, 0, 0), (260, 1, 1)],
        name="nw")
    rng = np.random.default_rng(5)
    segs = world.plan_segments()
    bounds = [s.lo for s in segs] + [330]
    parts = []
    for s, seg in enumerate(segs):
        mv = np.flatnonzero(np.asarray(seg.mapping.ppn) >= 0)
        parts.append(mv[rng.integers(0, mv.size, bounds[s + 1] - bounds[s])])
    return world, np.concatenate(parts).astype(np.int64)


def parity_world(p):
    """The static world plus three parity-flip faults on hot pages."""
    m, tr = static_world(p)
    faults = tuple((t, int(tr[t - 1])) for t in (97, 211, 333))
    return p.page_table.ParityWorld(base=m, faults=faults), tr


def with_policy(specs, **fields):
    return [dataclasses.replace(s, **fields) for s in specs]


def world_cells(p, world: str):
    """``SweepCell``s of one named test world under every spec it runs."""
    specs = all_kinds(p)
    SweepCell = p.sweep.SweepCell
    if world == "static":
        m, tr = static_world(p)
    elif world == "dynamic":
        m, tr = dynamic_world(p)
        specs = specs + with_policy(specs, coh_policy="hw-coherence")
    elif world == "multitenant":
        m, tr = multitenant_world(p)
        specs = (with_policy(specs, ctx_policy="flush")
                 + with_policy(specs, ctx_policy="tag"))
    elif world == "nested":
        m, tr = nested_world(p)
        specs = (with_policy(specs, coh_policy="shootdown")
                 + with_policy(specs, coh_policy="hw-coherence"))
    elif world == "parity":
        m, tr = parity_world(p)
        specs = (with_policy(specs, par_policy="parity")
                 + with_policy(specs, par_policy="ecc"))
    else:
        raise KeyError(world)
    return [SweepCell(s, m, tr) for s in specs]


WORLDS = ("static", "dynamic", "multitenant", "nested", "parity")


# ---------------------------------------------------------------------------
# Fuzzed worlds (the twin of tests/test_fuzz_differential.py)
# ---------------------------------------------------------------------------

#: the world kinds of the fuzz twin: the segmented ones
FUZZ_KINDS = ("dynamic", "multitenant", "nested")
#: the policies each fuzzed world kind is swept under
FUZZ_POLICIES = {
    "dynamic": [dict(coh_policy=c) for c in ("shootdown", "hw-coherence")],
    "multitenant": [dict(ctx_policy=c) for c in ("flush", "tag")],
    "nested": [dict(ctx_policy=x, coh_policy=c) for x in ("flush", "tag")
               for c in ("shootdown", "hw-coherence")]}


def _mapped_trace(m, n, rng):
    """``n`` random mapped vpns of ``m``; None if nothing is mapped."""
    mv = np.flatnonzero(np.asarray(m.ppn) >= 0)
    if mv.size == 0:
        return None
    return mv[rng.integers(0, mv.size, n)].astype(np.int64)


def fuzz_world(p, world_kind: str, seed: int):
    """``tests/test_fuzz_differential.py::_gen_world`` over either package
    ``p`` (see :func:`pkg`): a deterministic (world, trace) from one seed,
    None if degenerate."""
    pt = p.page_table
    demand_mapping = p.mappings.demand_mapping
    MappingEvent, make_mapping = pt.MappingEvent, pt.make_mapping
    build_dynamic_mapping = pt.build_dynamic_mapping
    build_multitenant_mapping = pt.build_multitenant_mapping
    build_nested_mapping = pt.build_nested_mapping
    rng = np.random.default_rng(seed)
    n = 512
    if world_kind == "static":
        m = demand_mapping(n, seed=seed % 997)
        trace = _mapped_trace(m, 260, rng)
        return (m, trace) if trace is not None else None

    if world_kind == "dynamic":
        m0 = demand_mapping(n, seed=seed % 991)
        fresh = int(m0.ppn.max()) + 2
        ppn = m0.ppn
        schedule = []
        for e in (1, 2):
            evs = []
            for _ in range(int(rng.integers(1, 3))):
                kind = str(rng.choice(["remap", "unmap", "map", "compact"]))
                start = int(rng.integers(0, n - 64))
                ln = int(rng.integers(1, 48))
                if kind == "unmap":
                    evs.append(MappingEvent("unmap", start, ln))
                else:
                    evs.append(MappingEvent(kind, start, ln, ppn=fresh))
                    fresh += ln + 1
            schedule.append((e * 90, evs))
        dyn = build_dynamic_mapping(m0.ppn, schedule, name=f"fz{seed}")
        parts = []
        bounds = list(dyn.boundaries) + [300]
        for e in range(dyn.n_epochs):
            p = _mapped_trace(dyn.epochs[e], bounds[e + 1] - bounds[e], rng)
            if p is None:
                return None
            parts.append(p)
        return dyn, np.concatenate(parts)

    if world_kind == "nested":
        # nested: 1-2 guests, each optionally with its own event stream,
        # composed over a host layer with its own random event stream; the
        # VM schedule draws ASIDs from a pool smaller than the guest count
        n_g = int(rng.integers(1, 3))
        guests, fresh = [], 0
        for i in range(n_g):
            g0 = demand_mapping(n, seed=(seed + 3 * i) % 971)
            fresh = max(fresh, int(g0.ppn.max()) + 2)
            if rng.integers(0, 2):
                evs = []
                for _ in range(int(rng.integers(1, 3))):
                    kind = str(rng.choice(["remap", "unmap", "map",
                                           "compact"]))
                    start = int(rng.integers(0, n - 64))
                    ln = int(rng.integers(1, 32))
                    if kind == "unmap":
                        evs.append(MappingEvent("unmap", start, ln))
                    else:
                        evs.append(MappingEvent(kind, start, ln, ppn=fresh))
                        fresh += ln + 1
                guests.append(build_dynamic_mapping(
                    g0.ppn, [(int(rng.integers(60, 200)), evs)],
                    name=f"fzg{seed}_{i}"))
            else:
                guests.append(g0)
        hsize = fresh + 8            # host covers every guest PPN
        h_evs, hfresh = [], hsize
        for _ in range(int(rng.integers(1, 3))):
            kind = str(rng.choice(["remap", "unmap", "compact"]))
            start = int(rng.integers(0, hsize - 64))
            ln = int(rng.integers(1, 64))
            if kind == "unmap":
                h_evs.append(MappingEvent("unmap", start, ln))
            else:
                h_evs.append(MappingEvent(kind, start, ln, ppn=hfresh))
                hfresh += ln + 1
        host = build_dynamic_mapping(
            np.arange(hsize, dtype=np.int64),
            [(int(rng.integers(80, 240)), h_evs)], name=f"fzh{seed}")
        sched, t = [], 0
        for _ in range(int(rng.integers(2, 5))):
            gid = int(rng.integers(0, n_g))
            if sched and sched[-1][1] == gid:
                asid = sched[-1][2]  # a resident VM keeps its vCPU ASID
            else:
                asid = int(rng.integers(0, max(n_g - 1, 1)))
            sched.append((t, gid, asid))
            t += 70
        world = build_nested_mapping(guests, host, sched, name=f"fzn{seed}")
        segs = world.plan_segments()
        total = max(sg.lo for sg in segs) + 90
        bounds = [sg.lo for sg in segs] + [total]
        parts = []
        for s, sg in enumerate(segs):
            p = _mapped_trace(sg.mapping, bounds[s + 1] - bounds[s], rng)
            if p is None:
                return None          # a host unmap emptied a composed view
            parts.append(p)
        return world, np.concatenate(parts)

    # multitenant: 2-3 tenants, 5-7 segments, ASIDs drawn from a pool
    # SMALLER than the tenant count so recycling happens organically
    n_ten = int(rng.integers(2, 4))
    tenants = []
    for i in range(n_ten):
        style = int(rng.integers(0, 3))
        if style == 0:
            tenants.append(demand_mapping(n, seed=(seed + i) % 983))
        elif style == 1:
            tenants.append(make_mapping(
                np.arange(n, dtype=np.int64) + int(rng.integers(1, 100)),
                name=f"contig{i}"))
        else:
            tenants.append(demand_mapping(n, seed=(seed + i) % 977,
                                          thp=True))
    n_seg = int(rng.integers(5, 8))
    q = 40
    schedule = []
    for s in range(n_seg):
        tid = int(rng.integers(0, n_ten))
        if schedule and schedule[-1][1] == tid:
            # a resident tenant keeps its ASID (constructor invariant)
            asid = schedule[-1][2]
        else:
            asid = int(rng.integers(0, max(n_ten - 1, 1)))
        schedule.append((s * q, tid, asid))
    mt = build_multitenant_mapping(tenants, schedule, name=f"fzmt{seed}")
    total = n_seg * q + 20
    bounds = list(mt.boundaries) + [total]
    parts = []
    for s in range(mt.n_segments):
        m = mt.tenants[mt.tenant_ids[s]]
        p = _mapped_trace(m, bounds[s + 1] - bounds[s], rng)
        if p is None:
            return None
        parts.append(p)
    return mt, np.concatenate(parts)


def fuzz_cells(p, world_kind: str, seed: int):
    """Every kind (``all_kinds``) under every policy of the world kind, as
    ``SweepCell``s over ``fuzz_world(p, world_kind, seed)``; [] if the
    draw is degenerate."""
    gen = fuzz_world(p, world_kind, seed)
    if gen is None:
        return []
    world, trace = gen
    return [p.sweep.SweepCell(dataclasses.replace(s, **pol), world, trace)
            for pol in FUZZ_POLICIES[world_kind] for s in all_kinds(p)]


def oracle(sim, cell):
    """The pure-python oracle of simulator module ``sim`` for one cell."""
    kind = type(cell.mapping).__name__
    run = {"NestedMapping": sim.run_method_nested,
           "MultiTenantMapping": sim.run_method_multitenant,
           "ParityWorld": sim.run_method_parity}.get(
               kind, sim.run_method_dynamic)       # static and dynamic
    return run(cell.spec, cell.mapping, cell.trace)


# ---------------------------------------------------------------------------
# Paged attention cases
# ---------------------------------------------------------------------------

#: ``tests/test_kernels.py``'s paged-attention shapes (B, H, KVH, D, T)
PAGED_SHAPES = ((2, 4, 2, 64, 16), (3, 8, 8, 32, 8), (1, 8, 1, 128, 16))
#: and its class sets
PAGED_K_CLASSES = ((), (2,), (3, 1))


def random_pool_case(rng, allocator_cls, B, H, KVH, D, T, n_pages,
                     frag: float):
    """``tests/test_kernels.py::_random_pool_case`` in numpy: block tables
    with tunable fragmentation from ``allocator_cls`` (either package's
    ``PagedKVAllocator``), float32 pools and queries.  Returns
    ``(q, k_pool, v_pool, block_tables, kv_lens)``."""
    alloc = allocator_cls(n_pages, max_order=5,
                          alloc_policy="page" if frag > 0.9 else "buddy_best")
    for i in range(int(frag * 10)):
        alloc.allocate(1000 + i, int(rng.integers(1, 6)))
    for i in range(int(frag * 10)):
        if rng.random() < 0.5:
            alloc.free(1000 + i)
    lens, tables = [], []
    max_pages = n_pages // 2
    for b in range(B):
        L = int(rng.integers(T, T * max_pages // 2))
        alloc.allocate(b, -(-L // T))
        lens.append(L)
        tables.append(alloc.block_table(b, max_pages))
    bt = np.stack(tables)
    kp = rng.standard_normal((n_pages, T, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, T, KVH, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)
