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
