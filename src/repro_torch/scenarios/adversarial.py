"""Adversarial scenario generators: OS events that reshape contiguity.

Each starts from a demand-paged mapping and applies one contiguity-shifting
mechanism real kernels perform, producing distributions that stress specific
assumptions of the compared schemes:

* ``adv-compaction``  — memory compaction (``kcompactd``): a fraction of the
  chunks is migrated into one dense physical region in VA order, merging
  virtually-adjacent migrated chunks into very large runs while the rest
  stays fragmented.  Bimodal: a few huge chunks + many small ones — the
  regime where a single fixed anchor distance must sacrifice one mode.
* ``adv-thp-split``   — THP splitting: a THP-backed mapping (order-9 runs)
  whose huge pages are partially broken by hole-punching (COW faults,
  ``madvise(MADV_DONTNEED)``), shattering 512-runs into irregular fragments.
  Defeats the 2MB-only scheme while k<9 alignment classes still coalesce.
* ``adv-numa``        — NUMA interleave (``MPOL_INTERLEAVE``): consecutive
  16-page virtual granules round-robin across 4 node regions, so *every*
  chunk is exactly 16 pages.  A single-size distribution: Algorithm 3
  should collapse to K={4} (Table 1: size 2–16 → k=4) and anything assuming
  larger reach wastes its entries.

Traces are multiscale reuse sweeps (the locality family of the paper's SPEC
analogues), seeded by ``trace_seed``.
"""
from __future__ import annotations

import numpy as np

from ..core.mappings import demand_mapping
from ..core.page_table import (contiguity_chunks, contiguity_histogram,
                               make_mapping)
from ..core.traces import generate_trace
from .base import ScenarioData, ScenarioRequest, scenario


def _with_trace(name: str, ppn: np.ndarray, req: ScenarioRequest
                ) -> ScenarioData:
    m = make_mapping(ppn, name=name)
    tr = generate_trace("multiscale", 0, req.trace_len,
                        seed=req.trace_seed, mapping=m)
    return ScenarioData(name, m, tr,
                        meta={"contiguity_histogram":
                              contiguity_histogram(m)})


@scenario("adv-compaction", family="adversarial",
          description="demand mapping after a compaction pass migrated half "
                      "the chunks into one dense physical region",
          contiguity="bimodal: few very large compacted runs + untouched "
                     "small buddy chunks")
def _compaction(req: ScenarioRequest) -> ScenarioData:
    m0 = demand_mapping(req.n_pages, seed=req.map_seed)
    rng = np.random.default_rng(req.map_seed + 1)
    ppn = m0.ppn.copy()
    chunks = contiguity_chunks(m0)
    picked = rng.random(len(chunks)) < 0.5
    dest = int(ppn.max()) + 2          # fresh dense region, off by a guard
    for (start, size), take in zip(chunks, picked):
        if not take:
            continue
        ppn[start: start + size] = np.arange(dest, dest + size)
        dest += size                   # contiguous with the previous migrant
    return _with_trace("adv-compaction", ppn, req)


@scenario("adv-thp-split", family="adversarial",
          description="THP-backed mapping with huge pages partially split "
                      "by hole-punching (COW / MADV_DONTNEED analogue)",
          contiguity="shattered 512-page runs: irregular 60–250-page "
                     "fragments")
def _thp_split(req: ScenarioRequest) -> ScenarioData:
    m0 = demand_mapping(req.n_pages, seed=req.map_seed, thp=True)
    rng = np.random.default_rng(req.map_seed + 1)
    ppn = m0.ppn.copy()
    scatter = int(ppn.max()) + 2
    for start, size in contiguity_chunks(m0):
        if size < 64 or rng.random() >= 0.6:
            continue
        holes = rng.integers(1, size, size=int(rng.integers(1, 4)))
        for h in np.unique(holes):
            ppn[start + int(h)] = scatter   # remapped far away: run breaks
            scatter += 2
    return _with_trace("adv-thp-split", ppn, req)


@scenario("adv-numa", family="adversarial",
          description="NUMA-interleave analogue: 16-page virtual granules "
                      "round-robin across 4 node regions",
          contiguity="uniform: every chunk exactly 16 pages (Table 1 k=4)")
def _numa_interleave(req: ScenarioRequest) -> ScenarioData:
    nodes, gran = 4, 16
    n = (req.n_pages // (nodes * gran)) * nodes * gran
    n = max(n, nodes * gran)
    vpn = np.arange(n, dtype=np.int64)
    granule = vpn // gran
    node = granule % nodes
    # within its node, each granule lands after the node's earlier granules;
    # node regions are separated by a guard page so runs never merge
    node_region = (n // nodes) + 1
    within = (granule // nodes) * gran + (vpn % gran)
    ppn = node * node_region + within
    return _with_trace("adv-numa", ppn, req)
