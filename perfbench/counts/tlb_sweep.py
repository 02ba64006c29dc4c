"""The work one ``run_sweep`` call of the TLB-sweep kernel needs, from its
inputs and the counters it produced: a frozen copy of
``chip_smoke.py::bound``'s counts, taken from the benchmark's own static
worlds and specs instead of the program's packed batch.

Bytes, each needed input word counted once: every distinct trace (4 B an
access), the distinct (mapping, vpn) map records (16 B) and (mapping,
fill policy, vpn) fill records (20 B) the accesses touch, the distinct
(mapping, vpn) cluster words of cluster lanes (4 B), and the outputs (a 4-B
ppn an access, 9 counters and 64 coverage samples a lane).

Operations, 3 int32 operations (two compares and a select) for each
entry an access must examine, counted per lane from its spec and its
counters: every access probes the L1 set (and the 2MB L1 set on THP
lanes); an L1 miss probes the L2 set (and the huge row on THP lanes) and
picks an L1 victim; on K-aligned and Anchor lanes the aligned probes of
the coalesced hits and every K slot on a walk probe one L2 row each; an
access that misses L1 and L2 probes the range table, cluster set or
cache tier its lane has; a walk scans for an L2 victim (and a range-table
victim on RMM lanes).  The bound is operations over the int32 peak or
bytes over HBM bandwidth, whichever is larger.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

#: entries of the structures an access probes (Table 2)
L1_WAYS, CLUS_WAYS, RANGE_ENTRIES, CTLB_WAYS = 4, 5, 32, 8


def fill_key(spec) -> Tuple:
    if spec.kind in ("kaligned", "anchor"):
        return ("ka", tuple(spec.K))
    if spec.kind in ("colt", "thp"):
        return (spec.kind,)
    if spec.kind == "subregion":
        return ("subr",)
    return ("reg",)


def lane_entries(spec, r) -> int:
    """Entries one lane's accesses must examine (its spec, its
    ``SimResult`` counters)."""
    is_thp, is_colt = spec.kind == "thp", spec.kind == "colt"
    is_subr = spec.kind == "subregion"
    has_rmm, has_clus = spec.side == "rmm", spec.side == "cluster"
    has_ctlb = spec.kind == "cache-tlb"
    ways = int(spec.l2_ways)
    live_k = len(spec.K)
    generic = not (is_thp or is_colt or is_subr)
    side = (RANGE_ENTRIES * has_rmm + CLUS_WAYS * has_clus
            + CTLB_WAYS * has_ctlb)
    side_hits = (r.l2_coalesced_hits if side and generic and live_k == 0
                 else 0)
    rows = 2 if is_thp else 1
    l1_miss = r.accesses - r.l1_hits
    return (L1_WAYS * rows * r.accesses
            + (ways * rows + L1_WAYS) * l1_miss
            + (ways * (r.aligned_probes + live_k * r.walks)
               if generic else 0)
            + side * (r.walks + side_hits)
            + (ways + RANGE_ENTRIES * has_rmm) * r.walks)


def work(lanes: Sequence) -> Dict[str, int]:
    """``{"bytes", "ops", "accesses"}`` of one call: ``lanes`` is one
    ``(world, spec, result)`` a lane, each world a static mapping with its
    trace (``tlbref.worlds.World``)."""
    by_world: Dict[str, list] = {}
    for w, s, _ in lanes:
        by_world.setdefault(w.name, [w, set(), False])
        by_world[w.name][1].add(fill_key(s))
        by_world[w.name][2] |= s.side == "cluster"
    n_bytes = 0
    for w, keys, clus in by_world.values():
        trace = np.asarray(w.trace)
        vpns = np.unique(trace).size
        n_bytes += (4 * trace.shape[0] + 16 * vpns + 20 * len(keys) * vpns
                    + 4 * vpns * clus)
    acc = sum(int(r.accesses) for _, _, r in lanes)
    n_bytes += 4 * acc + 4 * (9 + 64) * len(lanes)
    n_ops = 3 * sum(lane_entries(s, r) for _, s, r in lanes)
    return {"bytes": int(n_bytes), "ops": int(n_ops), "accesses": acc}


def bound_s(w: Dict[str, int], int32_ops_per_s: float,
            bytes_per_s: float) -> float:
    """Least seconds the card could take for ``work``'s numbers."""
    return max(w["bytes"] / bytes_per_s, w["ops"] / int32_ops_per_s)
