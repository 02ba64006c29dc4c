"""Write the JAX reference results the PyTorch port is held to at full size.

Runs the JAX package's ``run_sweep(..., backend="xla", cache=False)`` on
the paper's Table 4 batch, "quick" tier, exactly as
``benchmarks/tlb_suite.py::bench_synthetic`` builds it: the four synthetic
mappings (small, medium, large, mixed) of 2^19 pages, each with a
150,000-access multiscale trace (mapping seed 1, trace seed 2), under the
12-method roster of ``tlb_suite._add_suite`` (Base, THP, RMM, COLT,
Cluster, Anchor d in {4, 6, 8, 10}, |K| = 2/3/4 Aligned) — 48 cells, one
64-lane batch.  Per cell it records the spec, the mapping kind, every
``SimResult`` counter, ``coverage_mean`` and the SHA-256 of ``ppn`` as
int32 bytes, into ``tests/data/port_table4_reference.json``.

``chip_smoke.py`` holds the port's CUDA kernel to this file on the card;
``tests/test_torch_sweep.py`` (slow lane) regenerates it and compares.
The port itself never imports this script.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/make_port_reference.py
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from benchmarks.tlb_suite import (ANCHOR_GRID_QUICK,  # noqa: E402
                                  SweepPlan, _add_suite)
from repro.core.mappings import synthetic_mapping  # noqa: E402
from repro.core.sweep import run_sweep  # noqa: E402
from repro.core.traces import generate_trace  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "port_table4_reference.json")
KINDS = ("small", "medium", "large", "mixed")
COUNTERS = ("accesses", "l1_hits", "l2_regular_hits", "l2_coalesced_hits",
            "walks", "aligned_probes", "pred_correct", "cycles",
            "shootdowns")


def table4_plan(n_pages: int = 1 << 19, trace_len: int = 150_000
                ) -> SweepPlan:
    plan = SweepPlan()
    for kind in KINDS:
        m = synthetic_mapping(kind, n_pages, seed=1)
        tr = generate_trace("multiscale", 0, trace_len, seed=2, mapping=m)
        _add_suite(plan, m, tr, kind, ANCHOR_GRID_QUICK)
    return plan


def ppn_digest(ppn) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(ppn, dtype=np.int32).tobytes()).hexdigest()


def reference(n_pages: int = 1 << 19, trace_len: int = 150_000):
    """``(reference dict, seconds the JAX sweep took)``."""
    plan = table4_plan(n_pages, trace_len)
    t0 = time.time()
    sweep = run_sweep(plan.cells, cache=False, backend="xla")
    wall = time.time() - t0
    cells = []
    for cell, (kind, label, _), r in zip(plan.cells, plan.tags,
                                         sweep.results):
        cells.append(dict(
            mapping=kind, label=label, name=r.name,
            spec=dataclasses.asdict(cell.spec),
            **{f: int(getattr(r, f)) for f in COUNTERS},
            coverage_mean=float(r.coverage_mean),
            ppn_sha256=ppn_digest(r.ppn)))
    return dict(
        source="JAX run_sweep(backend='xla', cache=False), "
               "scripts/make_port_reference.py",
        n_pages=n_pages, trace_len=trace_len, map_seed=1, trace_seed=2,
        trace_pattern="multiscale", anchor_grid=list(ANCHOR_GRID_QUICK),
        psis=[2, 3, 4], cells=cells), wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    ref, wall = reference()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {len(ref['cells'])} cells to {args.out} "
          f"(the JAX sweep took {wall:.1f} s on this host's CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
