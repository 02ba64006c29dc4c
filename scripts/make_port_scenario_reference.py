"""Write the JAX reference results of the scenario sweeps the port is held to.

Runs the JAX package on the CPU over the five scenario sections of
``benchmarks/tlb_suite.py``, built exactly as its bench functions build
them at their defaults (``quick=False``, 120,000-access traces,
``SCENARIO_SEEDS``):

* ``scenarios``   — ``bench_scenarios``: every workload and adversarial
  scenario at 2^19 pages, ``_add_suite`` with anchors (4, 6, 8, 10) and
  psis (2, 3): 8 x 11 cells, one ``run_sweep``;
* ``dynamic``     — ``bench_dynamic``: every dynamic scenario at 2^16
  pages, K from the epoch-0 mapping: 3 x 11 cells, one ``run_sweep``;
* ``multitenant`` — ``bench_multitenant``: every multi-tenant scenario at
  2^15 pages, psis (2, 3, 4), both ``ctx_policy`` values, K from the
  merged histogram: 3 x 2 x 12 cells, one ``run_sweep`` per world;
* ``nested``      — ``bench_nested``: every nested scenario at 2^15 pages,
  psis (2, 3), both ``coh_policy`` values: 3 x 2 x 11 cells, one
  ``run_sweep`` per world;
* ``accelerator`` — ``bench_accelerator``: every accelerator scenario at
  2^19 pages under Base, |K|=3, Subregion, Cache-TLB and Dead-Protect:
  3 x 5 cells, one ``run_sweep``.

That is 274 cells through ``run_sweep(backend="xla", cache=False)``.  Per
world it records the SHA-256 of the trace and of every mapping, epoch,
tenant, guest-epoch, host-epoch and composed-view ``ppn`` (int64 bytes),
the world's class and its segment boundaries (``chip_smoke.world_record``,
which W1 applies to the port's worlds); per cell the section, the
``run_sweep`` call, the plan's row, label and group, the spec, every
``SimResult`` counter, ``coverage_mean`` and the SHA-256 of ``ppn`` as
int32 bytes; and the JAX ``standard_suite`` (Base, THP, RMM, COLT,
Cluster, Anchor-Static over ``ANCHOR_GRID``, |K| = 2/3/4) on the
``kv-churn`` world of the first section.  Output:
``tests/data/port_scenario_reference.json``.

``chip_smoke.py`` holds the port's CUDA kernel to this file on the card
(phases W1 and W2); ``tests/test_torch_sweep.py`` checks that the port
builds the same roster and (slow lane) regenerates the file and compares.
The port itself never imports this script.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/make_port_scenario_reference.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from benchmarks import tlb_suite as ts  # noqa: E402
from chip_smoke import CELL_FIELDS, ppn_digest, world_record  # noqa: E402
from repro.core.baselines import (base_spec, cache_tlb_spec,  # noqa: E402
                                  dead_protect_spec, kaligned_for_histogram,
                                  standard_suite, subregion_spec)
from repro.core.sweep import run_sweep  # noqa: E402
from repro.scenarios import list_scenarios  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data",
                           "port_scenario_reference.json")
TRACE_LEN = 120_000
SECTIONS = ("scenarios", "dynamic", "multitenant", "nested", "accelerator")
#: the world ``standard_suite`` runs on (a world of the first section)
SUITE_WORLD = "kv-churn"


def _world(name: str, trace_len: int, pages: int):
    return ts._scenario_world(name, trace_len, pages)


def section_runs(section: str, max_pages: int = ts.MAX_PAGES_DEFAULT,
                 trace_len: int = TRACE_LEN):
    """The section's ``run_sweep`` calls as ``[(plan, [(name, data)])]``,
    each plan built as ``benchmarks/tlb_suite.py``'s bench function for
    that section builds it (the plans are not run here)."""
    runs = []
    if section == "scenarios":                       # bench_scenarios
        plan, worlds = ts.SweepPlan(), []
        for name in ts._scenario_names(quick=False):
            d = _world(name, trace_len, max_pages)
            ts._add_suite(plan, d.mapping, d.trace, name,
                          ts.ANCHOR_GRID_QUICK, psis=(2, 3))
            worlds.append((name, d))
        runs.append((plan, worlds))
    elif section == "dynamic":                       # bench_dynamic
        plan, worlds = ts.SweepPlan(), []
        for sc in list_scenarios("dynamic"):
            d = _world(sc.name, trace_len,
                       min(max_pages, ts.DYNAMIC_MAX_PAGES))
            ts._add_suite(plan, d.world, d.trace, sc.name,
                          ts.ANCHOR_GRID_QUICK, psis=(2, 3),
                          k_mapping=d.mapping)
            worlds.append((sc.name, d))
        runs.append((plan, worlds))
    elif section in ("multitenant", "nested"):       # bench_multitenant,
        cap, psis, field, policies = (                # bench_nested
            (ts.MULTITENANT_MAX_PAGES, (2, 3, 4), "ctx_policy",
             ("flush", "tag")) if section == "multitenant" else
            (ts.NESTED_MAX_PAGES, (2, 3), "coh_policy",
             ("shootdown", "hw-coherence")))
        for sc in list_scenarios(section):
            d = _world(sc.name, trace_len, min(max_pages, cap))
            plan = ts.SweepPlan()
            for policy in policies:
                ts._add_suite(
                    plan, d.world, d.trace, f"{sc.name}::{policy}",
                    ts.ANCHOR_GRID_QUICK, psis=psis,
                    k_hist=d.meta["contiguity_histogram"],
                    transform=lambda s, p=policy: dataclasses.replace(
                        s, **{field: p}))
            runs.append((plan, [(sc.name, d)]))
    elif section == "accelerator":                   # bench_accelerator
        plan, worlds = ts.SweepPlan(), []
        for sc in list_scenarios("accelerator"):
            d = _world(sc.name, trace_len, max_pages)
            m, tr = d.mapping, d.trace
            plan.add(base_spec(), m, tr, sc.name, "Base")
            plan.add(kaligned_for_histogram(d.meta["contiguity_histogram"],
                                            psi=3, theta=1.0),
                     m, tr, sc.name, "|K|=3")
            plan.add(subregion_spec(), m, tr, sc.name, "Subregion")
            plan.add(cache_tlb_spec(), m, tr, sc.name, "Cache-TLB")
            plan.add(dead_protect_spec(), m, tr, sc.name, "Dead-Protect")
            worlds.append((sc.name, d))
        runs.append((plan, worlds))
    else:
        raise KeyError(section)
    return runs


def result_record(r) -> dict:
    return dict(name=r.name, **{f: int(getattr(r, f)) for f in CELL_FIELDS},
                coverage_mean=float(r.coverage_mean),
                ppn_sha256=ppn_digest(r.ppn))


def reference(max_pages: int = ts.MAX_PAGES_DEFAULT,
              trace_len: int = TRACE_LEN):
    """``(reference dict, seconds the JAX runs took)``."""
    t0 = time.time()
    worlds, cells, suite_world = [], [], None
    for section in SECTIONS:
        for run, (plan, ws) in enumerate(section_runs(section, max_pages,
                                                      trace_len)):
            for name, d in ws:
                worlds.append(dict(section=section, **world_record(name, d)))
                if name == SUITE_WORLD:
                    suite_world = d
            sweep = run_sweep(plan.cells, cache=False, backend="xla")
            for cell, (row, label, group), r in zip(plan.cells, plan.tags,
                                                    sweep.results):
                cells.append(dict(section=section, run=run, row=row,
                                  label=label, group=group,
                                  spec=dataclasses.asdict(cell.spec),
                                  **result_record(r)))
    suite = [result_record(r) for r in standard_suite(
        suite_world.mapping, suite_world.trace)]
    wall = time.time() - t0
    return dict(
        source="JAX run_sweep(backend='xla', cache=False) over the "
               "sections of benchmarks/tlb_suite.py and JAX "
               "standard_suite, scripts/make_port_scenario_reference.py",
        max_pages=max_pages, trace_len=trace_len,
        seeds=dict(ts.SCENARIO_SEEDS),
        anchor_grid=list(ts.ANCHOR_GRID_QUICK), sections=list(SECTIONS),
        worlds=worlds, cells=cells,
        standard_suite=dict(scenario=SUITE_WORLD, results=suite)), wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    ref, wall = reference()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {len(ref['worlds'])} worlds, {len(ref['cells'])} cells "
          f"and the standard suite to {args.out} (the JAX runs took "
          f"{wall:.1f} s on this host's CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
