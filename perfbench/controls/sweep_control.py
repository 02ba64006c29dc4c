"""The control of a sweep cell: the plain reference with one guarantee of
the configuration broken, put in the program's place and run through the
driver's own window and checks.

The broken guarantee is exact translation: every walk on an aligned lane
installs the entry of the largest class of K over its whole 2^k-aligned
block, without the contiguity scan of Algorithm 1, so pages past the run
translate wrongly (the shortcut a faster packing would be tempted by).
The run's ``correct`` has to come out false on every seed; the program's
``oracle_mismatches`` is 0 on every sound run, and its limit is 0.

    python3 perfbench/controls/sweep_control.py --workload sweep.table4 \\
        --seeds 11,12,13
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.harness import bench  # noqa: E402


def unchecked_fill(spec, pt, vpn):
    """A walk's fill with Algorithm 1's contiguity scan left out on
    aligned lanes: the largest class covers its whole block."""
    if spec.kind in ("kaligned", "anchor") and spec.K:
        k = spec.K[0]
        vk = vpn & ~((1 << k) - 1)
        if pt.ppn[vk] >= 0:
            return vk, k, 1 << k, pt.ppn[vk]
    from perfbench.tlbref import reference
    return reference.walk_fill(spec, pt, vpn)


def control_sweep(cell: bench.Cell, drv, fill) -> object:
    """A ``sweep`` for the driver: the broken reference over every lane of
    a batch, computed once a batch."""
    done = {}

    def sweep(batch):
        key = id(batch)
        if key not in done:
            jobs = [drv.job(cell, lane) for lane in batch.lanes]
            done[key] = drv.reference(
                jobs, int(cell.traffic["check_workers"]), walk_fill=fill)
        return types.SimpleNamespace(results=list(done[key]), stats={})
    return sweep


def control_outcome(workload: str, seed: int, seconds: float = 0.1):
    """The driver's ``Outcome`` of a run with the control in the
    program's place."""
    from perfbench.controls import sweep_control as me
    spec = bench.load_json(bench.ROOT / "BENCHMARK.json")
    cell = bench.find_cell(spec, workload, seed, seconds, False)
    cell.device = "cpu"                 # the control needs no card
    drv = bench.driver(cell)
    return cell, drv.run(cell, sweep=control_sweep(cell, drv,
                                                   me.unchecked_fill))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    bench.cache_env()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        _, out = control_outcome(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out.correct,
                          "checks": {c["name"]: c["value"]
                                     for c in out.checks},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
