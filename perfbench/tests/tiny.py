"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, with the sizes overridden."""
from __future__ import annotations

import copy

from perfbench.harness import bench

SPEC = bench.load_json(bench.ROOT / "BENCHMARK.json")


def sweep_cell(workload="sweep.table4", seed=2 ** 31 + 12345, seconds=0.5,
               worlds=("synth-mixed",), n_pages=4096, trace_len=300):
    cell = bench.find_cell(SPEC, workload, seed, seconds, False)
    cell.config = dict(copy.deepcopy(cell.config), n_pages=n_pages,
                       trace_len=trace_len)
    cell.traffic = dict(copy.deepcopy(cell.traffic), calls=[list(worlds)],
                        check_cells=2, check_workers=1)
    cell.device = "cpu"
    return cell


def driver(cell):
    return bench.driver(cell)
