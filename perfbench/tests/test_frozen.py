"""The frozen copies against the pieces they were copied from: the world
generators and the roster against the program's, the kernel count against
``chip_smoke.py``'s."""
import dataclasses

import numpy as np
import pytest

import chip_smoke as cs
from perfbench.harness import bench
from perfbench.tests import tiny
from perfbench.tlbref import specs as fspecs, worlds


@pytest.mark.parametrize("kind", worlds.SYNTH_KINDS)
def test_worlds_equal_the_programs(kind):
    from repro_torch.scenarios import get_scenario
    a = worlds.build_world(f"synth-{kind}", 1 << 12, 3000, 5, 13)
    b = get_scenario(f"synth-{kind}").materialize(
        n_pages=1 << 12, trace_len=3000, map_seed=5, trace_seed=13)
    for f in ("ppn", "run_start", "run_len"):
        assert np.array_equal(getattr(a.mapping, f), getattr(b.mapping, f))
    assert np.array_equal(a.trace, b.trace)


def test_roster_equals_chip_smokes():
    from repro_torch.core.mappings import synthetic_mapping
    w = worlds.build_world("synth-mixed", 1 << 13, 10, 3, 4)
    mine = [dataclasses.asdict(s) for s, _, _ in fspecs.suite_specs(
        w.histogram, (4, 6, 8, 10), (2, 3, 4))]
    theirs = [dataclasses.asdict(s) for s in cs.roster(
        synthetic_mapping("mixed", 1 << 13, seed=3))]
    assert mine == theirs


def test_tlb_count_equals_chip_smokes_bound():
    from repro_torch.core.sweep import pack_batch, run_sweep
    cell = tiny.sweep_cell(worlds=("synth-small", "synth-large"),
                           trace_len=400)
    drv = tiny.driver(cell)
    (batch,) = drv.make_batches(cell)
    res = run_sweep(batch.cells, cache=False, device="cpu").results
    lanes, stacks, st0, seg = pack_batch(batch.cells)
    want = cs.bound(lanes, stacks, st0, seg, res, 1e12)
    got = bench.count("tlb_sweep").work(
        [(w, s, r) for (w, s), r in zip(batch.lanes, res)])
    assert (got["bytes"], got["ops"]) == (want[2], want[3])
