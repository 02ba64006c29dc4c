"""A run with the timed path broken underneath comes out not correct, and
so does the control, at a tiny size on the CPU: the harness's look for a
card is skipped, the rest of the run is driven as on the card."""
import dataclasses

import numpy as np
import pytest

from perfbench.tests import tiny


def _broken_sweep(monkeypatch, fault):
    from repro_torch.core import sweep as S
    real = S.run_sweep

    def run_sweep(cells, **kw):
        res = real(cells, **kw)
        rs = list(res.results)
        if fault == "answer":          # one counter altered where produced
            rs[1] = dataclasses.replace(rs[1], walks=rs[1].walks + 1)
        elif fault == "half_batch":    # half of the lanes left out
            rs = rs[: len(rs) // 2]
        elif fault == "state_unchanged":   # the step returns its state
            rs = [dataclasses.replace(
                r, l1_hits=0, l2_regular_hits=0, l2_coalesced_hits=0,
                walks=0, aligned_probes=0, pred_correct=0, cycles=0,
                coverage_mean=0.0, ppn=np.full_like(r.ppn, -1),
                shootdowns=0) for r in rs]
        return S.SweepResult(results=rs, stats=res.stats)
    monkeypatch.setattr(S, "run_sweep", run_sweep)


@pytest.mark.parametrize("fault", ["answer", "half_batch",
                                   "state_unchanged"])
def test_sweep_fault_is_not_correct(monkeypatch, fault):
    _broken_sweep(monkeypatch, fault)
    cell = tiny.sweep_cell()
    cell.traffic["check_cells"] = 12          # every lane of the batch
    out = tiny.driver(cell).run(cell)
    assert not out.correct


def test_fill_profile_altered_in_the_program_is_not_correct(monkeypatch):
    """The program's packing with aligned fills that skip the contiguity
    clip (each covers its whole 2^k block): the reference, which works out
    each walk's fill itself, sees it."""
    from repro_torch.core import lane_program as LP
    real = LP._fill_profile

    def fill_profile(m, key, P):
        rec = real(m, key, P)
        if key[0] == "ka":
            ka = rec[:, 1] >= 0
            rec[ka, 2] = 1 << rec[ka, 1]
        return rec
    monkeypatch.setattr(LP, "_fill_profile", fill_profile)
    cell = tiny.sweep_cell(trace_len=3000)
    cell.traffic["check_cells"] = 12
    out = tiny.driver(cell).run(cell)
    assert not out.correct, out.checks
    assert next(c for c in out.checks
                if c["name"] == "oracle_mismatches")["value"] > 0


def test_sweep_control_is_not_correct(monkeypatch):
    """The control (the reference without Algorithm 1's contiguity scan)
    in the program's place, through the driver's window and checks."""
    from perfbench.controls import sweep_control as C
    from perfbench.harness import bench
    cell = tiny.sweep_cell(trace_len=3000)
    cell.traffic["check_cells"] = 12
    drv = tiny.driver(cell)
    out = drv.run(cell, sweep=C.control_sweep(cell, drv, C.unchecked_fill))
    assert isinstance(out, bench.Outcome)
    assert not out.correct, out.checks
