"""The plain reference against the program at a tiny size on the CPU: what
a walk installs against the program's fill records, every lane against
the program's own host oracle, and a whole tiny run against ``run_sweep``'s
plain version."""
import numpy as np
import pytest

from perfbench.tests import tiny
from perfbench.tlbref import reference as REF, specs as fspecs, worlds


def _program(obj):
    """A frozen-copy mapping or spec as the program's."""
    from repro_torch.core import page_table, simulator
    return tiny.driver(tiny.sweep_cell()).to_program(
        obj, (page_table, simulator))


@pytest.mark.parametrize("kind", worlds.SYNTH_KINDS)
def test_walk_fill_equals_the_programs_fill_records(kind):
    from repro_torch.core import lane_program as LP
    w = worlds.build_world(f"synth-{kind}", 1 << 13, 10, 7, 8)
    pt = REF.PageTable(w.mapping.ppn)
    m = _program(w.mapping)
    mapped = np.flatnonzero(w.mapping.ppn >= 0)
    for spec, _, _ in fspecs.suite_specs(w.histogram, (4, 6, 8, 10),
                                         (2, 3, 4)):
        rec = LP._fill_profile(m, LP._fill_profile_key(_program(spec)),
                               m.n_pages)
        for v in mapped:
            assert REF.walk_fill(spec, pt, int(v)) == tuple(
                int(x) for x in rec[v, :4]), (spec.name, v)


@pytest.mark.parametrize("kind", worlds.SYNTH_KINDS)
def test_reference_equals_the_programs_oracle(kind):
    from repro_torch.core import simulator
    w = worlds.build_world(f"synth-{kind}", 1 << 14, 1500, 3, 4)
    m = _program(w.mapping)
    for spec, _, _ in fspecs.suite_specs(w.histogram, (4, 6, 8, 10),
                                         (2, 3, 4)):
        want = REF.summary(simulator.run_method_dynamic(
            _program(spec), m, w.trace))
        assert REF.simulate(spec, w.mapping.ppn, w.trace) == want, spec.name


def test_tiny_sweep_runs_correct_against_the_reference():
    cell = tiny.sweep_cell(worlds=("synth-small", "synth-large"))
    out = tiny.driver(cell).run(cell)
    assert out.correct, out.checks
    assert {c["name"] for c in out.checks} >= {"oracle_mismatches",
                                               "repeat_mismatches"}
    assert out.end_to_end["sweep_accesses_per_s"] > 0
