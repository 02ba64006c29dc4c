"""The port's per-call entry points against the JAX package's, on the CPU.

``run_method`` (one lane of ``run_sweep``), ``anchor_static`` and
``standard_suite`` (all their cells in one ``run_sweep``) with
``device="cpu"`` return what the JAX functions return — names, every
counter, ``coverage_mean`` and every translated ppn, tolerance 0 — on a
``demand_mapping(1 << 12)`` with 2,000 multiscale accesses: ``run_method``
for every kind (the 11 specs of ``tests/test_backends.py``), the other two
over the default anchor grid.  On ``"cuda"`` without a card they raise.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from _torch_helpers import COUNTERS, all_kinds, convert_spec, pkg
from repro.core import baselines as jb
from repro.core import simulator as jsim

torch.set_num_threads(1)

J, T = pkg(jcore), pkg(tcore)
N_KINDS = 11


def _world(p):
    m = p.mappings.demand_mapping(1 << 12, seed=3)
    tr = p.traces.generate_trace("multiscale", 0, 2000, seed=4, mapping=m)
    return m, tr


def _assert_same(got, want, ctx):
    assert got.name == want.name, ctx
    for f in COUNTERS:
        assert getattr(got, f) == getattr(want, f), (ctx, f)
    np.testing.assert_array_equal(got.ppn, want.ppn, err_msg=str(ctx))


@pytest.fixture(scope="module")
def worlds():
    (tm, ttr), (jm, jtr) = _world(T), _world(J)
    np.testing.assert_array_equal(ttr, jtr)
    return (tm, ttr), (jm, jtr)


@pytest.mark.parametrize("i", range(N_KINDS))
def test_run_method_equals_jax(worlds, i):
    (tm, ttr), (jm, jtr) = worlds
    spec = all_kinds(T)[i]
    got = tcore.run_method(spec, tm, ttr, device="cpu")
    want = jsim.run_method(convert_spec(spec, jsim), jm, jtr)
    _assert_same(got, want, spec)


def test_every_kind_runs_through_run_method():
    assert len({s.kind for s in all_kinds(T)}) == len(tcore.simulator.KINDS)
    assert len(all_kinds(T)) == N_KINDS


def test_standard_suite_and_anchor_static_equal_jax(worlds):
    """The 18 runs of the suite in one sweep, and the anchor grid alone:
    the same results, names and order as the JAX functions."""
    (tm, ttr), (jm, jtr) = worlds
    got = tcore.standard_suite(tm, ttr, device="cpu")
    want = jb.standard_suite(jm, jtr)
    assert [r.name for r in got] == [r.name for r in want]
    assert len(got) == 9 and got[5].name.startswith("Anchor-Static(best d=")
    for g, w in zip(got, want):
        _assert_same(g, w, w.name)
    a = tcore.anchor_static(tm, ttr, grid=(11, 3, 7), device="cpu")
    _assert_same(a, jb.anchor_static(jm, jtr, grid=(11, 3, 7)),
                 "anchor_static")
    assert tcore.ANCHOR_GRID == jb.ANCHOR_GRID


def test_anchor_static_keeps_the_first_of_tied_distances():
    """The reference's tie rule: the first ``d`` with the fewest walks.  A
    trace of one page repeated walks once under every anchor distance."""
    m = tcore.demand_mapping(1 << 10, seed=1)
    tr = np.full(40, np.flatnonzero(np.asarray(m.ppn) >= 0)[5])
    r = tcore.anchor_static(m, tr, grid=(7, 5, 9), device="cpu")
    assert r.walks == 1
    assert r.name == "Anchor-Static(best d=2^7)"


def test_entry_points_on_cuda_never_run_on_the_cpu(worlds):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    (tm, ttr), _ = worlds
    spec = tcore.base_spec()
    for call in (lambda: tcore.run_method(spec, tm, ttr[:50]),
                 lambda: tcore.run_method(spec, tm, ttr[:50],
                                          device="cuda"),
                 lambda: tcore.anchor_static(tm, ttr[:50], grid=(4,)),
                 lambda: tcore.standard_suite(tm, ttr[:50], psis=(2,),
                                              device="cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
