"""The port's scenario registry and the W1 sections of ``chip_smoke.py``
against the JAX package, on the CPU.

* the registry: the same 42 scenarios in the same seven families, with
  the reference's descriptions and contiguity signatures;
* every scenario materialized small (2^12 pages, 2,000 accesses; the
  builders clamp to their own minimums) gives the same trace, mapping
  arrays, world structure (epochs, boundaries, events, tenants, schedule,
  guests, host, the nested union grid) and ``meta`` in both packages —
  one case per scenario;
* each W1 section built by ``chip_smoke.py``'s roster helpers at a small
  size has the specs, rows, labels and groups of the ``SweepPlan`` that
  ``benchmarks/tlb_suite.py::_add_suite`` (and ``bench_accelerator``)
  builds, and the port's ``run_sweep(device="cpu")`` over it equals the
  JAX oracle on the JAX plan's cells, cell by cell; the derived rows
  ``chip_smoke.section_rows`` prints equal the rows of the section's bench
  function over the same results.

Tolerance 0 throughout.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.scenarios as jscen
import repro_torch.scenarios as tscen
from _torch_helpers import COUNTERS, oracle
from repro.core import simulator as jsim
from repro_torch.core.sweep import run_sweep

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAMES = [sc.name for sc in jscen.list_scenarios()]
SMALL = dict(n_pages=1 << 12, trace_len=2000)
# the W1 sections at a size the CPU runs in seconds
SECTION_PAGES, SECTION_TRACE = 1 << 12, 400


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load("chip_smoke", REPO / "chip_smoke.py")
MK = _load("make_port_scenario_reference",
           REPO / "scripts" / "make_port_scenario_reference.py")


def _same(a, b, path="data"):
    """Deep equality across the two packages: dataclasses by class name
    and public fields, arrays by value, containers element by element."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def test_registry_equals_the_reference():
    """Names, families, descriptions and contiguity signatures; the two
    descriptions naming JAX-package modules name them without the
    package prefix in the port."""
    assert [sc.name for sc in tscen.list_scenarios()] == NAMES
    assert len(NAMES) == 42
    assert tscen.FAMILIES == jscen.FAMILIES
    for fam, n in (("workload", 5), ("adversarial", 3), ("dynamic", 3),
                   ("multitenant", 3), ("nested", 3), ("accelerator", 3),
                   ("synthetic", 22)):
        assert len(tscen.list_scenarios(fam)) == n, fam
    renamed = 0
    for name in NAMES:
        j, t = jscen.get_scenario(name), tscen.get_scenario(name)
        assert (t.family, t.contiguity) == (j.family, j.contiguity), name
        assert t.description == j.description.replace("repro.", ""), name
        renamed += t.description != j.description
    assert renamed == 2


@pytest.mark.parametrize("name", NAMES)
def test_scenario_materializes_as_in_the_reference(name):
    want = jscen.get_scenario(name).materialize(**SMALL)
    got = tscen.get_scenario(name).materialize(**SMALL)
    _same(got.trace, want.trace, "trace")
    _same(got.mapping, want.mapping, "mapping")
    _same(got.world, want.world, "world")
    if type(got.world).__name__ == "NestedMapping":
        _same(got.world.plan_segments(), want.world.plan_segments(),
              "union grid")
    _same(got.meta, want.meta, "meta")
    assert got.scenario == want.scenario == name


# ---------------------------------------------------------- W1 sections

def _rows(section, jax_results):
    """The section's bench function over the given results: its
    ``SweepPlan.run`` is handed them in place of a JAX sweep."""
    ts = MK.ts
    bench = {"scenarios": ts.bench_scenarios, "dynamic": ts.bench_dynamic,
             "multitenant": ts.bench_multitenant,
             "nested": ts.bench_nested,
             "accelerator": ts.bench_accelerator}[section]

    def fake_run_sweep(cells, **_):
        return type("Sweep", (), {"results": [
            jax_results[(id(c.mapping), id(c.trace), c.spec)]
            for c in cells]})
    real, ts.run_sweep = ts.run_sweep, fake_run_sweep
    try:
        kw = dict(quick=False) if section == "scenarios" else {}
        return bench(trace_len=SECTION_TRACE, max_pages=SECTION_PAGES, **kw)
    finally:
        ts.run_sweep = real


@pytest.mark.parametrize("section", list(CS.W1_SECTIONS))
def test_w1_section_at_small_size_equals_the_jax_oracle(section):
    truns = CS.w1_runs(section, SECTION_PAGES, SECTION_TRACE)
    jruns = MK.section_runs(section, SECTION_PAGES, SECTION_TRACE)
    assert len(truns) == len(jruns) >= 1
    jax_results, cols = {}, {}
    for (tplan, tworlds), (jplan, jworlds) in zip(truns, jruns):
        assert tplan.tags == jplan.tags
        assert [n for n, _ in tworlds] == [n for n, _ in jworlds]
        for (name, td), (_, jd) in zip(tworlds, jworlds):
            assert CS.world_record(name, td) == MK.world_record(name, jd)
        got = run_sweep(tplan.cells, cache=False, device="cpu").results
        for tc, jc, tag, r in zip(tplan.cells, jplan.cells, jplan.tags, got):
            assert json.loads(json.dumps(dataclasses.asdict(tc.spec))) == \
                json.loads(json.dumps(dataclasses.asdict(jc.spec)))
            want = oracle(jsim, jc)
            jax_results[(id(jc.mapping), id(jc.trace), jc.spec)] = want
            for f in COUNTERS:
                assert getattr(r, f) == getattr(want, f), (tag, f)
            assert r.name == want.name
            np.testing.assert_array_equal(r.ppn, want.ppn, err_msg=str(tag))
            np.testing.assert_array_equal(
                r.ppn, CS.world_translations(tc.mapping, tc.trace))
        cols.update(tplan.reduce(got))
    assert CS.section_rows(section, cols) == _rows(section, jax_results)


def test_check_against_record_names_the_field():
    m = tscen.get_scenario("adv-numa").materialize(n_pages=1 << 10,
                                                   trace_len=300)
    from repro_torch.core import baselines as b
    r = b.anchor_static(m.mapping, m.trace, grid=(4, 6), device="cpu")
    rec = dict(name=r.name, **{f: getattr(r, f) for f in CS.CELL_FIELDS},
               coverage_mean=r.coverage_mean,
               ppn_sha256=CS.ppn_digest(r.ppn))
    CS.check_against_record(r, rec, "cell")
    for field, value in (("walks", r.walks + 1), ("name", "x"),
                         ("coverage_mean", r.coverage_mean + 1),
                         ("ppn_sha256", "0" * 64)):
        with pytest.raises(ValueError, match="cell"):
            CS.check_against_record(r, dict(rec, **{field: value}), "cell")
