"""The port's pure-python segment oracle and ``core/aligned.py`` against the
JAX package's, on the CPU.

* every ``tests/goldens/*.json`` through the port's oracle equals the
  golden step by step (hit level, ppn, eviction, probes, cycles), event by
  event and in its final counters, as ``tests/test_goldens.py`` reads them;
* the fuzz twin of ``tests/test_fuzz_differential.py``: random dynamic,
  multi-tenant and nested worlds at its sizes and ``max_examples``, every
  kind under every policy of the world kind: port oracle == JAX oracle ==
  port ``run_sweep(device="cpu")``, counter for counter and ppn for ppn
  (its kernel leg is in ``tests/test_torch_cuda.py``);
* ``run_method_parity`` on the parity-fault world, both fault policies;
* ``aligned.simulate_reference`` (the fully-associative Algorithm 1-2
  reference) equals the reference's.

Tolerance 0 throughout.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro_torch.core as tcore
from _torch_helpers import (COUNTERS, FUZZ_KINDS, convert_spec, fuzz_cells,
                            oracle, pkg, world_cells)
from repro.core import aligned as jaligned
from repro.core import simulator as jsim
from repro_torch.core import aligned as taligned
from repro_torch.core import simulator as tsim
from repro_torch.core.page_table import (DynamicMapping, MultiTenantMapping,
                                         NestedMapping, make_mapping)
from repro_torch.core.sweep import run_sweep

torch.set_num_threads(1)

J, T = pkg(jcore), pkg(tcore)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
GOLDEN_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.json")))
STEP_FIELDS = ("t", "vpn", "asid", "level", "ppn", "walk", "evict",
               "probes", "cycles")


def _assert_same(got, want, ctx):
    for f in COUNTERS:
        assert getattr(got, f) == getattr(want, f), (ctx, f)
    assert got.name == want.name, ctx
    np.testing.assert_array_equal(got.ppn, want.ppn, err_msg=str(ctx))


# ---------------------------------------------------------------- goldens

def _layer(d, name):
    return DynamicMapping(
        tuple(make_mapping(np.asarray(p, np.int64), name=f"{name}e{e}")
              for e, p in enumerate(d["epochs"])),
        tuple(d["boundaries"]), name=name)


def _rebuild(g):
    """``tests/test_goldens.py::_rebuild`` over the port's classes."""
    spec = tsim.MethodSpec(**{**g["spec"], "K": tuple(g["spec"]["K"])})
    w = g["world"]
    if w["kind"] == "nested":
        world = NestedMapping(
            tuple(_layer(d, f"g{i}") for i, d in enumerate(w["guests"])),
            _layer(w["host"], "host"), tuple(w["boundaries"]),
            tuple(w["guest_ids"]), tuple(w["asids"]), name=g["name"])
        runner = tsim.run_method_nested
    elif w["kind"] == "multitenant":
        world = MultiTenantMapping(
            tuple(make_mapping(np.asarray(p, np.int64), name=f"t{i}")
                  for i, p in enumerate(w["tenants"])),
            tuple(w["boundaries"]), tuple(w["tenant_ids"]),
            tuple(w["asids"]), name=g["name"])
        runner = tsim.run_method_multitenant
    else:
        world = make_mapping(np.asarray(w["ppn"], np.int64), name=g["name"])
        runner = tsim.run_method_dynamic
    return spec, world, runner, np.asarray(g["trace"], np.int64)


def test_all_sixteen_goldens_are_read():
    assert len(GOLDEN_FILES) == 16


@pytest.mark.parametrize("path", GOLDEN_FILES,
                         ids=[os.path.basename(p)[:-5]
                              for p in GOLDEN_FILES])
def test_port_oracle_matches_golden_step_by_step(path):
    with open(path) as f:
        g = json.load(f)
    spec, world, runner, trace = _rebuild(g)
    steps, events = [], []
    r = runner(spec, world, trace, on_step=steps.append,
               on_event=events.append)
    assert len(steps) == len(g["steps"])
    for got, want in zip(steps, g["steps"]):
        for f in STEP_FIELDS:
            assert got[f] == want[f], (
                f"{g['name']}: step t={want['t']} field {f!r}: "
                f"got {got[f]!r}, golden {want[f]!r}")
    assert events == g["events"], f"{g['name']}: segment-entry events"
    for f, v in g["final"].items():
        assert getattr(r, f) == pytest.approx(v), (g["name"], f)


# ------------------------------------------------------------- fuzz twin

def _three_way(world_kind, seed):
    tcells = fuzz_cells(T, world_kind, seed)
    jcells = fuzz_cells(J, world_kind, seed)
    assert len(tcells) == len(jcells)
    if not tcells:
        return                       # degenerate draw: nothing mapped
    swept = run_sweep(tcells, cache=False, device="cpu").results
    for tc, jc, got in zip(tcells, jcells, swept):
        assert convert_spec(tc.spec, jsim) == jc.spec
        ctx = (world_kind, seed, tc.spec)
        want = oracle(jsim, jc)
        _assert_same(oracle(tsim, tc), want, ctx + ("port oracle",))
        _assert_same(got, want, ctx + ("port run_sweep",))


@pytest.mark.parametrize("world_kind", FUZZ_KINDS)
@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=4, deadline=None)
def test_fuzz_port_oracle_jax_oracle_port_sweep(world_kind, seed):
    """port oracle == JAX oracle == port run_sweep(device="cpu") for every
    kind under every policy of the world kind, random worlds."""
    _three_way(world_kind, seed)


@pytest.mark.parametrize("world_kind", FUZZ_KINDS)
def test_fuzz_twin_covers_every_kind_and_policy(world_kind):
    """Every example of the fuzz twin compares all 10 kinds under every
    value of the world kind's policy knobs."""
    cells = fuzz_cells(T, world_kind, 1)
    assert len({c.spec.kind for c in cells}) == len(tsim.KINDS)
    knobs = {"dynamic": ("coh_policy",), "multitenant": ("ctx_policy",),
             "nested": ("ctx_policy", "coh_policy")}[world_kind]
    for knob in knobs:
        assert len({getattr(c.spec, knob) for c in cells}) == 2
    assert len(cells) == 11 * 2 ** len(knobs)     # all_kinds: 11 specs


def test_parity_oracle_equals_jax():
    """``run_method_parity`` of both packages over the parity-fault world,
    every kind under both fault policies."""
    tcells, jcells = world_cells(T, "parity"), world_cells(J, "parity")
    for tc, jc in zip(tcells, jcells):
        _assert_same(oracle(tsim, tc), oracle(jsim, jc), tc.spec)


# --------------------------------------------------------------- aligned

@pytest.mark.parametrize("kind,K", [("small", (4,)), ("medium", (8, 6)),
                                    ("large", (10, 9, 6)),
                                    ("mixed", (9, 6, 4)),
                                    ("demand", (9, 8, 4, 2))])
def test_simulate_reference_equals_jax(kind, K):
    def world(p):
        if kind == "demand":
            m = p.mappings.demand_mapping(1 << 12, seed=5)
        else:
            m = p.mappings.synthetic_mapping(kind, 1 << 12, seed=1)
        tr = p.traces.generate_trace("multiscale", 0, 3000, seed=2,
                                     mapping=m)
        return m, tr
    (tm, ttr), (jm, jtr) = world(T), world(J)
    np.testing.assert_array_equal(ttr, jtr)
    for cap in (64, 1024):
        got = taligned.simulate_reference(tm, ttr.tolist(), K, capacity=cap)
        want = jaligned.simulate_reference(jm, jtr.tolist(), K,
                                           capacity=cap)
        assert got == want, (kind, K, cap)
