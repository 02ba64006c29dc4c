"""The PyTorch port's sweep, end to end, against the JAX package on the CPU.

``repro_torch.core.sweep.run_sweep(device="cpu")`` (the plain version of
the kernel) must equal ``repro.core.sweep.run_sweep(backend="xla")`` bit for
bit — tolerance 0 on every counter, ``coverage_mean`` and every translated
ppn — for the 11 specs of ``tests/test_backends.py`` (all 10 kinds) over a
static world, a dynamic world (both coherence policies), a multi-tenant
world (both context-switch policies), a nested world (both coherence
policies) and a parity-fault world (both fault policies).  Each cell is
its own test case.  Also: the card is never replaced by the CPU, the
port's cache never shares an entry with the JAX package's, and the
full-size fixtures ``chip_smoke.py`` holds the kernel to (Table 4, and the
scenario sections of W1 and W2) are the JAX package's output for the
rosters and worlds the port builds.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from _torch_helpers import (COUNTERS, WORLDS, convert_spec, dynamic_world,
                            multitenant_world, nested_world, parity_world,
                            pkg, static_world, world_cells)
from repro.core import simulator as jsim
from repro.core.sweep import SweepCell as JCell
from repro.core.sweep import cell_key as jax_cell_key
from repro.core.sweep import run_sweep as jax_run_sweep
from repro_torch.core.sweep import cell_key, run_sweep

# the plain version runs thousands of tiny ops: one intra-op thread is the
# fastest, and keeps six test workers from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REF_JSON = REPO / "tests" / "data" / "port_table4_reference.json"
J, T = pkg(jcore), pkg(tcore)
BUILD = {"static": static_world, "dynamic": dynamic_world,
         "multitenant": multitenant_world, "nested": nested_world,
         "parity": parity_world}
N_SPECS = 11
CASES = [(w, j) for w in WORLDS
         for j in range(N_SPECS * (1 if w == "static" else 2))]


@pytest.fixture(scope="module")
def results():
    """Every world's cells through both packages, one run_sweep each (the
    sweeps partition and chunk them into the same batches)."""
    tcells, jcells, index = [], [], {}
    for w in WORLDS:
        cells = world_cells(T, w)
        jm, jtr = BUILD[w](J)
        for j, c in enumerate(cells):
            index[(w, j)] = len(tcells)
            tcells.append(c)
            jcells.append(JCell(convert_spec(c.spec, jsim), jm, jtr))
    assert len(tcells) == len(CASES)
    want = jax_run_sweep(jcells, cache=False, backend="xla")
    got = run_sweep(tcells, cache=False, device="cpu")
    assert got.stats["n_batches"] == want.stats["n_batches"]
    return tcells, want.results, got.results, index


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_port_sweep_equals_jax(results, case):
    cells, want, got, index = results
    i = index[case]
    ctx = (case, cells[i].spec)
    for f in COUNTERS:
        assert getattr(got[i], f) == getattr(want[i], f), (ctx, f)
    assert got[i].name == want[i].name
    np.testing.assert_array_equal(got[i].ppn, want[i].ppn, err_msg=str(ctx))


def test_every_kind_and_policy_is_covered(results):
    cells = results[0]
    assert len({c.spec.kind for c in cells}) == len(jsim.KINDS) == 10
    for field, values in (("ctx_policy", {"flush", "tag"}),
                          ("coh_policy", {"shootdown", "hw-coherence"}),
                          ("par_policy", {"parity", "ecc"})):
        assert {getattr(c.spec, field) for c in cells} == values


def test_run_sweep_on_cuda_never_runs_on_the_cpu():
    cells = world_cells(T, "static")[:2]
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep(cells, cache=False)                 # device="cuda" default
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep(cells, cache=False, device="cuda")


def test_cache_roundtrip_and_separate_keys(tmp_path):
    cells = [dataclasses.replace(c, trace=c.trace[:120])
             for c in world_cells(T, "static")[:3]]
    first = run_sweep(cells, cache=True, cache_dir=str(tmp_path),
                      device="cpu")
    again = run_sweep(cells, cache=True, cache_dir=str(tmp_path),
                      device="cpu")
    assert first.stats["simulated"] == 3 and again.stats["cache_hits"] == 3
    for a, b in zip(first, again):
        for f in COUNTERS:
            assert getattr(a, f) == getattr(b, f)
        np.testing.assert_array_equal(a.ppn, b.ppn)
    m, tr = static_world(J)
    for c in cells:
        jc = JCell(convert_spec(c.spec, jsim), m, tr[:120])
        assert cell_key(c) != jax_cell_key(jc)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table4_fixture_matches_the_port_roster():
    """The 48 cells ``chip_smoke.py`` builds at full size are, in order,
    the cells the fixture records; each fixture row adds up."""
    cs = _chip_smoke()
    ref = json.loads(REF_JSON.read_text())
    assert (ref["n_pages"], ref["trace_len"]) == (cs.N_PAGES, cs.TRACE_LEN)
    specs = []
    for kind in cs.KINDS:
        m = tcore.synthetic_mapping(kind, cs.N_PAGES, seed=1)
        specs += [(kind, s) for s in cs.roster(m)]
    assert len(specs) == len(ref["cells"]) == 48
    for (kind, s), row in zip(specs, ref["cells"]):
        assert row["mapping"] == kind and row["name"] == s.name
        assert json.loads(json.dumps(dataclasses.asdict(s))) == row["spec"]
        assert (row["l1_hits"] + row["l2_regular_hits"]
                + row["l2_coalesced_hits"] + row["walks"]) == \
            row["accesses"] == cs.TRACE_LEN


def test_chip_smoke_bound_counts_what_the_run_needs():
    """``chip_smoke.bound`` charges each access the L1 probe at least and
    never more than every entry of every structure; the bound is the
    larger of its two times."""
    cs = _chip_smoke()
    cells = [dataclasses.replace(c, trace=c.trace[:200])
             for c in world_cells(T, "static")]
    res = run_sweep(cells, cache=False, device="cpu").results
    lanes, stacks, st0, sb = T.sweep.pack_batch(cells)
    rate = 1e13
    ms, by, n_bytes, n_ops, t_bytes, t_ops = cs.bound(
        lanes, stacks, st0, sb, res, rate)
    acc = sum(r.accesses for r in res)
    ways, ctlb_ways = st0["l2"].shape[2], st0["ctlb"].shape[2]
    maxk = lanes["kvals"].shape[1]
    every = 4 + 4 + 2 * ways + maxk * ways + 32 + 5 + ctlb_ways + ways + 32 + 4
    assert 3 * 4 * acc < n_ops < 3 * every * acc
    assert t_ops == pytest.approx(n_ops / rate * 1e3)
    assert ms == max(t_bytes, t_ops)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")
    assert n_bytes >= 4 * 2 * acc       # at least the trace and the ppns
    # the chain floor: the longest real lane's steps, one measured
    # shared-memory round each, at the SM clock
    floor_ms, steps = cs.chain_floor(lanes, 40.0, 2000.0)
    assert steps == max(r.accesses for r in res) == 200
    assert floor_ms == pytest.approx(200 * 40.0 / 2.0e9 * 1e3)
    lanes_pad = dict(lanes, t_real=np.r_[lanes["t_real"][:-1], 0])
    assert cs.chain_floor(lanes_pad, 40.0, 2000.0)[1] == 200


def _ptxas(frame=0, spill=0, drop=None):
    """A ``-Xptxas -v`` report of the TLB library as nvcc prints it: the
    four kernel templates (the last with the given stack frame and spill
    stores) and the round kernel; ``drop`` leaves one template out."""
    names = [f"_Z16tlb_sweep_kernelILb{w}ELb{g}EEv9SweepArgs"
             for w in (0, 1) for g in (0, 1) if (w, g) != drop]
    out = []
    for i, name in enumerate(names + ["_Z16tlb_round_kerneliPx"]):
        last = i == len(names) - 1
        out += [f"ptxas info    : Compiling entry function '{name}' for "
                "'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    {frame if last else 0} bytes stack frame, "
                f"{spill if last else 0} bytes spill stores, 0 bytes spill "
                "loads",
                f"ptxas info    : Used {140 + i} registers, used 0 barriers"
                + (", 16 bytes smem" if name.startswith("_Z16tlb_round")
                   else "")]
    return "\n".join(out) + "\n"


def test_chip_smoke_ptxas_check_fails_on_local_memory():
    """Phase 1 reads every TLB template from the ptxas report and fails on
    a stack frame or spills in any."""
    cs = _chip_smoke()
    funcs = cs.check_tlb_ptxas(_ptxas())
    assert sorted(f["registers"] for f in funcs.values()) == [140, 141,
                                                             142, 143]
    assert cs.ptxas_functions(_ptxas())["_Z16tlb_round_kerneliPx"][
        "smem"] == 16
    for frame, spill in ((16, 0), (0, 8)):
        with pytest.raises(ValueError, match="local memory"):
            cs.check_tlb_ptxas(_ptxas(frame, spill))
    with pytest.raises(ValueError, match="4 tlb_sweep_kernel templates"):
        cs.check_tlb_ptxas(_ptxas(drop=(1, 1)))


def test_chip_smoke_lane_spread_names_the_slowest_lane():
    cs = _chip_smoke()
    cells = world_cells(T, "static")[:3]
    spread = cs.lane_spread(np.array([300, 900, 600, 50]), cells,
                            ["a", "b", "c"], 1000.0)
    assert (spread["min_cycles"], spread["median_cycles"],
            spread["max_cycles"]) == (300, 600, 900)
    assert spread["max_ms"] == pytest.approx(900 / 1e6)
    assert spread["slowest_lane"] == 1 and spread["slowest_mapping"] == "b"
    assert spread["slowest_method"] == cells[1].spec.name
    assert spread["pad_lanes_max_cycles"] == 50
    n = cells[0].trace.shape[0]
    assert spread["cycles_per_access"] == {"base": pytest.approx(300 / n),
                                           "thp": pytest.approx(900 / n),
                                           "colt": pytest.approx(600 / n)}


def test_chip_smoke_pack_breakdown_adds_up_and_packs_the_same():
    """The packing split times the batch ``pack_batch`` gives and leaves
    the port's functions as they were."""
    from repro_torch.core import lane_program, sweep
    cs = _chip_smoke()
    cells = world_cells(T, "static")[:4]
    before = {n: getattr(lane_program, n) for n in
              ("_map_record", "_fill_profile", "_pad_stack",
               "cluster_bitmap")}
    (lanes, stacks, st0, sb), spent = cs.pack_breakdown(cells)
    want = sweep.pack_batch(cells)
    for got_d, want_d in zip((lanes, stacks, st0), want[:3]):
        assert got_d.keys() == want_d.keys()
        for k in got_d:
            np.testing.assert_array_equal(got_d[k], want_d[k], k)
    assert sb == want[3]
    assert {n: getattr(lane_program, n) for n in before} == before
    assert sweep.init_batched_state is lane_program.init_batched_state
    parts = [v for k, v in spent.items() if k != "total"]
    assert spent["total"] == pytest.approx(sum(parts))
    assert min(v for k, v in spent.items() if k != "rest") >= 0
    assert spent["_fill_profile"] > 0 and spent["_map_record"] > 0


@pytest.mark.slow
def test_table4_fixture_regenerates():
    """The JAX package still produces the committed fixture (about a
    minute of JAX on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "make_port_reference", REPO / "scripts" / "make_port_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh, _ = mod.reference()
    assert json.loads(json.dumps(fresh)) == json.loads(REF_JSON.read_text())


SCEN_JSON = REPO / "tests" / "data" / "port_scenario_reference.json"


def test_scenario_fixture_matches_the_port_roster():
    """The 274 cells ``chip_smoke.py`` W1 builds at bench size through the
    port's registry are, in order, the cells the scenario fixture records
    (section, ``run_sweep`` call, row, label, group, spec), its 20 worlds
    are the fixture's, and every fixture cell adds up."""
    cs = _chip_smoke()
    ref = json.loads(SCEN_JSON.read_text())
    assert (ref["max_pages"], ref["trace_len"]) == (cs.W1_MAX_PAGES,
                                                    cs.W1_TRACE_LEN)
    assert ref["seeds"] == cs.W1_SEEDS
    assert ref["anchor_grid"] == list(cs.ANCHOR_GRID)
    assert ref["sections"] == list(cs.W1_SECTIONS)
    runs, roster = cs.w1_roster()
    assert len(roster) == len(ref["cells"]) == 274
    assert roster == [(c["section"], c["run"], c["row"], c["label"],
                       c["group"], c["spec"]) for c in ref["cells"]]
    worlds = [dict(section=s, **cs.world_record(name, d))
              for s, rs in runs.items() for _, ws in rs for name, d in ws]
    assert worlds == ref["worlds"]
    for c in ref["cells"]:
        assert (c["l1_hits"] + c["l2_regular_hits"] + c["l2_coalesced_hits"]
                + c["walks"]) == c["accesses"] == cs.W1_TRACE_LEN
    suite = ref["standard_suite"]
    assert suite["scenario"] == cs.W2_WORLD
    assert len(suite["results"]) == 9
    from repro_torch.scenarios import clear_materialized_cache
    clear_materialized_cache()


@pytest.mark.slow
def test_scenario_fixture_regenerates():
    """The JAX package still produces the committed scenario fixture
    (about five minutes of JAX on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "make_port_scenario_reference",
        REPO / "scripts" / "make_port_scenario_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh, _ = mod.reference()
    assert json.loads(json.dumps(fresh)) == json.loads(SCEN_JSON.read_text())
