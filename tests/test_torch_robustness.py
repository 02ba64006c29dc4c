"""The port's robustness harness against the JAX package's, on the CPU.

Every injected fault is either recovered exactly or fails loudly, as
``tests/test_robustness.py`` holds the JAX package to, at its sizes
(worlds of 2^9-2^10 pages, a few hundred accesses, the reduced
InternLM2-1.8B engine), with the port on ``device="cpu"``:

* **plans and parity worlds** — ``FaultPlan.generate`` and
  ``make_parity_world`` equal the JAX package's event for event;
* **tlb-parity** — the port's sweep on parity worlds equals the JAX
  ``run_sweep(backend="xla")`` counter for counter under both policies,
  ``ecc`` equals fault-free, detect-invalidate-rewalk shows the blast
  radius, the fault schedule is part of ``cell_key``;
* **the recovery ladder** — an injected launch failure recovers by
  bisection, a cursed cell reaches the oracle, and a real launch failure,
  a shape refusal or a build failure is never absorbed;
* **the engine** — snapshot/restore, KV quarantine and page loss are
  token-exact against the fault-free run, a stall raises; the chaos
  bench's serve rows equal the JAX engine's outputs and report counts in
  ``tests/data/port_chaos_reference.json``;
* **chip_smoke's phase R helpers** and the package's independence of JAX.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.robustness as jrob
import repro_torch.core as tcore
import repro_torch.robustness as trob
from _torch_helpers import (COUNTERS, convert_spec, dynamic_world, pkg,
                            static_world)
from repro.core.sweep import SweepCell as JSweepCell
from repro.core.sweep import run_sweep as jrun_sweep
from repro_torch.core import sweep as tsweep
from repro_torch.core.simulator import run_method_dynamic, run_method_parity
from repro_torch.core.sweep import SweepCell, cell_key, run_sweep
from repro_torch.robustness import (BackendFault, EngineCrash, FaultPlan,
                                    KVCorruption, PageLoss, RecoveryError,
                                    backend_fault_injection,
                                    corrupt_cache_entry, make_parity_world,
                                    retry_with_backoff,
                                    run_engine_with_recovery)
from repro_torch.robustness import chaos

REPO = Path(__file__).resolve().parents[1]
CHAOS_REF = REPO / "tests" / "data" / "port_chaos_reference.json"
P, J = pkg(tcore), pkg(jcore)
CPU = torch.device("cpu")


SPECS = [tcore.base_spec(), tcore.colt_spec(), tcore.cluster_spec(),
         tcore.kaligned_spec([6, 4, 2])]


def _assert_equal(got, want, ctx):
    for f in COUNTERS:
        assert getattr(got, f) == getattr(want, f), (ctx, f)
    np.testing.assert_array_equal(got.ppn, want.ppn, err_msg=str(ctx))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Plans and parity worlds: equal to the JAX package's for the same seed
# ---------------------------------------------------------------------------

KIND_SETS = (("engine-crash", "kv-corruption"),
             ("engine-crash", "kv-corruption", "page-loss"),
             ("tlb-parity", "backend-failure", "cache-corruption"),
             tuple(jrob.FAULT_KINDS))


def _events(plan, device_name):
    """``(class name, fields)`` of each event; a ``BackendFailure``'s
    default backend (the reference's ``"pallas"``, the port's ``"cuda"``)
    is checked and left out."""
    out = []
    for e in plan.events:
        f = dataclasses.asdict(e)
        if "backends" in f:
            assert f.pop("backends") == (device_name,)
        out.append((type(e).__name__, f))
    return out


@pytest.mark.parametrize("kinds", KIND_SETS)
@pytest.mark.parametrize("seed", (0, 3, 1908))
def test_fault_plan_equals_jax(seed, kinds):
    want = jrob.FaultPlan.generate(seed, kinds=kinds, max_step=6)
    got = FaultPlan.generate(seed, kinds=kinds, max_step=6)
    assert _events(got, "cuda") == _events(want, "pallas")
    assert got.kinds() == want.kinds()
    assert got == FaultPlan.generate(seed, kinds=kinds, max_step=6)
    assert all(e.step >= 1 for e in got.events if hasattr(e, "step"))


def _parity_world(p, mk, world, seed, n_faults):
    m, tr = static_world(p) if world == "static" else dynamic_world(p)
    return mk(m, tr, seed=seed, n_faults=n_faults), tr


@pytest.mark.parametrize("world,seed,n_faults", [
    ("static", 5, 3), ("static", 17, 1), ("dynamic", 6, 2),
    ("dynamic", 1908, 3)])
def test_make_parity_world_equals_jax(world, seed, n_faults):
    got, _ = _parity_world(P, make_parity_world, world, seed, n_faults)
    want, _ = _parity_world(J, jrob.make_parity_world, world, seed,
                            n_faults)
    assert got.faults == want.faults and len(got.faults) >= 1
    assert got.base_boundaries() == want.base_boundaries()


# ---------------------------------------------------------------------------
# tlb-parity: the paper-grounded soft-error fault
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity_worlds():
    """A parity world over a static and over a dynamic base, built by both
    packages from the same seeds: ``[(port world, JAX world, trace)]``."""
    out = []
    for world, seed, n in (("static", 5, 3), ("dynamic", 6, 2)):
        pw, tr = _parity_world(P, make_parity_world, world, seed, n)
        jw, _ = _parity_world(J, jrob.make_parity_world, world, seed, n)
        out.append((pw, jw, tr))
    return out


@pytest.mark.parametrize("par", ("parity", "ecc"))
def test_parity_sweep_matches_jax(parity_worlds, par):
    cells, jcells = [], []
    for pw, jw, tr in parity_worlds:
        for s in SPECS:
            sp = dataclasses.replace(s, par_policy=par)
            cells.append(SweepCell(sp, pw, tr))
            jcells.append(JSweepCell(convert_spec(sp, J.simulator), jw, tr))
    got = run_sweep(cells, cache=False, device="cpu")
    want = jrun_sweep(jcells, cache=False, backend="xla")
    for c, g, w in zip(cells, got, want):
        _assert_equal(g, w, (c.spec.name, par))
    assert got.stats["bisections"] == got.stats["oracle_fallbacks"] == 0


def test_ecc_is_fault_free(parity_worlds):
    for pw, _, tr in parity_worlds:
        for s in SPECS:
            ecc = run_method_parity(
                dataclasses.replace(s, par_policy="ecc"), pw, tr)
            _assert_equal(ecc, run_method_dynamic(s, pw.base, tr),
                          ("ecc-vs-fault-free", s.name))


def test_parity_blast_radius(parity_worlds):
    """Detect-invalidate-rewalk costs real invalidations: more shootdowns
    than ECC, never fewer walks, and every access completes."""
    pw, _, tr = parity_worlds[0]
    cells = [SweepCell(dataclasses.replace(s, par_policy=par), pw, tr)
             for s in SPECS for par in ("parity", "ecc")]
    res = run_sweep(cells, cache=False, device="cpu")
    for i, s in enumerate(SPECS):
        flip, ecc = res[2 * i], res[2 * i + 1]
        assert flip.shootdowns > ecc.shootdowns, s.name
        assert flip.walks >= ecc.walks, s.name
        assert flip.accesses == ecc.accesses == tr.shape[0]


def test_parity_fault_schedule_in_cache_key(parity_worlds):
    pw, _, tr = parity_worlds[0]
    s = SPECS[0]
    other = tcore.page_table.ParityWorld(base=pw.base, faults=pw.faults[:-1])
    keys = {cell_key(SweepCell(s, w, tr)) for w in (pw, other, pw.base)}
    assert len(keys) == 3


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_fuzz_parity_recovers_or_fails_loudly(seed):
    """Any (fault plan, world) recovers exactly (ecc == fault-free, the
    batched sweep == the oracle) or raises: never a silent divergence."""
    rng = np.random.default_rng(seed)
    m = tcore.demand_mapping(1 << 9, seed=seed % 97)
    tr = tcore.generate_trace("multiscale", 0, 256, seed=seed % 89,
                              mapping=m)
    pw = make_parity_world(m, tr, seed=seed, n_faults=int(rng.integers(1, 4)))
    spec = SPECS[seed % len(SPECS)]
    want = run_method_parity(spec, pw, tr)
    got = run_sweep([SweepCell(spec, pw, tr)], cache=False, device="cpu")[0]
    _assert_equal(got, want, ("fuzz", seed, spec.name))
    ecc = run_method_parity(
        dataclasses.replace(spec, par_policy="ecc"), pw, tr)
    _assert_equal(ecc, run_method_dynamic(spec, m, tr),
                  ("fuzz-ecc", seed, spec.name))


# ---------------------------------------------------------------------------
# The recovery ladder: bisection, oracle, and what it must not absorb
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_cells():
    m = tcore.demand_mapping(1 << 9, seed=7)
    tr = tcore.generate_trace("multiscale", 0, 300, seed=9, mapping=m)
    cells = [SweepCell(s, m, tr) for s in SPECS]
    clean = run_sweep(cells, cache=False, device="cpu")
    return cells, clean


def test_one_injected_failure_recovers_by_bisection(sweep_cells):
    cells, clean = sweep_cells
    with pytest.warns(RuntimeWarning, match="BackendFault.*bisecting"):
        with backend_fault_injection(n_failures=1, backends=("cpu",)) as st_:
            res = run_sweep(cells, cache=False, device="cpu")
    assert st_["injected"] == 1
    assert res.stats["bisections"] == 1
    assert res.stats["oracle_fallbacks"] == 0
    for got, want in zip(res, clean):
        _assert_equal(got, want, "bisection")


def test_cursed_cell_reaches_the_oracle(sweep_cells):
    cells, clean = sweep_cells
    cursed = cells[2]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with backend_fault_injection(
                n_failures=10_000, backends=("cpu",),
                predicate=lambda sub, bk: any(c is cursed for c in sub)):
            res = run_sweep(cells, cache=False, device="cpu")
    assert res.stats["bisections"] >= 1
    assert res.stats["oracle_fallbacks"] == 1
    assert any("pure-python oracle" in str(w.message) for w in caught)
    for got, want in zip(res, clean):
        _assert_equal(got, want, "bisect-oracle")


def test_the_default_injection_spares_the_cpu(sweep_cells):
    """``backend_fault_injection`` fails batches on the card by default: a
    CPU sweep under it takes no rung."""
    cells, _ = sweep_cells
    with backend_fault_injection(n_failures=1) as st_:
        res = run_sweep(cells, cache=False, device="cpu")
    assert st_["injected"] == 0 and res.stats["bisections"] == 0


def test_run_batch_alone_raises_backend_fault(sweep_cells):
    cells, _ = sweep_cells
    with backend_fault_injection(n_failures=1, backends=("cpu",)) as st_:
        with pytest.raises(BackendFault):
            tsweep._run_batch(list(cells), CPU)
    assert st_["injected"] == 1


def test_a_launch_failure_raises_through_run_sweep(sweep_cells,
                                                   monkeypatch):
    """A real launch failure is no injected fault: it raises out of
    ``run_sweep`` at the first batch, and no cell moves to the oracle."""
    cells, _ = sweep_cells
    calls = []

    def failing(sub, device, fstats=None):
        calls.append(len(sub))
        raise RuntimeError("tlb_sweep kernel launch failed: "
                           "too many resources requested for launch")

    monkeypatch.setattr(tsweep, "_run_batch", failing)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no rung may warn
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            run_sweep(cells, cache=False, device="cpu")
    assert calls == [len(cells)]


@pytest.mark.parametrize("exc", [
    ValueError("tlb_sweep: at most 16 alignment classes"),
    RuntimeError("nvcc failed to build the tlb_sweep library")],
    ids=["shape-refusal", "build-failure"])
def test_the_ladder_absorbs_no_refusal_and_no_build_failure(
        sweep_cells, monkeypatch, exc):
    cells, _ = sweep_cells
    calls = []

    def broken(sub, device, fstats=None):
        calls.append(len(sub))
        raise exc

    monkeypatch.setattr(tsweep, "_run_batch", broken)
    with pytest.raises(type(exc), match=str(exc)):
        run_sweep(cells, cache=False, device="cpu")
    assert calls == [len(cells)]            # no bisection, no oracle


def test_a_build_failure_raises_before_the_ladder(sweep_cells, monkeypatch):
    """On the card ``run_sweep`` loads the kernel before its batch loop, so
    a failed build raises out of ``run_sweep`` untouched."""
    from repro_torch.kernels.tlb_sweep import _build
    cells, _ = sweep_cells

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(tsweep, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        run_sweep(cells, cache=False, device="cuda")


def test_cache_corruption_quarantined_and_recomputed(tmp_path, sweep_cells):
    cells, clean = sweep_cells
    cdir = str(tmp_path / "sweep_cache")
    first = run_sweep(cells, cache=True, cache_dir=cdir, device="cpu")
    assert first.stats["simulated"] == len(cells)
    assert first.stats["cache_quarantined"] == 0
    entries = sorted(p for p in os.listdir(cdir) if p.endswith(".npz"))
    assert len(entries) == len(cells)
    for mode, entry in zip(("truncate", "garbage", "schema"), entries):
        corrupt_cache_entry(os.path.join(cdir, entry), mode)
    again = run_sweep(cells, cache=True, cache_dir=cdir, device="cpu")
    assert again.stats["cache_quarantined"] == 3
    assert again.stats["cache_hits"] == len(cells) - 3
    assert again.stats["simulated"] == 3
    assert sum(p.endswith(".quarantined") for p in os.listdir(cdir)) == 3
    for got, want in zip(again, clean):
        _assert_equal(got, want, "cache-quarantine")
    third = run_sweep(cells, cache=True, cache_dir=cdir, device="cpu")
    assert third.stats["cache_hits"] == len(cells)
    assert third.stats["cache_quarantined"] == 0


def test_bench_chaos_recovers_every_row():
    """The chaos bench at a small size on the CPU: every fault kind has a
    ``recovered`` row and only those."""
    with pytest.warns(RuntimeWarning, match="run_sweep: BackendFault"):
        rows = chaos.bench_chaos(trace_len=300, max_pages=1 << 9,
                                 device="cpu")
    assert {r["fault"] for r in rows} == set(trob.FAULT_KINDS)
    assert [r["status"] for r in rows] == ["recovered"] * len(rows)
    cells = [r["cell"] for r in rows if r["fault"] == "backend-failure"]
    assert cells == ["kernel failure -> bisection", "bisect to oracle"]
    assert sum(r["fault"] == "tlb-parity" for r in rows) == 6


# ---------------------------------------------------------------------------
# Serving engine: crash-restart, quarantine, stalls
# ---------------------------------------------------------------------------

def test_retry_with_backoff():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 42

    slept = []
    assert retry_with_backoff(flaky, retries=3, base_delay=0.5,
                              retry_on=(OSError,),
                              sleep=slept.append) == 42
    assert len(calls) == 3 and slept == [0.5, 1.0]
    with pytest.raises(ValueError):
        retry_with_backoff(lambda: (_ for _ in ()).throw(ValueError()),
                           retries=1, retry_on=(ValueError,))


@pytest.fixture(scope="module")
def tiny():
    """The chaos bench's tiny engine (reduced InternLM2-1.8B, f32) on the
    CPU, its requests, and its serve runs (fault-free and the three
    plans)."""
    import tempfile
    make_engine, cfg = chaos.tiny_engine_factory("cpu")
    reqs = chaos.serve_requests(cfg.vocab)
    with tempfile.TemporaryDirectory() as root:
        runs = chaos.serve_runs(make_engine, reqs, chaos.serve_plans(), root)
    return make_engine, cfg, reqs, runs


@pytest.mark.parametrize("kind", ["baseline", "engine-crash",
                                  "kv-corruption", "page-loss"])
def test_serve_runs_equal_the_jax_engine(tiny, kind):
    """The chaos bench's serve rows against the JAX engine's on the same
    weights (the fixture): tokens and report counts."""
    ref = json.loads(CHAOS_REF.read_text())["serve"]
    _, _, reqs, runs = tiny
    assert [[list(p), n] for p, n in reqs] == ref["requests"]
    got, want = runs[kind], ref["runs"][kind]
    assert [got["outputs"][r] for r in sorted(got["outputs"])] \
        == want["outputs"]
    assert {k: got["report"][k] for k in want["report"]} == want["report"]
    assert got["report"]["metrics"]["kv_quarantined_pages"] \
        == want["kv_quarantined_pages"]
    assert got["outputs"] == runs["baseline"]["outputs"]


def test_serve_rows_all_recovered(tiny):
    rows = chaos.serve_rows(tiny[3])
    assert [(r["fault"], r["status"]) for r in rows] == [
        ("engine-crash", "recovered"), ("kv-corruption", "recovered"),
        ("page-loss", "recovered")]


def test_snapshot_restore_token_exact(tiny, tmp_path):
    """Crash-restart mid-serve: a FRESH engine restoring the checkpoint
    finishes with the uninterrupted run's tokens, its state tensors
    restored in place."""
    make_engine, _, reqs, runs = tiny
    eng = make_engine()
    for prompt, max_new in reqs:
        eng.add_request(prompt, max_new_tokens=max_new)
    eng.step()
    eng.step()
    ck = str(tmp_path / "ck")
    assert eng.snapshot(ck) == 2
    saved = {k: v.clone() for k, v in eng.state["pos0"].items()}
    del eng
    eng2 = make_engine()
    pools = {k: v.data_ptr() for k, v in eng2.state["pos0"].items()}
    assert eng2.restore(ck) == 2
    for k, v in eng2.state["pos0"].items():
        assert v.data_ptr() == pools[k]       # copied into, not replaced
        assert torch.equal(v, saved[k])
    m = eng2.run_to_completion()
    assert m["stalled"] == 0
    got = {rid: list(r.generated) for rid, r in eng2.requests.items()}
    assert got == runs["baseline"]["outputs"]


def test_restore_refuses_another_engine_shape(tiny, tmp_path):
    """A checkpoint of another pool size is refused, not broadcast or
    cast into the engine's tensors."""
    from repro_torch.serve import EngineConfig, ServingEngine
    make_engine, _, _, _ = tiny
    eng = make_engine()
    eng.snapshot(str(tmp_path))
    other = ServingEngine(eng.model, eng.params, EngineConfig(
        **dict(chaos.SERVE_ENGINE, num_pages=128)), device="cpu")
    with pytest.raises(ValueError, match="pool_k"):
        other.restore(str(tmp_path))


def test_snapshot_restore_recurrent_state(tmp_path):
    """A hybrid model's engine restores its per-slot recurrent state (and
    its pools) and finishes token-exactly."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.serve import EngineConfig, ServingEngine
    model = Model(get_config("jamba-1.5-large-398b", reduced=True),
                  RunConfig(compute_dtype="float32", scan_chunk=16))
    params = params_from_numpy(model.init_numpy(0), "cpu")
    ec = EngineConfig(page_size=8, num_pages=64, max_batch=2, max_seq=64)
    rng = np.random.default_rng(3)
    reqs = [([int(t) for t in rng.integers(0, model.cfg.vocab, size=n)], 4)
            for n in (9, 14, 11)]

    def engine():
        eng = ServingEngine(model, params, ec, device="cpu")
        for p, n in reqs:
            eng.add_request(p, max_new_tokens=n)
        return eng

    straight = engine()
    straight.run_to_completion()
    eng = engine()
    eng.step()
    eng.step()
    eng.snapshot(str(tmp_path))
    rec = [k for k, v in eng.state.items() if "pool_k" not in v]
    assert rec, "the hybrid model keeps recurrent state"
    fresh = ServingEngine(model, params, ec, device="cpu")
    fresh.restore(str(tmp_path))
    for key in rec:
        for name, t in eng.state[key].items():
            assert torch.equal(fresh.state[key][name], t), (key, name)
    fresh.run_to_completion()
    assert {r: q.generated for r, q in fresh.requests.items()} == \
        {r: q.generated for r, q in straight.requests.items()}


def test_kv_quarantine_recompute_token_exact(tiny, tmp_path):
    make_engine, _, reqs, runs = tiny
    plan = FaultPlan(1908, (KVCorruption(step=2, n_pages=2),))
    out, rep = run_engine_with_recovery(make_engine, reqs, plan,
                                        str(tmp_path), max_steps=64,
                                        snapshot_every=2)
    assert rep["kv_corrupted"] >= 1 and rep["preempted"] >= 1
    assert rep["metrics"]["kv_quarantined_pages"] >= 1
    assert out == runs["baseline"]["outputs"]


def test_corrupt_kv_pages_writes_in_place(tiny):
    make_engine = tiny[0]
    eng = make_engine()
    pool = eng.state["pos0"]["pool_k"]
    ptr = pool.data_ptr()
    trob.corrupt_kv_pages(eng, [3, 7], value=5.0)
    assert eng.state["pos0"]["pool_k"].data_ptr() == ptr
    for key in ("pool_k", "pool_v"):
        p = eng.state["pos0"][key]
        assert bool((p[:, [3, 7]] == 5.0).all())
        assert bool((p[:, 4] == 0).all())


def test_page_loss_transparent(tiny, tmp_path):
    make_engine, _, reqs, runs = tiny
    plan = FaultPlan(1908, (PageLoss(step=1, n_pages=3),))
    out, rep = run_engine_with_recovery(make_engine, reqs, plan,
                                        str(tmp_path), max_steps=64,
                                        snapshot_every=2)
    assert rep["pages_lost"] >= 1
    assert out == runs["baseline"]["outputs"]


@settings(max_examples=2, deadline=None)
@given(crash_step=st.integers(1, 5), every=st.integers(1, 3))
def test_fuzz_crash_restart_token_exact(tiny, tmp_path_factory, crash_step,
                                        every):
    """For any crash step and snapshot cadence the restarted engine replays
    to the fault-free tokens."""
    make_engine, _, reqs, runs = tiny
    plan = FaultPlan(7, (EngineCrash(step=crash_step),))
    ck = str(tmp_path_factory.mktemp("ck_fuzz"))
    out, rep = run_engine_with_recovery(make_engine, reqs, plan, ck,
                                        max_steps=64, snapshot_every=every)
    assert out == runs["baseline"]["outputs"]
    assert rep["crashes"] in (0, 1)


def test_stall_fails_loudly(tiny, tmp_path):
    make_engine, _, reqs, _ = tiny
    with pytest.raises(RecoveryError, match="stalled"):
        run_engine_with_recovery(make_engine, reqs[:2], None, str(tmp_path),
                                 max_steps=1)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase R helpers on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_faulted_serve_on_the_cpu(tiny, tmp_path):
    """R5's helpers on the tiny engine: the crash row equals the
    fault-free run bit for bit, the KV-corruption and page-loss rows pass
    S2's rule, and the snapshots are timed."""
    cs = _chip_smoke()
    _, cfg, reqs, want = tiny
    from repro_torch.models import Model, RunConfig, params_from_numpy
    from repro_torch.configs import get_config
    model = Model(get_config("internlm2-1.8b", reduced=True),
                  RunConfig(**chaos.SERVE_RUN_CONFIG))
    params = params_from_numpy(model.init_numpy(0), "cpu")
    plans = [(kind, plan, 2) for kind, plan in chaos.serve_plans()]
    runs = cs.faulted_serve(model, params, chaos.SERVE_ENGINE, reqs, plans,
                            str(tmp_path), "cpu", 64, 64)
    assert runs["baseline"]["outputs"] == want["baseline"]["outputs"]
    assert not os.listdir(tmp_path)             # checkpoints deleted
    for kind in ("engine-crash", "kv-corruption", "page-loss"):
        got = cs.hold_faulted_row(runs["baseline"], runs[kind], cfg.vocab,
                                  exact=kind == "engine-crash")
        assert got["left_out"] == 0 and got["checked"] == 20, kind
    crash = runs["engine-crash"]
    assert len(crash["restore_s"]) == 1 and len(crash["save_s"]) >= 2
    assert crash["snapshot_bytes"] > 0
    assert runs["kv-corruption"]["report"]["preempted"] >= 1
    assert all(isinstance(k, list) for k in runs["baseline"]["K"])


def test_chip_smoke_hold_faulted_row_rule():
    """A token may differ only past a near-tie, and is then counted; a
    token that differs at a wide lead, or logits off by more than the
    tolerance, fail."""
    cs = _chip_smoke()
    vocab = 8
    rows = {(0, i): np.eye(vocab, dtype=np.float32)[i] for i in range(3)}
    near = np.eye(vocab, dtype=np.float32)[1]
    near[2] = 1.0 - 1e-3                        # token 1 leads by 1e-3
    rows[(0, 1)] = near
    base = dict(outputs={0: [0, 1, 2]}, logits=rows)
    same = dict(outputs={0: [0, 1, 2]},
                logits={k: v + 1e-4 for k, v in rows.items()})
    assert cs.hold_faulted_row(base, same, vocab, exact=False)["checked"] == 3
    with pytest.raises(ValueError, match="bit for bit|bits"):
        cs.hold_faulted_row(base, same, vocab, exact=True)
    tie = dict(outputs={0: [0, 2, 5]}, logits=rows)
    got = cs.hold_faulted_row(base, tie, vocab, exact=False)
    assert got == dict(checked=1, left_out=2, diverged=[0], max_abs_err=0.0)
    wide = dict(outputs={0: [3, 1, 2]}, logits=rows)
    with pytest.raises(ValueError, match="top-1 lead"):
        cs.hold_faulted_row(base, wide, vocab, exact=False)
    off = dict(outputs={0: [0, 1, 2]},
               logits={k: v + 2e-3 for k, v in rows.items()})
    with pytest.raises(ValueError, match="logits differ"):
        cs.hold_faulted_row(base, off, vocab, exact=False)


def test_chaos_worlds_equal_the_fixture():
    """R1's worlds at bench size (2^15 pages, 60,000 accesses) and their
    fault schedules equal the JAX package's: materialised on the CPU, no
    sweep."""
    cs = _chip_smoke()
    ref = json.loads(CHAOS_REF.read_text())["parity"]
    assert (ref["trace_len"], ref["max_pages"]) == (cs.R_TRACE_LEN,
                                                    cs.R_MAX_PAGES)
    assert ref["seeds"] == chaos.SCENARIO_SEEDS
    for (name, cap), want in zip(chaos.PARITY_WORLDS, ref["worlds"]):
        d = chaos.scenario_world(name, cs.R_TRACE_LEN,
                                 min(cs.R_MAX_PAGES, cap))
        pw = make_parity_world(d.world, d.trace, seed=chaos.CHAOS_SEED,
                               n_faults=3)
        want = dict(want)
        assert [list(f) for f in pw.faults] == want.pop("faults")
        assert cs.world_record(name, d) == want
    specs = [json.loads(json.dumps(dataclasses.asdict(s)))
             for s in chaos.suite(d.meta["contiguity_histogram"])]
    assert [c["spec"]["name"] for c in ref["cells"][-3:]] == \
        [s["name"] for s in specs]
    assert len(ref["cells"]) == 18


def test_chip_smoke_serve_fixture_check_fails_on_a_changed_token(tiny):
    cs = _chip_smoke()
    ref = json.loads(CHAOS_REF.read_text())["serve"]
    runs = tiny[3]
    cs.check_serve_fixture(runs, ref)
    bad = json.loads(json.dumps(ref))
    bad["runs"]["page-loss"]["outputs"][1][2] += 1
    with pytest.raises(ValueError, match="page-loss"):
        cs.check_serve_fixture(runs, bad)


def test_package_imports_no_jax():
    code = ("import sys; import repro_torch.robustness, "
            "repro_torch.robustness.chaos, repro_torch.core.sweep; "
            "assert 'jax' not in sys.modules, 'imported jax'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO))


@pytest.mark.slow
def test_chaos_fixture_regenerates():
    """The JAX package still produces the committed fixture (about a
    minute of JAX on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "make_port_chaos_reference",
        REPO / "scripts" / "make_port_chaos_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh, _ = mod.reference()
    assert json.loads(json.dumps(fresh)) == json.loads(CHAOS_REF.read_text())
