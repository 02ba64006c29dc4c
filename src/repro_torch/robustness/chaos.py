"""Chaos bench: seeded fault schedules over the serving + sweep runtimes.

The port's twin of the JAX package's ``benchmarks/chaos.py``, with its
rows and statuses.  Every row answers one question: did the runtime
ABSORB this fault kind?  ``status`` is ``recovered`` when the faulted run
finished with results bit-exact (sweeps) or token-exact (serving) against
the fault-free run, ``lost`` otherwise.  The ``tlb-parity`` rows also
report the paper's coalescing-vs-blast-radius trade: a |K|=k coalesced
entry covers up to 2^k translations, so one parity flip invalidates more
reach than a Base entry loss (``detail`` shows the invalidated-entry and
extra-walk bill of detect-invalidate-rewalk recovery vs idealized ECC).

Where the port differs from the reference:

* the two backend rows follow the port's ladder, which has no second
  backend: ``kernel failure -> bisection`` (one injected launch failure,
  recovered by launching the halves) and ``bisect to oracle`` (a cell whose
  every launch fails, recovered by the pure-python oracle);
* the serve rows run the reduced InternLM2-1.8B in f32 with weights from
  the port's seeded numpy init (``Model.init_numpy(0)``): JAX's
  ``jax.random`` streams cannot be drawn without JAX, and f32 lets the
  tokens be held to the JAX engine's on the same weights;
* everything runs on ``device`` (the card unless ``"cpu"`` is asked for).

Each part is a function that runs the sweeps or serves (``parity_sweeps``,
``backend_sweeps``, ``cache_sweeps``, ``serve_runs``) and one that turns
what they returned into rows, so that a caller can check the runs beyond
the rows.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.baselines import base_spec, colt_spec, kaligned_for_histogram
from ..core.sweep import SweepCell, run_sweep
from ..kernels.tlb_sweep.ops import LAUNCHES
from ..scenarios import get_scenario
from .faults import (EngineCrash, FaultPlan, KVCorruption, PageLoss,
                     backend_fault_injection, corrupt_cache_entry,
                     make_parity_world)
from .recovery import run_engine_with_recovery

COUNTERS = ("accesses", "l1_hits", "l2_regular_hits", "l2_coalesced_hits",
            "walks", "aligned_probes", "pred_correct", "cycles",
            "shootdowns")

CHAOS_SEED = 1908
# copies of benchmarks/tlb_suite.py's settings (the port imports nothing
# of benchmarks/)
SCENARIO_SEEDS = dict(map_seed=0, trace_seed=8)
MULTITENANT_MAX_PAGES = 1 << 15
NESTED_MAX_PAGES = 1 << 15
#: the worlds of the parity rows, each with its page cap
PARITY_WORLDS = (("mt-serve-mix", MULTITENANT_MAX_PAGES),
                 ("nested-vm-mix", NESTED_MAX_PAGES))
#: the tiny serve rows' engine and requests (``benchmarks/chaos.py``)
SERVE_ENGINE = dict(page_size=8, num_pages=256, max_batch=3, max_seq=64)
SERVE_RUN_CONFIG = dict(compute_dtype="float32", attn_q_chunk=32,
                        attn_kv_chunk=32, scan_chunk=16)
SERVE_SEED = 2024


def same(a, b) -> bool:
    """Every counter of two ``SimResult``s equal."""
    return all(getattr(a, f) == getattr(b, f) for f in COUNTERS)


def suite(hist):
    """Base, COLT and K-aligned psi = 3 for a contiguity histogram."""
    return [base_spec(), colt_spec(), kaligned_for_histogram(hist, psi=3)]


def scenario_world(name: str, trace_len: int, max_pages: int):
    """``tlb_suite._scenario_world`` through the port's registry."""
    return get_scenario(name).materialize(n_pages=max_pages,
                                          trace_len=trace_len,
                                          **SCENARIO_SEEDS)


# --------------------------------------------------------------------------
# tlb-parity
# --------------------------------------------------------------------------

def parity_sweeps(trace_len: int, max_pages: int, device="cuda") -> List[Dict]:
    """Per parity world: the world, its specs and one ``run_sweep`` over
    ``specs`` × (``parity``, ``ecc``) on the parity world, then the specs
    fault-free on the base world (``3 n`` cells, in that order)."""
    out = []
    for name, cap in PARITY_WORLDS:
        d = scenario_world(name, trace_len, min(max_pages, cap))
        pw = make_parity_world(d.world, d.trace, seed=CHAOS_SEED, n_faults=3)
        if pw is None:
            continue
        specs = suite(d.meta["contiguity_histogram"])
        cells = []
        for par in ("parity", "ecc"):
            cells += [SweepCell(dataclasses.replace(s, par_policy=par),
                                pw, d.trace) for s in specs]
        cells += [SweepCell(s, d.world, d.trace) for s in specs]
        res = run_sweep(cells, cache=False, device=device)
        out.append(dict(scenario=name, data=d, world=pw, specs=specs,
                        cells=cells, result=res))
    return out


def parity_rows(sweeps: Sequence[Dict]) -> List[Dict]:
    rows = []
    for sw in sweeps:
        res, n = sw["result"], len(sw["specs"])
        for j, s in enumerate(sw["specs"]):
            flip, ecc, free = res[j], res[n + j], res[2 * n + j]
            ok = same(ecc, free)         # ECC = fault-free by construction
            rows.append({
                "fault": "tlb-parity", "scenario": sw["scenario"],
                "cell": s.name, "status": "recovered" if ok else "lost",
                "detail": (f"inval={flip.shootdowns - free.shootdowns} "
                           f"extra_walks={flip.walks - free.walks} "
                           f"per {len(sw['world'].faults)} flips")})
    return rows


# --------------------------------------------------------------------------
# backend-failure
# --------------------------------------------------------------------------

def backend_sweeps(trace_len: int, max_pages: int, device="cuda") -> Dict:
    """The ``mt-serve-mix`` suite three times: clean, with one injected
    launch failure, and with its first cell cursed (every batch holding it
    fails).  Each run is ``(SweepResult, kernel launches it made,
    failures injected)``."""
    d = scenario_world("mt-serve-mix", trace_len,
                       min(max_pages, MULTITENANT_MAX_PAGES))
    cells = [SweepCell(s, d.world, d.trace)
             for s in suite(d.meta["contiguity_histogram"])]
    backends = (torch.device(device).type,)

    def run(**inject):
        n0 = LAUNCHES["tlb_sweep"]
        if not inject:
            return run_sweep(cells, cache=False, device=device), \
                LAUNCHES["tlb_sweep"] - n0, 0
        with backend_fault_injection(backends=backends, **inject) as st:
            res = run_sweep(cells, cache=False, device=device)
        return res, LAUNCHES["tlb_sweep"] - n0, st["injected"]

    cursed = cells[0]
    return dict(
        clean=run(), bisection=run(n_failures=1),
        oracle=run(n_failures=10_000,
                   predicate=lambda sub, bk: any(c is cursed for c in sub)))


def backend_rows(b: Dict) -> List[Dict]:
    clean = b["clean"][0]
    rows = []
    for cell, key, want_oracle in (("kernel failure -> bisection",
                                    "bisection", 0),
                                   ("bisect to oracle", "oracle", 1)):
        res, launches, _ = b[key]
        ok = (res.stats["bisections"] >= 1
              and res.stats["oracle_fallbacks"] == want_oracle
              and all(same(x, y) for x, y in zip(res, clean)))
        rows.append({"fault": "backend-failure", "scenario": "mt-serve-mix",
                     "cell": cell, "status": "recovered" if ok else "lost",
                     "detail": (f"bisections={res.stats['bisections']} "
                                f"oracle={res.stats['oracle_fallbacks']} "
                                f"launches={launches}")})
    return rows


# --------------------------------------------------------------------------
# cache-corruption
# --------------------------------------------------------------------------

def cache_sweeps(trace_len: int, max_pages: int, device="cuda") -> Dict:
    """The ``mt-serve-mix`` suite through a private cache: a first run
    fills it, three entries are damaged (truncate, garbage, schema), a
    second run quarantines and recomputes them."""
    d = scenario_world("mt-serve-mix", trace_len,
                       min(max_pages, MULTITENANT_MAX_PAGES))
    cells = [SweepCell(s, d.world, d.trace)
             for s in suite(d.meta["contiguity_histogram"])]
    with tempfile.TemporaryDirectory() as cdir:
        first = run_sweep(cells, cache=True, cache_dir=cdir, device=device)
        entries = sorted(p for p in os.listdir(cdir) if p.endswith(".npz"))
        for mode, entry in zip(("truncate", "garbage", "schema"), entries):
            corrupt_cache_entry(os.path.join(cdir, entry), mode)
        again = run_sweep(cells, cache=True, cache_dir=cdir, device=device)
    return dict(first=first, again=again)


def cache_rows(c: Dict) -> List[Dict]:
    first, again = c["first"], c["again"]
    ok = (again.stats["cache_quarantined"] == 3
          and all(same(a, b) for a, b in zip(again, first)))
    return [{"fault": "cache-corruption", "scenario": "mt-serve-mix",
             "cell": "truncate+garbage+schema",
             "status": "recovered" if ok else "lost",
             "detail": (f"quarantined={again.stats['cache_quarantined']} "
                        f"hits={again.stats['cache_hits']}")}]


# --------------------------------------------------------------------------
# engine-crash / kv-corruption / page-loss
# --------------------------------------------------------------------------

def serve_plans(seed: int = CHAOS_SEED, crash: int = 3, kv: int = 2,
                loss: int = 1) -> List[Tuple[str, FaultPlan]]:
    """The serve rows' plans: a crash, two corrupted KV pages and three
    lost pages, each at its engine step."""
    return [
        ("engine-crash", FaultPlan(seed, (EngineCrash(step=crash),))),
        ("kv-corruption", FaultPlan(seed, (KVCorruption(step=kv,
                                                        n_pages=2),))),
        ("page-loss", FaultPlan(seed, (PageLoss(step=loss, n_pages=3),))),
    ]


def serve_requests(vocab: int, n: int = 4, prompt_len: int = 12,
                   max_new: int = 5, seed: int = SERVE_SEED):
    rng = np.random.default_rng(seed)
    return [(list(rng.integers(0, vocab, size=prompt_len)), max_new)
            for _ in range(n)]


def tiny_engine_factory(device="cuda"):
    """``(make_engine, cfg)`` of the serve rows: the reduced InternLM2-1.8B
    in f32, seeded numpy weights, ``SERVE_ENGINE``."""
    from ..configs import get_config
    from ..models import Model, RunConfig, params_from_numpy
    from ..serve import EngineConfig, ServingEngine
    cfg = get_config("internlm2-1.8b", reduced=True)
    model = Model(cfg, RunConfig(**SERVE_RUN_CONFIG))
    params = params_from_numpy(model.init_numpy(0), device)
    ec = EngineConfig(**SERVE_ENGINE)
    return (lambda: ServingEngine(model, params, ec, device=device)), cfg


def serve_runs(make_engine: Callable, requests, plans, ckpt_root: str,
               max_steps: int = 64, snapshot_every: int = 2,
               sync: Callable = lambda: None,
               on_run: Optional[Callable] = None) -> Dict:
    """A fault-free serve, then one per ``(kind, plan)`` of ``plans`` (a
    third item, where given, is that run's ``snapshot_every``; the
    fault-free run takes ``snapshot_every``), each through
    :func:`run_engine_with_recovery` with its checkpoints in a directory of
    its own under ``ckpt_root`` (deleted after).  ``on_run(kind)`` is
    called before each run; ``sync`` (the card's synchronise) before the
    clock starts and before it stops.  Returns ``{"baseline": run, kind:
    run}``, a run being ``dict(outputs, report, wall_s)``."""
    runs = {}
    for kind, plan, *every in [("baseline", None)] + list(plans):
        ck = os.path.join(ckpt_root, kind)
        shutil.rmtree(ck, ignore_errors=True)
        if on_run is not None:
            on_run(kind)
        sync()
        t0 = time.perf_counter()
        try:
            out, rep = run_engine_with_recovery(
                make_engine, requests, plan, ck, max_steps=max_steps,
                snapshot_every=every[0] if every else snapshot_every)
            sync()
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        runs[kind] = dict(outputs=out, report=rep,
                          wall_s=time.perf_counter() - t0)
    return runs


def serve_rows(runs: Dict, scenario: str = "serve-tiny") -> List[Dict]:
    base = runs["baseline"]["outputs"]
    rows = []
    for kind, run in runs.items():
        if kind == "baseline":
            continue
        rep = run["report"]
        rows.append({"fault": kind, "scenario": scenario,
                     "cell": f"{len(base)} reqs",
                     "status": ("recovered" if run["outputs"] == base
                                else "lost"),
                     "detail": (f"crashes={rep['crashes']} "
                                f"preempted={rep['preempted']} "
                                f"pages_lost={rep['pages_lost']} "
                                f"wall={run['wall_s']:.0f}s")})
    return rows


def bench_chaos(trace_len: int = 60_000,
                max_pages: int = MULTITENANT_MAX_PAGES,
                device="cuda") -> List[Dict]:
    """Every row of the chaos bench, on ``device``."""
    rows = parity_rows(parity_sweeps(trace_len, max_pages, device))
    rows += backend_rows(backend_sweeps(trace_len, max_pages, device))
    rows += cache_rows(cache_sweeps(trace_len, max_pages, device))
    make_engine, cfg = tiny_engine_factory(device)
    with tempfile.TemporaryDirectory() as ckpt_root:
        rows += serve_rows(serve_runs(make_engine, serve_requests(cfg.vocab),
                                      serve_plans(), ckpt_root))
    return rows
