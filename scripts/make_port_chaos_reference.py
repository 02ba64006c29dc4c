"""Write the JAX reference the port's chaos rows are held to.

Runs the JAX package on the CPU over the two parts of
``benchmarks/chaos.py`` whose results the port must equal, built as that
bench builds them:

* ``parity`` — ``_parity_rows`` at its defaults: the ``mt-serve-mix`` and
  ``nested-vm-mix`` scenarios at 2^15 pages and 60,000 accesses
  (``tlb_suite._scenario_world``, ``SCENARIO_SEEDS``), each wrapped by
  ``make_parity_world(seed=1908, n_faults=3)``; Base, COLT and K-aligned
  psi = 3 (``chaos._suite``) under ``par_policy`` ``parity`` and ``ecc``
  on the parity world, then fault-free on the base world: 18 cells, one
  ``run_sweep(backend="xla", cache=False)`` per world.  Per world it keeps
  ``chip_smoke.world_record`` and the fault schedule; per cell the spec,
  every ``SimResult`` counter, ``coverage_mean`` and the SHA-256 of
  ``ppn`` as int32 bytes;
* ``serve`` — ``_serve_rows``' setup: the reduced InternLM2-1.8B, page 8,
  256 pages, batch 3, max_seq 64, 4 requests of 12 prompt tokens and 5
  new tokens drawn with seed 2024, through ``run_engine_with_recovery``
  fault-free and under the three plans (a crash at step 3, KV corruption
  of 2 pages at step 2, 3 pages lost at step 1; seed 1908; a snapshot
  every 2 steps).  The weights are the port's seeded numpy init
  (``Model.init_numpy(0)``: ``jax.random`` streams cannot be drawn on a
  machine without JAX, numpy's can) and compute is f32 (``RunConfig(
  compute_dtype="float32", attn_q_chunk=32, attn_kv_chunk=32,
  scan_chunk=16)``), Pallas in interpret mode.  Per run it keeps the
  generated tokens and the report's counts.

Output: ``tests/data/port_chaos_reference.json``.  ``chip_smoke.py``
(phases R1 and R4) holds the port on the card to it,
``tests/test_torch_robustness.py`` the port on the CPU (the serve part);
its slow lane regenerates the file and compares.  The port itself never
imports this script.  About a minute on one core.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/make_port_chaos_reference.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import chaos as bc  # noqa: E402
from benchmarks import tlb_suite as ts  # noqa: E402
from chip_smoke import CELL_FIELDS, ppn_digest, world_record  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.sweep import SweepCell, run_sweep  # noqa: E402
from repro.models import Model, RunConfig  # noqa: E402
from repro.robustness import (make_parity_world,  # noqa: E402
                              run_engine_with_recovery)
from repro.serve import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import Model as PortModel  # noqa: E402
from repro_torch.models import RunConfig as PortRunConfig  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "port_chaos_reference.json")
TRACE_LEN = 60_000
MAX_PAGES = ts.MULTITENANT_MAX_PAGES
N_FAULTS = 3
POLICIES = ("parity", "ecc", "free")
SERVE_ARCH = "internlm2-1.8b"
RUN_CONFIG = dict(compute_dtype="float32", attn_q_chunk=32,
                  attn_kv_chunk=32, scan_chunk=16)
ENGINE = dict(page_size=8, num_pages=256, max_batch=3, max_seq=64)
WEIGHT_SEED = 0
REQUEST_SEED = 2024
N_REQUESTS, PROMPT_LEN, MAX_NEW = 4, 12, 5
MAX_STEPS = 64
SNAPSHOT_EVERY = 2
PLANS = (("engine-crash", dict(step=3)),
         ("kv-corruption", dict(step=2, n_pages=2)),
         ("page-loss", dict(step=1, n_pages=3)))
REPORT_KEYS = ("crashes", "restarts", "kv_corrupted", "preempted",
               "pages_lost", "steps")


def result_record(r) -> dict:
    return dict(name=r.name, **{f: int(getattr(r, f)) for f in CELL_FIELDS},
                coverage_mean=float(r.coverage_mean),
                ppn_sha256=ppn_digest(r.ppn))


def parity_reference(trace_len: int = TRACE_LEN, max_pages: int = MAX_PAGES):
    worlds, cells = [], []
    for name, cap in (("mt-serve-mix", ts.MULTITENANT_MAX_PAGES),
                      ("nested-vm-mix", ts.NESTED_MAX_PAGES)):
        d = ts._scenario_world(name, trace_len, min(max_pages, cap))
        pw = make_parity_world(d.world, d.trace, seed=bc.CHAOS_SEED,
                               n_faults=N_FAULTS)
        specs = bc._suite(d.meta["contiguity_histogram"])
        sweep = [SweepCell(dataclasses.replace(s, par_policy=par), pw,
                           d.trace) for par in POLICIES[:2] for s in specs]
        sweep += [SweepCell(s, d.world, d.trace) for s in specs]
        res = run_sweep(sweep, cache=False, backend="xla")
        worlds.append(dict(world_record(name, d),
                           faults=[[int(t), int(v)] for t, v in pw.faults]))
        for i, (c, r) in enumerate(zip(sweep, res)):
            cells.append(dict(scenario=name,
                              policy=POLICIES[i // len(specs)],
                              spec=dataclasses.asdict(c.spec),
                              **result_record(r)))
    return dict(trace_len=trace_len, max_pages=max_pages,
                seeds=dict(ts.SCENARIO_SEEDS), chaos_seed=bc.CHAOS_SEED,
                n_faults=N_FAULTS, worlds=worlds, cells=cells)


def serve_reference():
    from repro.robustness import (EngineCrash, FaultPlan, KVCorruption,
                                  PageLoss)
    kinds = {"engine-crash": EngineCrash, "kv-corruption": KVCorruption,
             "page-loss": PageLoss}
    cfg = get_config(SERVE_ARCH, reduced=True)
    port = PortModel(port_config(SERVE_ARCH, reduced=True),
                     PortRunConfig(**RUN_CONFIG))
    params = jax.tree.map(jnp.asarray, port.init_numpy(WEIGHT_SEED))
    model = Model(cfg, RunConfig(**RUN_CONFIG))
    ec = EngineConfig(**ENGINE, interpret=True)
    rng = np.random.default_rng(REQUEST_SEED)
    requests = [([int(t) for t in rng.integers(0, cfg.vocab,
                                                size=PROMPT_LEN)], MAX_NEW)
                for _ in range(N_REQUESTS)]
    runs = {}
    for kind, ev in (("baseline", None),) + PLANS:
        plan = None if ev is None else FaultPlan(bc.CHAOS_SEED,
                                                 (kinds[kind](**ev),))
        with tempfile.TemporaryDirectory() as ck:
            out, rep = run_engine_with_recovery(
                lambda: ServingEngine(model, params, ec), requests, plan, ck,
                max_steps=MAX_STEPS,
                snapshot_every=1 if ev is None else SNAPSHOT_EVERY)
        runs[kind] = dict(
            event=ev,
            outputs=[[int(t) for t in out[rid]] for rid in sorted(out)],
            report={k: int(rep[k]) for k in REPORT_KEYS},
            kv_quarantined_pages=int(rep["metrics"]["kv_quarantined_pages"]))
    return dict(arch=SERVE_ARCH, reduced=True, run_config=RUN_CONFIG,
                weight_seed=WEIGHT_SEED, engine=ENGINE,
                request_seed=REQUEST_SEED, requests=requests,
                max_steps=MAX_STEPS, snapshot_every=SNAPSHOT_EVERY,
                chaos_seed=bc.CHAOS_SEED, runs=runs)


def reference():
    """``(reference dict, seconds the JAX runs took)``."""
    t0 = time.time()
    ref = dict(
        source="JAX run_sweep(backend='xla', cache=False) and "
               "run_engine_with_recovery over benchmarks/chaos.py's parity "
               "and serve setups; scripts/make_port_chaos_reference.py",
        parity=parity_reference(), serve=serve_reference())
    return ref, time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    ref, wall = reference()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    for kind, run in ref["serve"]["runs"].items():
        print(f"{kind}: {run['outputs']} {run['report']}")
    print(f"wrote {len(ref['parity']['cells'])} parity cells and "
          f"{len(ref['serve']['runs'])} serve runs to {args.out} (the JAX "
          f"runs took {wall:.1f} s on this host's CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
