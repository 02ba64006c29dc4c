"""Driver of the TLB-sweep cells: the paper's method roster over static
worlds, as ``run_sweep(cells, cache=False)`` calls that the window cycles
through.

The configuration (``configs/<config>.json``) gives the world size and
the roster; the traffic (``traffic/<mix>.json``) names the worlds each
call sweeps (``calls``: a list of lists of world names), the |K| bounds
psi, and optional spec overrides each lane is run under (``variants``).
Worlds and specs are made by the frozen copies in ``perfbench/tlbref``
from ``--seed`` and converted field for field into the program's types;
the program sees only them.

Correct (:func:`judge`): every call of a batch must give that batch's
first results; a sample of the distinct lanes, drawn from the seed, must
equal the plain reference (``tlbref/reference.py``) in every counter, the
coverage mean and every translated ppn; the sweep's recovery ladder must
never be taken.  The reference runs after the window, in worker
processes.

What the per-layer readers (``metrics/<m>.py``) get, under fixed keys of
``Outcome.obs``:

* ``trace``: the traced window's ``DeviceTrace`` (None untraced):
  kernel time and launches by name fragment, host spans by name, busy
  time;
* ``window_s``: the window's seconds;
* ``calls``: one dict a call: ``batch`` (its index), ``wall_s``,
  ``stats`` (``run_sweep``'s), ``launches`` (the program's launch
  counters, their change over the call);
* ``batches``: one dict a batch: ``lanes`` (``(world, spec)`` a lane, the
  frozen ``World`` and ``MethodSpec``), ``results`` (its first call's
  ``SimResult`` list).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import random
import resource
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional

from perfbench.harness import bench
from perfbench.harness.profiling import DeviceTrace
from perfbench.tlbref import reference as REF, specs as fspecs
from perfbench.tlbref.worlds import build_world


def seeds(seed: int, trace_offset: int = 1):
    """The worlds' map and trace seeds from ``--seed`` (seed 1 gives the
    Table 4 suite's own: map 1, trace 2)."""
    s = abs(int(seed)) % (1 << 32)
    return s, s + int(trace_offset)


def to_program(obj, mods):
    """A frozen-copy dataclass (mapping, spec) as the program's class of
    the same name, field for field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = next(getattr(m, type(obj).__name__) for m in mods
                   if hasattr(m, type(obj).__name__))
        return cls(**{f.name: to_program(getattr(obj, f.name), mods)
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(to_program(x, mods) for x in obj)
    return obj


@dataclasses.dataclass
class Batch:
    """One ``run_sweep`` call's inputs: a ``(world, spec)`` a lane, and
    the program's ``SweepCell`` of each."""

    lanes: List
    cells: List


def roster(cell: bench.Cell, world) -> List:
    """The configuration's roster over ``world``, K by Algorithm 3 from
    its histogram, under each of the traffic's variants."""
    tr = cell.traffic
    base = [s for s, _, _ in fspecs.suite_specs(
        world.histogram, cell.config["anchor_grid"], tr["psis"])]
    return [dataclasses.replace(s, **v) for v in tr.get("variants", [{}])
            for s in base]


def make_batches(cell: bench.Cell) -> List[Batch]:
    from repro_torch.core import page_table, simulator
    from repro_torch.core.sweep import SweepCell
    cfg, tr = cell.config, cell.traffic
    map_seed, trace_seed = seeds(cell.seed, tr["trace_seed_offset"])
    built: Dict[str, object] = {}
    mods = (page_table, simulator)
    out = []
    for names in tr["calls"]:
        lanes, cells = [], []
        for name in names:
            if name not in built:
                built[name] = build_world(name, cfg["n_pages"],
                                          cfg["trace_len"], map_seed,
                                          trace_seed)
            w = built[name]
            m = to_program(w.mapping, mods)
            for s in roster(cell, w):
                lanes.append((w, s))
                cells.append(SweepCell(to_program(s, mods), m, w.trace))
        out.append(Batch(lanes, cells))
    return out


def program_sweep(device: str) -> Callable:
    """The timed path: the program's ``run_sweep`` over a batch."""
    def sweep(batch: Batch):
        from repro_torch.core.sweep import run_sweep
        return run_sweep(batch.cells, cache=False, device=device)
    return sweep


def _launches() -> Dict[str, int]:
    from repro_torch.kernels.tlb_sweep import ops
    return dict(ops.LAUNCHES)


def run(cell: bench.Cell, sweep: Optional[Callable] = None) -> bench.Outcome:
    """Set up, run the window, judge.  ``sweep`` replaces the program's
    ``run_sweep`` (a control puts the reference in its place)."""
    import torch
    sweep = sweep or program_sweep(cell.device)
    batches = make_batches(cell)
    for b in batches:                 # builds the kernel; warms every batch
        sweep(b)
    trace = DeviceTrace() if cell.trace else None
    if trace is not None:
        DeviceTrace.warm()
    if cell.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cell.mark_setup_done()

    calls = []
    if trace is not None:
        trace.__enter__()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    i = 0
    while time.perf_counter() < deadline:
        b = i % len(batches)
        before = _launches()
        a = time.perf_counter()
        with DeviceTrace.span("bench.run_sweep"):
            res = sweep(batches[b])
        wall = time.perf_counter() - a
        after = _launches()
        calls.append(dict(batch=b, wall_s=wall, results=res.results,
                          stats=dict(res.stats),
                          launches={k: after[k] - before.get(k, 0)
                                    for k in after}))
        i += 1
    window_s = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    if trace is not None:
        trace.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated() if cell.device == "cuda"
            else 0)
    walls = [c["wall_s"] for c in calls]
    user_s, sys_s = ru1.ru_utime - ru0.ru_utime, ru1.ru_stime - ru0.ru_stime
    print(f"window: {len(calls)} calls, call ms "
          f"{' '.join(f'{w * 1e3:.0f}' for w in walls)}; host cpu user "
          f"{user_s / window_s:.3f} sys {sys_s / window_s:.3f} of the "
          "wall", file=sys.stderr)
    return judge(cell, batches, calls, window_s, peak, trace)


def differ(a, b) -> int:
    """Fields in which two results differ."""
    x, y = REF.summary(a), REF.summary(b)
    return sum(x[k] != y[k] for k in x)


def judge(cell: bench.Cell, batches: List[Batch], calls: List[Dict],
          window_s: float, peak: int, trace=None) -> bench.Outcome:
    """The checks of a run and its ``Outcome`` from the calls of its
    window, whatever produced them."""
    accesses = sum(REF.accesses(r) for c in calls for r in c["results"])
    e2e = {"sweep_accesses_per_s": accesses / window_s}

    # every call of a batch against the batch's first call
    first: Dict[int, List] = {}
    repeat = rungs = 0
    for c in calls:
        b = c["batch"]
        rungs += c["stats"].get("bisections", 0) + \
            c["stats"].get("oracle_fallbacks", 0)
        want = first.setdefault(b, c["results"])
        if len(c["results"]) != len(batches[b].lanes):
            repeat += 1
        repeat += sum(differ(r, s) for r, s in zip(c["results"], want))

    # a sample of the distinct lanes against the plain reference
    n_check = int(cell.traffic["check_cells"])
    pairs = [(b, j) for b in first for j in range(len(batches[b].lanes))]
    pick = random.Random(cell.seed).sample(pairs, min(n_check, len(pairs)))
    want = reference([job(cell, batches[b].lanes[j]) for b, j in pick],
                     int(cell.traffic["check_workers"]))
    ref_bad = 0
    for (b, j), s in zip(pick, want):
        res = first.get(b, [])
        ref_bad += (sum(v != s[k] for k, v in REF.summary(res[j]).items())
                    if j < len(res) else 1)
    checks = [bench.check("oracle_mismatches", ref_bad, 0),
              bench.check("repeat_mismatches", repeat, 0),
              bench.check("cells_checked", len(pick), n_check, below=False),
              bench.check("ladder_rungs", rungs, 0)]

    obs = {"trace": trace, "window_s": window_s,
           "calls": [{k: c[k] for k in ("batch", "wall_s", "stats",
                                        "launches")} for c in calls],
           "batches": [{"lanes": bt.lanes, "results": first.get(b)}
                       for b, bt in enumerate(batches)]}
    return bench.Outcome(
        checks=checks, attempted=sum(len(c["results"]) for c in calls),
        failed=0, end_to_end=e2e, obs=obs, memory_peak_bytes=peak,
        trace=trace)


def job(cell: bench.Cell, lane) -> tuple:
    """A lane as a job for a worker process: the world is built again from
    its name, sizes and seeds (every builder is deterministic), so a job
    pickles a few numbers, not a world."""
    w, s = lane
    return (w.name, cell.config["n_pages"], cell.config["trace_len"],
            *seeds(cell.seed, cell.traffic["trace_seed_offset"]),
            dataclasses.asdict(s))


def reference(jobs, workers: int, walk_fill: Optional[Callable] = None
              ) -> List[Dict]:
    """The plain reference over ``jobs``, in up to ``workers`` processes
    (spawned: the parent holds CUDA)."""
    if not jobs:
        return []
    workers = max(1, min(workers, len(jobs), (os.cpu_count() or 2) - 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        futs = [ex.submit(REF.run_job, *j, fill=walk_fill or REF.walk_fill)
                for j in jobs]
        return [f.result() for f in futs]
