"""Batched sweep engine: every method × trace as lanes of one kernel launch.

The port of the JAX package's ``core/sweep.py``.  :func:`run_sweep` dedups
mappings/traces, packs the cells into lanes
(:func:`repro_torch.core.lane_program.pack_lanes` — every method padded
onto one array layout, so ``base/thp/colt/cluster/rmm/anchor/kaligned``
and the accelerator kinds all run side by side), consults an on-disk
result cache under ``results/sweep_cache_torch``, simulates the missing
cells and returns per-cell :class:`~repro_torch.core.simulator.SimResult`
objects bit-identical to the JAX package's ``run_sweep``.

Execution goes through :func:`repro_torch.kernels.tlb_sweep.ops.run_lanes`:
on the card (``device="cuda"``, the default) one launch of the CUDA
TLB-sweep kernel per packed batch; with ``device="cpu"`` the plain torch
version.  Asking for the card on a machine without one raises.

A batch failed by the chaos harness goes down the recovery ladder
(:func:`_run_batch_resilient`): the kernel again on each half of the batch
(bisection), and a single cell that fails every launch to the pure-python
oracle.  Results are identical by construction.  Unlike the reference's
ladder there is no second backend to retry on: the plain torch version
takes about 10 ms a step on the card, and putting it in the kernel's place
would hide the kernel.  The ladder catches only :class:`BackendFault`,
which the chaos harness raises through :data:`_BACKEND_FAULT_HOOK`; a real
launch failure, a shape refusal (``ValueError``) or a build failure
propagates, so the kernel's work never moves to the CPU behind the
caller's back.  Every rung taken warns and is counted in ``run_sweep``'s
stats (``bisections``, ``oracle_fallbacks``).

Dynamic, multi-tenant, nested and parity-fault worlds run as
segmented lanes exactly as in the reference: records per ``(world,
source)``, a timeline split at the union of all lanes' boundaries, and
the context switch + coherence shootdown at every segment entry.
``run_sweep`` partitions each request so purely-static cells never ride a
multi-segment timeline.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import time
import warnings
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.tlb_sweep.ops import run_lanes
from ..tracing import span
from .lane_program import (C_COAL, C_CYC, C_L1, C_PRED, C_PROBE, C_REG,
                           C_SHOOT, C_WALK, LANE_SHARE_MAX,
                           init_batched_state, pack_lanes)
from .page_table import (DynamicMapping, Mapping, MultiTenantMapping,
                         NestedMapping, ParityWorld)
from .simulator import MethodSpec, SimResult


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One cell of a sweep: simulate ``spec`` over ``(mapping, trace)``.

    * ``spec``    — a :class:`~repro_torch.core.simulator.MethodSpec` (build one
      with the factories in :mod:`repro_torch.core.baselines`); its static config
      becomes per-lane *data* in the batched engine, so cells with different
      specs still share one batch.
    * ``mapping`` — a contiguity-annotated
      :class:`~repro_torch.core.page_table.Mapping`, a
      :class:`~repro_torch.core.page_table.DynamicMapping` whose epoch boundaries
      segment the trace (mid-trace remaps with shootdown-correct
      invalidation), **or** a
      :class:`~repro_torch.core.page_table.MultiTenantMapping` whose schedule
      segments it (ASID-tagged context switching; the flush-vs-tag policy
      is ``spec.ctx_policy``), **or** a
      :class:`~repro_torch.core.page_table.NestedMapping` whose segment grid is
      the union of its VM schedule, guest epochs and host epochs (two-level
      translation; the shootdown-vs-hw-coherence knob is
      ``spec.coh_policy``), **or** a
      :class:`~repro_torch.core.page_table.ParityWorld` wrapping any of those
      plus a schedule of mid-trace TLB parity-flip faults (soft-error
      recovery; the detect-invalidate-rewalk vs in-place-correction knob
      is ``spec.par_policy``); get one from the generators in
      :mod:`repro_torch.core.mappings` and
      :mod:`repro_torch.core.page_table`.
    * ``trace``   — 1-D integer array of VPNs (every entry must be a mapped
      page of the epoch/tenant live at that step).

    Mappings/traces shared between cells (by object identity) are packed and
    hashed once, so build each world once and reuse it across specs.
    """

    spec: MethodSpec
    mapping: ("Mapping | DynamicMapping | MultiTenantMapping | "
              "NestedMapping | ParityWorld")
    trace: np.ndarray

    def __post_init__(self):
        assert self.trace.ndim == 1
        world = self.mapping
        if isinstance(world, ParityWorld):
            assert all(0 < t < self.trace.shape[0]
                       for t, _ in world.faults), \
                "fault steps must fall inside the trace"
            world = world.base
        if isinstance(world, (DynamicMapping, MultiTenantMapping)):
            assert all(0 < b < self.trace.shape[0]
                       for b in world.boundaries[1:]), \
                "segment boundaries must fall inside the trace"
        elif isinstance(world, NestedMapping):
            assert all(0 < ns.lo < self.trace.shape[0]
                       for ns in world.plan_segments()[1:]), \
                "segment boundaries must fall inside the trace"

    @property
    def epochs(self) -> Tuple[Mapping, ...]:
        world = self.mapping
        if isinstance(world, ParityWorld):
            world = world.base
        if isinstance(world, DynamicMapping):
            return world.epochs
        if isinstance(world, MultiTenantMapping):
            return world.tenants
        if isinstance(world, NestedMapping):
            # distinct composed guest-over-host views, schedule order
            seen, out = set(), []
            for ns in world.plan_segments():
                if id(ns.mapping) not in seen:
                    seen.add(id(ns.mapping))
                    out.append(ns.mapping)
            return tuple(out)
        return (world,)

    @property
    def boundaries(self) -> Tuple[int, ...]:
        world, faults = self.mapping, ()
        if isinstance(world, ParityWorld):
            faults = tuple(t for t, _ in world.faults)
            world = world.base
        if isinstance(world, (DynamicMapping, MultiTenantMapping)):
            base = world.boundaries
        elif isinstance(world, NestedMapping):
            base = tuple(ns.lo for ns in world.plan_segments())
        else:
            base = (0,)
        return tuple(sorted(set(base) | set(faults)))

    @property
    def is_segmented(self) -> bool:
        """True when the lane rides a multi-segment timeline (mid-trace
        remap epochs, multi-tenant scheduling quanta, or the union grid
        of a nested guest/host world)."""
        return len(self.boundaries) > 1


@dataclasses.dataclass
class SweepResult:
    """Per-cell results (aligned with the request list) plus run stats."""

    results: List[SimResult]
    stats: Dict[str, float]

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i):
        return self.results[i]

# ---------------------------------------------------------------------------
# On-disk result cache
# ---------------------------------------------------------------------------

_GIT_DESCRIBE: Optional[str] = None
_CODE_FINGERPRINT: Optional[str] = None

# Everything that defines the simulation semantics: the engine sources AND
# both implementations of the step (plain torch and the CUDA kernel).
# Paths are relative to src/repro_torch/; none is shared with the JAX
# package, so the two packages never share a cache entry.
_FINGERPRINT_SOURCES = (
    "core/simulator.py",
    "core/sweep.py",
    "core/lane_program.py",
    "core/page_table.py",
    "core/plane_layout.py",
    "kernels/tlb_sweep/ops.py",
    "kernels/tlb_sweep/ref.py",
    "kernels/tlb_sweep/csrc/tlb_lane.cuh",
    "kernels/tlb_sweep/csrc/tlb_sweep.cu",
)


def _git_describe() -> str:
    global _GIT_DESCRIBE
    if _GIT_DESCRIBE is None:
        try:
            _GIT_DESCRIBE = subprocess.run(
                ["git", "describe", "--always", "--dirty"],
                capture_output=True, text=True, timeout=10,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip() or "nogit"
        except (OSError, subprocess.SubprocessError):
            _GIT_DESCRIBE = "nogit"
    return _GIT_DESCRIBE


def _code_fingerprint() -> str:
    """git describe + a content hash of the engine AND kernel sources, so
    uncommitted edits to the simulation semantics — including the CUDA
    TLB-sweep kernel — invalidate the cache too (a dirty tree always yields
    the same '<sha>-dirty' describe string)."""
    global _CODE_FINGERPRINT
    if _CODE_FINGERPRINT is None:
        h = hashlib.sha256(b"repro_torch:" + _git_describe().encode())
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for fname in _FINGERPRINT_SOURCES:
            try:
                with open(os.path.join(pkg, fname), "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"?")
        _CODE_FINGERPRINT = h.hexdigest()
    return _CODE_FINGERPRINT


def _array_digest(a: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def cell_key(cell: SweepCell, _digests: Optional[Dict[int, str]] = None
             ) -> str:
    """Stable cache key: spec config + world/trace content + code version.

    The key is a SHA-256 over (a) ``repr(spec)`` — every static knob of the
    method, (b) the *content* of the world and ``trace`` (dtype, shape,
    bytes — not object identity, so deterministically regenerated worlds hit
    the cache across processes), and (c) :func:`_code_fingerprint` — git
    describe plus a hash of the engine sources, so editing the simulation
    semantics invalidates stale results even in a dirty tree.  For a
    :class:`~repro_torch.core.page_table.DynamicMapping` world, (b) folds in the
    event stream: every epoch snapshot's ``ppn`` plus the boundary
    positions, so two worlds differing only in when (or what) they remap
    never collide.  Execution knobs (device, lane/trace padding) are
    deliberately NOT part of the key: results are bit-exact across them.

    ``_digests`` is an id-keyed memo so sweeps that share one mapping/trace
    across many specs hash each array once (valid while the arrays are kept
    alive by the caller, as run_sweep does).
    """
    def digest(a: np.ndarray) -> str:
        if _digests is None:
            return _array_digest(a)
        d = _digests.get(id(a))
        if d is None:
            d = _digests[id(a)] = _array_digest(a)
        return d

    h = hashlib.sha256()
    h.update(repr(cell.spec).encode())
    world = cell.mapping
    if isinstance(world, ParityWorld):
        # the fault schedule is semantic content: when and which vpn flips
        # decides which entries die — then fold the wrapped base world
        # exactly as if it were the cell's mapping
        h.update(repr(("parity", tuple(world.faults))).encode())
        world = world.base
    if isinstance(world, DynamicMapping):
        h.update(repr(tuple(world.boundaries)).encode())
        for m in world.epochs:
            h.update(digest(m.ppn).encode())
    elif isinstance(world, MultiTenantMapping):
        mt = world
        # the full schedule: when, who, under which ASID — and the recycle
        # flags explicitly (normally derived from the former, but the
        # constructor accepts an override, which must not collide)
        h.update(repr((tuple(mt.boundaries), tuple(mt.tenant_ids),
                       tuple(mt.asids), tuple(mt.recycled))).encode())
        for m in mt.tenants:
            h.update(digest(m.ppn).encode())
    elif isinstance(world, NestedMapping):
        nm = world
        # both levels fold in: the VM schedule, every guest's event stream
        # AND the host's — two worlds differing only in a host-side remap
        # (which guests never observe directly) must never collide
        h.update(repr((tuple(nm.boundaries), tuple(nm.guest_ids),
                       tuple(nm.asids), tuple(nm.recycled))).encode())
        for g in nm.guests:
            h.update(repr(tuple(g.boundaries)).encode())
            for m in g.epochs:
                h.update(digest(m.ppn).encode())
        h.update(repr(tuple(nm.host.boundaries)).encode())
        for m in nm.host.epochs:
            h.update(digest(m.ppn).encode())
    else:
        h.update(digest(world.ppn).encode())
    h.update(digest(cell.trace).encode())
    h.update(_code_fingerprint().encode())
    return h.hexdigest()[:32]


_COUNTER_FIELDS = ("accesses", "l1_hits", "l2_regular_hits",
                   "l2_coalesced_hits", "walks", "aligned_probes",
                   "pred_correct", "cycles", "shootdowns")


def _cache_load(path: str) -> Tuple[Optional[SimResult], bool]:
    """Load one cache entry: ``(result, corrupt)``.

    A *missing* entry is the normal cold-cache case — ``(None, False)``.
    An entry that exists but fails to parse (truncated write, bit rot,
    wrong schema from an older layout) is CORRUPT — ``(None, True)`` — and
    the caller must quarantine it and surface the count: silently
    recomputing would hide an integrity problem in the cache directory.
    """
    if not os.path.exists(path):
        return None, False
    try:
        with np.load(path, allow_pickle=False) as z:
            counters = z["counters"]
            return SimResult(
                name=str(z["name"]),
                **{f: int(counters[i]) for i, f in enumerate(_COUNTER_FIELDS)},
                coverage_mean=float(z["coverage_mean"]),
                ppn=z["ppn"],
            ), False
    except (OSError, KeyError, ValueError, IndexError, EOFError,
            zipfile.BadZipFile):
        return None, True


def _quarantine_cache_entry(path: str) -> None:
    """Move a corrupt entry aside (never delete: keep it inspectable)."""
    try:
        os.replace(path, path + ".quarantined")
    except OSError:
        pass                         # raced away or unwritable: recompute


def _cache_store(path: str, r: SimResult) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez_compressed(
        tmp, name=np.str_(r.name),
        counters=np.array([getattr(r, f) for f in _COUNTER_FIELDS], np.int64),
        coverage_mean=np.float64(r.coverage_mean), ppn=r.ppn)
    os.replace(tmp, path)



# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

DEFAULT_CACHE_DIR = os.path.join("results", "sweep_cache_torch")


def pack_batch(sub: Sequence[SweepCell]):
    """Pack one batch of cells: ``(lanes, stacks, st0, seg_bounds)`` as
    numpy arrays (the reference's packing, one device)."""
    with span("sweep.pack"):
        lanes, stacks, (L, max_sets, max_ways), seg_bounds = pack_lanes(sub)
        st0 = init_batched_state(
            L, max_sets, max_ways, lanes["pred0"], lanes["asid0"],
            with_ctlb=any(c.spec.kind == "cache-tlb" for c in sub),
            with_dp=any(c.spec.kind == "dead-protect" for c in sub))
    return lanes, stacks, st0, seg_bounds


class BackendFault(RuntimeError):
    """An injected sweep-batch launch failure: the one exception the
    recovery ladder catches."""


#: Chaos hook: :func:`repro_torch.robustness.faults.backend_fault_injection`
#: installs a callable here — ``hook(cells, backend)``, ``backend`` the
#: device type (``"cuda"`` or ``"cpu"``) — that raises :class:`BackendFault`
#: to make the batch fail before its launch.  ``None`` in production.
_BACKEND_FAULT_HOOK = None


def _oracle_result(cell: SweepCell) -> SimResult:
    """Pure-python oracle for one cell — the last rung a failing cell is
    bisected down to (bit-exact with the kernel, so recovery never changes
    results)."""
    from .simulator import (run_method_dynamic, run_method_multitenant,
                            run_method_nested, run_method_parity)
    w = cell.mapping
    if isinstance(w, ParityWorld):
        return run_method_parity(cell.spec, w, cell.trace)
    if isinstance(w, NestedMapping):
        return run_method_nested(cell.spec, w, cell.trace)
    if isinstance(w, MultiTenantMapping):
        return run_method_multitenant(cell.spec, w, cell.trace)
    return run_method_dynamic(cell.spec, w, cell.trace)


def _run_batch(sub: List[SweepCell], device: torch.device,
               fstats: Optional[Dict[str, int]] = None) -> List[SimResult]:
    """Pack and simulate one batch; per-cell results in ``sub`` order.
    Adds the packed arrays' bytes to ``fstats["packed_bytes"]``."""
    if _BACKEND_FAULT_HOOK is not None:
        _BACKEND_FAULT_HOOK(sub, device.type)
    lanes, stacks, st0, seg_bounds = pack_batch(sub)
    if fstats is not None:
        fstats["packed_bytes"] += sum(a.nbytes for d in (lanes, stacks, st0)
                                      for a in d.values())
    stF, ppns = run_lanes(lanes, stacks, st0, seg_bounds, device=device)
    counters = stF["counters"].cpu().numpy()
    cov_samples = stF["cov_samples"].cpu().numpy()
    ppns = ppns.cpu().numpy()
    out = []
    with span("sweep.unpack"):
        for j, c in enumerate(sub):
            t_real = c.trace.shape[0]
            cnt = counters[j]
            out.append(SimResult(
                name=c.spec.name, accesses=t_real,
                l1_hits=int(cnt[C_L1]),
                l2_regular_hits=int(cnt[C_REG]),
                l2_coalesced_hits=int(cnt[C_COAL]),
                walks=int(cnt[C_WALK]),
                aligned_probes=int(cnt[C_PROBE]),
                pred_correct=int(cnt[C_PRED]),
                cycles=int(cnt[C_CYC]),
                coverage_mean=float(np.mean(cov_samples[j])),
                ppn=ppns[j, :t_real],
                shootdowns=int(cnt[C_SHOOT]),
            ))
    return out


def _run_batch_resilient(sub: List[SweepCell], device: torch.device,
                         fstats: Dict[str, int]) -> List[SimResult]:
    """One batch with the recovery ladder: kernel → bisection → per-cell
    oracle.

    A batch that raises :class:`BackendFault` is split in two and each
    half launched again, so that one poisoned lane cannot take its
    batchmates down; a single cell that fails every launch is handed to the
    pure-python oracle.  Nothing else is caught.  Each rung warns, naming
    the exception, and is counted in ``fstats``.
    """
    try:
        return _run_batch(sub, device, fstats)
    except BackendFault as e:
        if len(sub) == 1:
            warnings.warn(f"run_sweep: {e!r}; cell {sub[0].spec.name!r} "
                          "runs on the pure-python oracle", RuntimeWarning,
                          stacklevel=2)
            fstats["oracle_fallbacks"] += 1
            return [_oracle_result(sub[0])]
        warnings.warn(f"run_sweep: {e!r}; bisecting the batch of {len(sub)} "
                      "cells", RuntimeWarning, stacklevel=2)
        fstats["bisections"] += 1
        mid = len(sub) // 2
        return (_run_batch_resilient(sub[:mid], device, fstats)
                + _run_batch_resilient(sub[mid:], device, fstats))


def batches_of(cells: Sequence[SweepCell], todo: Sequence[int]
               ) -> List[List[int]]:
    """The reference's partition: static cells never ride a multi-segment
    timeline installed by segmented cells, and each group is chunked at
    ``LANE_SHARE_MAX`` lanes.  Each chunk is one packed batch."""
    groups = [[i for i in todo if not cells[i].is_segmented],
              [i for i in todo if cells[i].is_segmented]]
    return [g[k: k + LANE_SHARE_MAX]
            for g in groups if g
            for k in range(0, len(g), LANE_SHARE_MAX)]


def run_sweep(cells: Sequence[SweepCell], *, cache: bool = True,
              cache_dir: str = DEFAULT_CACHE_DIR,
              device="cuda") -> SweepResult:
    """Simulate every cell, one kernel launch per packed batch.

    Results are bit-identical to the JAX package's ``run_sweep``
    (``tests/test_torch_sweep.py``).  ``device`` is ``"cuda"`` (the CUDA
    kernel; raises ``RuntimeError`` without a card) or ``"cpu"`` (the
    plain torch version).  An injected :class:`BackendFault` goes down
    the recovery ladder (:func:`_run_batch_resilient`); ``stats`` counts
    its ``bisections`` and ``oracle_fallbacks``, ``cache_quarantined``
    the corrupt cache entries moved aside and recomputed, and
    ``packed_bytes`` the bytes of every array packed for a launch (each
    batch, and each part the ladder packs again): the packing's work,
    and on the card the bytes uploaded.  With a profiler recording, the
    host work carries spans: ``sweep.pack`` (with ``sweep.pack.fills``,
    ``sweep.pack.clusters`` and ``sweep.pack.stack`` inside) and
    ``sweep.unpack``, one each a packed batch.  With ``cache``
    enabled, previously simulated cells (same spec, world/trace *content*
    and code version — see :func:`cell_key`) are loaded from ``cache_dir``
    and skipped; ``cache=False`` bypasses the cache.

    Usage — compare two methods on a demand-paged mapping::

        from repro_torch.core import (base_spec, demand_mapping,
                                      generate_trace, kaligned_for_mapping)
        from repro_torch.core.sweep import SweepCell, run_sweep

        m = demand_mapping(1 << 15, seed=1)
        tr = generate_trace("multiscale", 0, 100_000, seed=2, mapping=m)
        specs = [base_spec(), kaligned_for_mapping(m, psi=3)]
        sweep = run_sweep([SweepCell(s, m, tr) for s in specs])
        for r in sweep:                      # SimResult per cell, in order
            print(r.name, r.misses, r.cpi)
    """
    t0 = time.time()
    dev = resolve_device(device)
    cells = list(cells)
    results: List[Optional[SimResult]] = [None] * len(cells)
    todo: List[int] = []
    hits = 0
    fstats = dict(cache_quarantined=0, bisections=0, oracle_fallbacks=0,
                  packed_bytes=0)
    digests: Dict[int, str] = {}   # id-keyed; cells keep the arrays alive
    keys = [cell_key(c, digests) if cache else "" for c in cells]
    for i, c in enumerate(cells):
        if cache:
            path = os.path.join(cache_dir, keys[i] + ".npz")
            r, corrupt = _cache_load(path)
            if corrupt:
                _quarantine_cache_entry(path)
                fstats["cache_quarantined"] += 1
            if r is not None:
                results[i] = r
                hits += 1
                continue
        todo.append(i)

    batches = batches_of(cells, todo)
    if batches and dev.type == "cuda":
        # a build failure raises here, before any batch and its ladder
        from ..kernels.tlb_sweep import _build
        _build.load()
    for group in batches:
        sub = [cells[i] for i in group]
        for j, r in enumerate(_run_batch_resilient(sub, dev, fstats)):
            i = group[j]
            results[i] = r
            if cache:
                _cache_store(os.path.join(cache_dir, keys[i] + ".npz"), r)

    stats = dict(n_cells=len(cells), cache_hits=hits,
                 simulated=len(todo), n_batches=len(batches),
                 device=str(dev), wall_s=round(time.time() - t0, 3),
                 **fstats)
    return SweepResult(results=results, stats=stats)  # type: ignore[arg-type]
