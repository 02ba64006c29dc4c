"""Deterministic, seeded fault injection for the serving + sweep runtimes.

The port of the JAX package's ``robustness/faults.py``: the same events,
plans and parity worlds, drawn from the same numpy generators, so a plan
or a world made here equals the reference's event for event.

The chaos harness's contract is the inverse of a test suite's: instead of
asserting the system works on good inputs, it *schedules* failures — a
poisoned TLB entry, a corrupted KV page, a dead engine process, a backend
that refuses to compile, a rotted cache file — and asserts the runtimes
either recover to bit/token-exact results or fail loudly.  Everything here
is deterministic: a :class:`FaultPlan` is fully defined by its seed, so
every chaos run (:mod:`repro_torch.robustness.chaos`, the hypothesis
fuzz in ``tests/test_torch_robustness.py``) replays exactly.

Fault taxonomy (one frozen dataclass per kind):

* :class:`TLBParity`    — flip a live TLB entry mid-trace (the paper-grounded
  fault: a coalesced |K|=k entry covers up to 2^k translations, so one soft
  error has a multiplied blast radius; lowers to
  :class:`~repro_torch.core.page_table.ParityWorld`).
* :class:`KVCorruption` — garbage written into live KV-pool pages mid-serve.
* :class:`PageLoss`     — physical pages permanently lost from the KV pool.
* :class:`EngineCrash`  — the engine process dies at step N (recovered by
  :meth:`~repro_torch.serve.engine.ServingEngine.restore`).
* :class:`BackendFailure` — a sweep batch's kernel launch fails (recovered
  by ``run_sweep``'s ladder: bisection, then the per-cell oracle).
* :class:`CacheCorruption` — sweep-cache ``.npz`` entries truncated /
  garbage / wrong-schema (quarantined + recomputed by ``run_sweep``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.page_table import ParityWorld
from ..core.sweep import BackendFault

# --------------------------------------------------------------------------
# Typed fault events
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TLBParity:
    """Parity-flip a live TLB entry: the translation for ``vpn`` held at
    trace position ``step`` is poisoned.  ``spec.par_policy`` decides the
    recovery model (detect-invalidate-rewalk vs idealized ECC)."""
    step: int
    vpn: int


@dataclasses.dataclass(frozen=True)
class KVCorruption:
    """At engine step ``step``, ``n_pages`` live physical KV pages are
    overwritten with garbage (then quarantined-and-recomputed)."""
    step: int
    n_pages: int = 1


@dataclasses.dataclass(frozen=True)
class PageLoss:
    """At engine step ``step``, ``n_pages`` free physical pages vanish from
    the pool (bad DRAM): permanently retired, transparent to live work."""
    step: int
    n_pages: int = 1


@dataclasses.dataclass(frozen=True)
class EngineCrash:
    """The engine process dies right after step ``step``; the harness
    restarts from the latest checkpoint."""
    step: int


@dataclasses.dataclass(frozen=True)
class BackendFailure:
    """The next ``n_batches`` sweep batches raise on ``backends`` (device
    types: a failed launch), exercising the bisection/oracle ladder."""
    n_batches: int = 1
    backends: Tuple[str, ...] = ("cuda",)


@dataclasses.dataclass(frozen=True)
class CacheCorruption:
    """``n_entries`` sweep-cache files are damaged in ``mode``
    (``truncate`` | ``garbage`` | ``schema``)."""
    n_entries: int = 1
    mode: str = "truncate"


FAULT_KINDS = {
    "tlb-parity": TLBParity,
    "kv-corruption": KVCorruption,
    "page-loss": PageLoss,
    "engine-crash": EngineCrash,
    "backend-failure": BackendFailure,
    "cache-corruption": CacheCorruption,
}


def kind_of(event) -> str:
    for k, cls in FAULT_KINDS.items():
        if isinstance(event, cls):
            return k
    raise TypeError(f"unknown fault event {event!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of typed fault events.

    The plan is pure data: injectors below (and the recovery harness in
    :mod:`repro_torch.robustness.recovery`) interpret it.  ``generate`` derives
    every event from ``seed`` alone, so a plan is reproducible from one
    integer."""

    seed: int
    events: Tuple = ()

    def of(self, cls) -> List:
        return [e for e in self.events if isinstance(e, cls)]

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({kind_of(e) for e in self.events}))

    @classmethod
    def generate(cls, seed: int, kinds: Sequence[str] = ("engine-crash",
                                                         "kv-corruption"),
                 max_step: int = 8, n_events: int = 2) -> "FaultPlan":
        """Deterministic plan: ``n_events`` events drawn per requested kind
        at steps in ``[1, max_step]`` (sweep-side kinds are step-free)."""
        rng = np.random.default_rng(seed)
        events: List = []
        for k in kinds:
            if k == "backend-failure":
                events.append(BackendFailure(n_batches=1))
                continue
            if k == "cache-corruption":
                modes = ("truncate", "garbage", "schema")
                events.append(CacheCorruption(
                    n_entries=1, mode=modes[int(rng.integers(3))]))
                continue
            steps = sorted(set(int(s) for s in rng.integers(
                1, max_step + 1, size=n_events)))
            for s in steps:
                if k == "engine-crash":
                    events.append(EngineCrash(step=s))
                elif k == "kv-corruption":
                    events.append(KVCorruption(step=s, n_pages=int(
                        rng.integers(1, 3))))
                elif k == "page-loss":
                    events.append(PageLoss(step=s, n_pages=int(
                        rng.integers(1, 4))))
                elif k == "tlb-parity":
                    # vpn resolved later against a concrete trace
                    events.append(TLBParity(step=s, vpn=-1))
                else:
                    raise ValueError(f"unknown fault kind {k!r}")
        return cls(seed=seed, events=tuple(events))


# --------------------------------------------------------------------------
# Injectors
# --------------------------------------------------------------------------


def make_parity_world(base, trace: np.ndarray, seed: int,
                      n_faults: int = 3) -> Optional[ParityWorld]:
    """Wrap any base world in a :class:`ParityWorld` with a seeded fault
    schedule that is valid by construction: fault steps avoid position 0
    and the base world's own segment boundaries, and each fault poisons
    the translation of ``trace[step]`` — a page guaranteed mapped in the
    segment live at that step.  Returns None when the trace is too short
    to place any fault."""
    probe = ParityWorld(base=base, faults=())
    forbidden = set(probe.base_boundaries()) | {0}
    rng = np.random.default_rng(seed)
    T = int(trace.shape[0])
    steps: List[int] = []
    for s in rng.integers(1, max(T, 2), size=8 * n_faults):
        s = int(s)
        if s < T and s not in forbidden and s not in steps:
            steps.append(s)
        if len(steps) == n_faults:
            break
    if not steps:
        return None
    faults = tuple((s, int(trace[s])) for s in sorted(steps))
    return ParityWorld(base=base, faults=faults)


@contextlib.contextmanager
def backend_fault_injection(n_failures: int = 1,
                            backends: Tuple[str, ...] = ("cuda",),
                            predicate: Optional[Callable] = None):
    """Install a hook that makes the next ``n_failures`` matching sweep
    batches raise :class:`BackendFault`.

    ``backends`` scopes the failure by device type (default: only batches
    on the card fail, and ``run_sweep`` recovers by bisection).
    ``predicate(cells, backend)`` further narrows it — e.g. curse one
    specific cell so every batch containing it fails, forcing bisection
    down to the oracle.  Yields a stats dict counting injected failures."""
    from ..core import sweep as _sweep

    stats = {"injected": 0}
    remaining = [n_failures]

    def hook(cells, backend):
        if backend not in backends:
            return
        if predicate is not None and not predicate(cells, backend):
            return
        if remaining[0] <= 0:
            return
        remaining[0] -= 1
        stats["injected"] += 1
        raise BackendFault(
            f"injected {backend} failure ({stats['injected']}/{n_failures})")

    prev = _sweep._BACKEND_FAULT_HOOK
    _sweep._BACKEND_FAULT_HOOK = hook
    try:
        yield stats
    finally:
        _sweep._BACKEND_FAULT_HOOK = prev


def corrupt_cache_entry(path: str, mode: str = "truncate") -> None:
    """Damage one sweep-cache ``.npz`` file in place.

    ``truncate`` — cut the file mid-stream (torn write / partial disk);
    ``garbage``  — overwrite with non-zip bytes (bit rot);
    ``schema``   — a VALID npz missing the expected keys (stale layout
    from an older code version)."""
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00corrupt!" * 16)
    elif mode == "schema":
        tmp = path + ".tmp.npz"          # .npz suffix: savez keeps the name
        np.savez_compressed(tmp, wrong_key=np.zeros(3))
        os.replace(tmp, path)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


def corrupt_kv_pages(engine, pages: Sequence[int], value: float = 1e4
                     ) -> None:
    """Overwrite the KV-pool contents of ``pages`` with garbage across
    every attention position, in place (axis 1 of a pool
    ``[nsb, num_pages, page_size, KVH, D]`` is pages) — the physical damage
    a :class:`KVCorruption` event models.  Recovery is the engine's
    ``quarantine_pages``."""
    for st in engine.state.values():
        if isinstance(st, dict) and "pool_k" in st:
            for pool in ("pool_k", "pool_v"):
                p = st[pool]
                idx = torch.as_tensor(list(pages), dtype=torch.long,
                                      device=p.device)
                p[:, idx] = value
