"""Scenario registry: one interface over every (mapping, trace) source.

The paper's argument (§2, Figs 2–3) is that *real* applications produce
diverse, mixed contiguity that fixed-assumption coalescing schemes miss.
A :class:`Scenario` packages one source of that diversity — a synthetic
Table-3 family, a paper-benchmark analogue, a workload recorded from the
repo's own serving/training stack, or an adversarial generator — behind a
single call:

    from repro_torch.scenarios import get_scenario
    data = get_scenario("kv-churn").materialize(n_pages=1 << 15,
                                                trace_len=50_000)
    data.mapping   # page_table.Mapping (contiguity-annotated)
    data.trace     # int64[trace_len] VPN access trace
    data.meta      # scenario-specific provenance (histogram, churn stats…)

Materialization is **deterministic** in ``(name, n_pages, trace_len,
map_seed, trace_seed)``: two processes with the same arguments produce
bit-identical arrays, which is what makes the content-hash cache of
:func:`repro_torch.core.sweep.run_sweep` hit across runs.  Results are
memoized per-process so a sweep and a histogram sharing a scenario build
it once.

Register a new scenario with the :func:`scenario` decorator::

    @scenario("my-workload", family="workload",
              description="what it models",
              contiguity="expected chunk-size signature")
    def _build(req: ScenarioRequest) -> ScenarioData:
        ...

Importing :mod:`repro_torch.scenarios` registers all built-in families.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.page_table import (DynamicMapping, Mapping, MultiTenantMapping,
                               NestedMapping)

FAMILIES = ("synthetic", "workload", "adversarial", "dynamic", "multitenant",
            "accelerator", "nested")


@dataclasses.dataclass(frozen=True)
class ScenarioRequest:
    """Size/seed knobs passed to a scenario builder.

    ``n_pages`` is a *target or cap* on the mapped footprint: synthetic
    builders hit it exactly; workload builders treat it as the physical pool
    budget (the mapped footprint follows from the recorded workload); some
    scenarios pin their own mapping seed (see each builder's docstring).
    """

    n_pages: int = 1 << 16
    trace_len: int = 100_000
    map_seed: int = 0
    trace_seed: int = 0


@dataclasses.dataclass(frozen=True)
class ScenarioData:
    """A materialized scenario: simulator-ready mapping + VPN trace.

    :meth:`Scenario.materialize` memoizes and returns ONE shared instance
    per parameter set (with a read-only trace array), so consumers must
    treat it — including ``meta`` — as immutable.

    ``dynamic`` scenarios additionally carry the full
    :class:`~repro_torch.core.page_table.DynamicMapping` (epoch snapshots,
    event stream, trace-position boundaries); for them ``mapping`` is the
    epoch-0 snapshot (what the OS saw when it chose K), and each trace
    entry must be mapped in the epoch live at that step.  ``multitenant``
    scenarios carry a
    :class:`~repro_torch.core.page_table.MultiTenantMapping` (tenant address
    spaces + context-switch schedule with ASID assignments); ``mapping``
    is tenant 0's space and each trace entry must be mapped in the tenant
    scheduled at that step.  ``nested`` scenarios carry a
    :class:`~repro_torch.core.page_table.NestedMapping` (guest page tables
    composed over a host layer + a VM schedule); ``mapping`` is the first
    scheduled VM's initial composed view and each trace entry must be
    mapped in the composed view live at that step.  Sweep either by
    passing ``data.world`` (the segmented world when present, else the
    static mapping) to :class:`repro_torch.core.sweep.SweepCell`.
    """

    scenario: str
    mapping: Mapping
    trace: np.ndarray
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dynamic: Optional[DynamicMapping] = None
    multitenant: Optional[MultiTenantMapping] = None
    nested: Optional[NestedMapping] = None

    @property
    def world(self):
        """What to simulate: the segmented world when present, else static."""
        if self.dynamic is not None:
            return self.dynamic
        if self.multitenant is not None:
            return self.multitenant
        if self.nested is not None:
            return self.nested
        return self.mapping


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, documented (mapping, trace) source."""

    name: str
    family: str               # one of FAMILIES
    description: str
    contiguity: str           # one-line expected contiguity signature
    builder: Callable[[ScenarioRequest], ScenarioData]

    def materialize(self, n_pages: int = 1 << 16, trace_len: int = 100_000,
                    map_seed: int = 0, trace_seed: int = 0) -> ScenarioData:
        """Build (memoized) the mapping and trace for these parameters."""
        req = ScenarioRequest(n_pages=int(n_pages), trace_len=int(trace_len),
                              map_seed=int(map_seed),
                              trace_seed=int(trace_seed))
        key = (self.name, req)
        hit = _MATERIALIZED.get(key)
        if hit is None:
            hit = self.builder(req)
            assert hit.trace.ndim == 1
            trace = np.ascontiguousarray(hit.trace, dtype=np.int64)
            trace.setflags(write=False)
            hit = dataclasses.replace(hit, trace=trace)
            _MATERIALIZED[key] = hit
        return hit


_REGISTRY: Dict[str, Scenario] = {}
_MATERIALIZED: Dict[Tuple[str, ScenarioRequest], ScenarioData] = {}


def register(sc: Scenario) -> Scenario:
    if sc.family not in FAMILIES:
        raise ValueError(f"unknown scenario family: {sc.family}")
    if sc.name in _REGISTRY:
        raise ValueError(f"scenario already registered: {sc.name}")
    _REGISTRY[sc.name] = sc
    return sc


def scenario(name: str, family: str, description: str, contiguity: str):
    """Decorator form of :func:`register` for builder functions."""
    def deco(fn: Callable[[ScenarioRequest], ScenarioData]):
        register(Scenario(name=name, family=family, description=description,
                          contiguity=contiguity, builder=fn))
        return fn
    return deco


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") \
            from None


def list_scenarios(family: Optional[str] = None) -> List[Scenario]:
    """All registered scenarios (optionally one family), by name."""
    out = [sc for sc in _REGISTRY.values()
           if family is None or sc.family == family]
    return sorted(out, key=lambda sc: sc.name)


def clear_materialized_cache() -> None:
    """Drop the per-process memo (tests / memory pressure)."""
    _MATERIALIZED.clear()
