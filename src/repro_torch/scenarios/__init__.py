"""Scenario registry: every (mapping, trace) source behind one interface.

A copy of the JAX package's ``scenarios`` package (numpy and pure python
over the port's ``core``, ``kvcache`` and ``serve.scheduler``): the same
registry names, the same builders, the same arrays for the same seeds.
See :mod:`repro_torch.scenarios.base` for the model and
``docs/scenarios.md`` for the catalogue.  Importing this package registers all built-in families:
synthetic (Table-3 families, demand paging, paper-benchmark analogues),
workload-derived (KV-cache serving churn, paged-attention gather order,
training data pipeline, checkpoint shards), adversarial (compaction,
THP splitting, NUMA interleave), dynamic (live mapping-event streams),
multitenant (ASID-tagged address spaces under KVScheduler-derived
context-switch schedules), accelerator (the kv-gather recording
interleaved at accelerator concurrency), and nested (guest→host two-level
translation worlds with host-side remap storms).
"""
from . import (accelerator, adversarial, dynamic, multitenant,  # noqa: F401
               nested, synthetic, workload)
from .base import (FAMILIES, Scenario, ScenarioData, ScenarioRequest,
                   clear_materialized_cache, get_scenario, list_scenarios,
                   register, scenario)

__all__ = [
    "FAMILIES", "Scenario", "ScenarioData", "ScenarioRequest",
    "clear_materialized_cache", "get_scenario", "list_scenarios",
    "register", "scenario",
]
