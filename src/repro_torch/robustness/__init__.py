"""Chaos harness of the port: deterministic fault injection + recovery
policies, the JAX package's ``robustness`` on torch.

:mod:`.faults` holds the fault taxonomy and the injectors, :mod:`.recovery`
the policies; :mod:`.chaos` (imported on its own: it pulls in the models)
runs the chaos bench's rows.  Nothing here imports JAX."""
from .faults import (BackendFailure, BackendFault, CacheCorruption,
                     EngineCrash, FAULT_KINDS, FaultPlan, KVCorruption,
                     PageLoss, TLBParity, backend_fault_injection,
                     corrupt_cache_entry, corrupt_kv_pages, kind_of,
                     make_parity_world)
from .recovery import RecoveryError, retry_with_backoff, \
    run_engine_with_recovery

__all__ = [
    "BackendFailure", "BackendFault", "CacheCorruption", "EngineCrash",
    "FAULT_KINDS", "FaultPlan", "KVCorruption", "PageLoss", "TLBParity",
    "backend_fault_injection", "corrupt_cache_entry", "corrupt_kv_pages",
    "kind_of", "make_parity_world", "RecoveryError", "retry_with_backoff",
    "run_engine_with_recovery",
]
