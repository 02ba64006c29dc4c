"""Static contract checker for the port's TLB simulation and kernels.

The port's counterpart of the JAX package's ``src/repro/analysis/``: AST-based
analyses (and, for the CUDA sources, text analyses) that prove at lint
time what the parity tests prove dynamically — the pure-python oracle,
the plain torch lane program and the CUDA kernel stay registered,
dispatched and cache-keyed in sync, and every kernel source is in its
library's build key.  Stdlib-only by design — see
:mod:`repro_torch.analysis.framework` — and it imports no other module of
the port, so ``scripts/check_port_contracts.py`` loads it without the
package's ``__init__`` (which imports torch).

The JAX checker's traced-purity pass has no counterpart: it guards code
that ``jax.jit`` / ``pallas_call`` trace, and eager PyTorch traces
nothing.  The passes are documented in ``docs/port.md`` ("The port's
contract checker").
"""
from . import (pass_cache_key, pass_kind_dispatch, pass_latency,
               pass_plane_layout)
from .framework import (Finding, Repo, Suppression, has_errors,
                        load_suppressions, run_passes)
from .kinds import registered_kinds, spec_factories, undocumented_kinds

ALL_PASSES = (
    pass_kind_dispatch,
    pass_plane_layout,
    pass_latency,
    pass_cache_key,
)

PASS_BY_RULE = {p.RULE: p for p in ALL_PASSES}

__all__ = [
    "ALL_PASSES", "PASS_BY_RULE", "Finding", "Repo", "Suppression",
    "has_errors", "load_suppressions", "registered_kinds", "run_passes",
    "spec_factories", "undocumented_kinds",
]
