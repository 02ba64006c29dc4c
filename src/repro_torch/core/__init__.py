"""Core library of the port: the K-bit Aligned TLB sweep on torch.

  * :mod:`repro_torch.core.page_table`   — contiguity-annotated page tables
  * :mod:`repro_torch.core.aligned`      — K-bit aligned entries, Alg. 1-2
  * :mod:`repro_torch.core.determine_k`  — Algorithm 3
  * :mod:`repro_torch.core.simulator`    — constants, MethodSpec, SimResult,
    ``run_method`` and the pure-python segment oracle
  * :mod:`repro_torch.core.lane_program` — packing + the batched step
  * :mod:`repro_torch.core.sweep`        — the batched sweep (``run_sweep``)
  * :mod:`repro_torch.core.baselines`    — Base/THP/COLT/Cluster/RMM/Anchor
    specs, ``anchor_static``, ``standard_suite``
  * :mod:`repro_torch.core.mappings`     — Table-3 synthetic + demand mappings
  * :mod:`repro_torch.core.traces`       — benchmark access-pattern analogues

The sweep sits above the kernel package (``repro_torch.kernels``), which in
turn builds on the lane program, so this package does not import it:
``from repro_torch.core.sweep import SweepCell, run_sweep``.
"""
from .aligned import (Entry, ReferenceTLB, aligned_lookup, aligned_vpn,
                      alignment_class, covers, fill_select,
                      simulate_reference, stored_contiguity)
from .baselines import (ANCHOR_GRID, anchor_spec, anchor_static, base_spec,
                        cluster_spec, colt_spec, kaligned_for_mapping,
                        kaligned_spec, rmm_spec, standard_suite, thp_spec)
from .determine_k import SIZE_RANGE_TABLE, determine_k, f_alignment
from .mappings import BuddyAllocator, demand_mapping, synthetic_mapping
from .page_table import (DynamicMapping, Mapping, MappingEvent,
                         MultiTenantMapping, apply_event,
                         build_dynamic_mapping, build_multitenant_mapping,
                         compute_runs, contiguity_chunks,
                         contiguity_histogram, dynamic_from_snapshots,
                         events_from_diff, huge_page_backed, make_mapping)
from .simulator import (MethodSpec, SimResult, miss_chain_cycles, run_method,
                        run_method_dynamic, run_method_multitenant,
                        run_method_nested, run_method_parity)
from .traces import BENCHMARKS, benchmark_trace, generate_trace
