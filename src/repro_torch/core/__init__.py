"""Core library of the port: the K-bit Aligned TLB sweep on torch.

  * :mod:`repro_torch.core.page_table`   — contiguity-annotated page tables
  * :mod:`repro_torch.core.determine_k`  — Algorithm 3
  * :mod:`repro_torch.core.simulator`    — constants, MethodSpec, SimResult
  * :mod:`repro_torch.core.lane_program` — packing + the batched step
  * :mod:`repro_torch.core.sweep`        — the batched sweep (``run_sweep``)
  * :mod:`repro_torch.core.baselines`    — Base/THP/COLT/Cluster/RMM/Anchor specs
  * :mod:`repro_torch.core.mappings`     — Table-3 synthetic + demand mappings
  * :mod:`repro_torch.core.traces`       — benchmark access-pattern analogues

The sweep sits above the kernel package (``repro_torch.kernels``), which in
turn builds on the lane program, so this package does not import it:
``from repro_torch.core.sweep import SweepCell, run_sweep``.
"""
from .baselines import (anchor_spec, base_spec, cluster_spec, colt_spec,
                        kaligned_for_mapping, kaligned_spec, rmm_spec,
                        thp_spec)
from .determine_k import SIZE_RANGE_TABLE, determine_k, f_alignment
from .mappings import BuddyAllocator, demand_mapping, synthetic_mapping
from .page_table import (DynamicMapping, Mapping, MappingEvent,
                         MultiTenantMapping, build_dynamic_mapping,
                         build_multitenant_mapping, contiguity_histogram,
                         make_mapping)
from .simulator import MethodSpec, SimResult, miss_chain_cycles
from .traces import BENCHMARKS, benchmark_trace, generate_trace
