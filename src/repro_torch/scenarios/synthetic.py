"""Synthetic scenario families: the paper's own mapping/trace analogues.

These wrap :mod:`repro_torch.core.mappings` and
:mod:`repro_torch.core.traces` behind the registry with **exact parity**:
for equal seeds, ``synth-*``/``demand*`` materialize the same arrays as
the direct two-liner and as the JAX package's registry (enforced by
``tests/test_torch_scenarios.py``), so sweep-cache keys are stable.

* ``synth-{small,medium,large,mixed}`` — Table 3 chunk-size families over a
  multiscale reuse trace (the Table 4 rows).
* ``demand`` / ``demand-thp``        — churned buddy-allocator demand paging
  (Fig 8 / Table 4 "Real Mapping").
* ``paper-<bench>``                  — one per paper benchmark (Figure 8):
  the benchmark's access-pattern analogue over a demand mapping whose seed is
  pinned per benchmark (``crc32(name) % 1000``, process-independent so the
  sweep cache works across runs).  ``map_seed`` is ignored; ``n_pages`` caps
  the declared paper footprint.
"""
from __future__ import annotations

import zlib

from ..core.mappings import demand_mapping, synthetic_mapping
from ..core.traces import BENCHMARKS, generate_trace
from .base import ScenarioData, ScenarioRequest, scenario

SYNTH_KINDS = ("small", "medium", "large", "mixed")


def _register_synth(kind: str) -> None:
    @scenario(f"synth-{kind}", family="synthetic",
              description=f"Table 3 '{kind}' chunk-size family, "
                          "multiscale reuse trace",
              contiguity={"small": "chunks of 1–63 pages",
                          "medium": "chunks of 64–511 pages",
                          "large": "chunks of 512–1024 pages",
                          "mixed": "0.4 small + 0.4 medium + 0.2 large",
                          }[kind])
    def _build(req: ScenarioRequest, kind: str = kind) -> ScenarioData:
        m = synthetic_mapping(kind, req.n_pages, seed=req.map_seed)
        tr = generate_trace("multiscale", 0, req.trace_len,
                            seed=req.trace_seed, mapping=m)
        return ScenarioData(f"synth-{kind}", m, tr)


for _kind in SYNTH_KINDS:
    _register_synth(_kind)


def _register_demand(thp: bool) -> None:
    name = "demand-thp" if thp else "demand"
    @scenario(name, family="synthetic",
              description="churned buddy-allocator demand paging"
                          + (" with THP-preferring order-9 requests"
                             if thp else ""),
              contiguity="power-of-two buddy runs, sizes mixed by churn"
                         + ("; mostly 512-page blocks" if thp else ""))
    def _build(req: ScenarioRequest, thp: bool = thp) -> ScenarioData:
        m = demand_mapping(req.n_pages, seed=req.map_seed, thp=thp)
        tr = generate_trace("multiscale", 0, req.trace_len,
                            seed=req.trace_seed, mapping=m)
        return ScenarioData(name, m, tr)


_register_demand(False)
_register_demand(True)


def paper_bench_seed(name: str) -> int:
    """Stable per-benchmark mapping seed (process-independent, unlike
    ``hash(name)``, so the sweep cache works across runs)."""
    return zlib.crc32(name.encode()) % 1000


def _register_paper_bench(bname: str) -> None:
    pattern, footprint = BENCHMARKS[bname]

    @scenario(f"paper-{bname}", family="synthetic",
              description=f"paper benchmark analogue '{bname}' "
                          f"({pattern} pattern) over a demand mapping",
              contiguity="demand-paged buddy runs over "
                         f"a {footprint}-page footprint")
    def _build(req: ScenarioRequest, bname: str = bname,
               pattern: str = pattern, footprint: int = footprint
               ) -> ScenarioData:
        n = min(footprint, req.n_pages)
        m = demand_mapping(n, seed=paper_bench_seed(bname))
        tr = generate_trace(pattern, 0, req.trace_len,
                            seed=req.trace_seed, mapping=m)
        return ScenarioData(f"paper-{bname}", m, tr,
                            meta={"pattern": pattern,
                                  "paper_footprint": footprint})


for _bname in BENCHMARKS:
    _register_paper_bench(_bname)
