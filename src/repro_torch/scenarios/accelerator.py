"""Accelerator-concurrency scenarios: the kv-gather recording replayed at
high-throughput-processor scale.

The accelerator-lineage translation schemes (subregion TLBs for
high-throughput processors, cache-backed reach extension, dead-entry
protection — see ``docs/methods.md``) were motivated by workloads where
hundreds to thousands of concurrent streams share one translation
structure, shredding the locality a CPU-scale TLB relies on.  The
``accel-gather`` family reproduces that pressure from the repo's own
serving stack: it records the SAME coalesced paged-attention DMA issue
order as ``kv-gather`` (one churned :class:`~repro_torch.kvcache.allocator.\
PagedKVAllocator` episode, Algorithm-3 class passes), then splits the
recording into ``conc`` equal contiguous chunks — one per concurrent
gather stream — and interleaves them round-robin, page by page.  Each
chunk keeps its in-stream issue order, but consecutive *TLB* accesses now
come from ``conc`` different streams: per-stream spatial locality is
diluted by exactly the concurrency factor while the page working set and
its contiguity histogram stay identical to ``kv-gather``.

Determinism: the episode is seeded by ``(map_seed, trace_seed)`` exactly
like ``kv-gather`` (same seeds → bit-identical mapping AND recording),
and the chunk/interleave shuffle is a pure function of the recording
length and ``conc`` — no extra randomness.  The concurrency knob is the
scenario name (``accel-gather-x64/-x256/-x1024``); all variants of one
seed pair share one churn episode via the materialization memo.
"""
from __future__ import annotations

import numpy as np

from ..core.page_table import contiguity_histogram
from .base import ScenarioData, ScenarioRequest, scenario
from .workload import (_ChurnDriver, _episode_seed, _kv_pool,
                       _record_gather_order)


def _interleave_streams(trace: np.ndarray, conc: int) -> np.ndarray:
    """Round-robin interleave of ``conc`` contiguous chunks of ``trace``.

    Chunk ``s`` models stream ``s``'s issue queue; the interleave is the
    order a shared translation structure services them.  Ceil-division
    sizing pads the last chunks by wrapping (streams loop their gather),
    keeping the output the same length as the input.
    """
    n = trace.shape[0]
    conc = max(min(conc, n), 1)
    chunk = -(-n // conc)
    idx = np.arange(conc * chunk)
    # position j of the interleave reads chunk (j % conc) at offset
    # (j // conc); wrap offsets past a chunk's real end back onto it
    src = (idx % conc) * chunk + (idx // conc)
    return trace[src % n][:n]


def _accel_gather(req: ScenarioRequest, conc: int, name: str) -> ScenarioData:
    drv = _ChurnDriver(_kv_pool(req), "buddy_best", _episode_seed(req))
    drv.churn()
    stride = drv.slot_stride()
    rec, K = _record_gather_order(drv, req.trace_len, stride)
    m = drv.snapshot_mapping(stride, name=name)
    if not rec:                      # degenerate tiny pools
        rec = [(drv.sched.slot_of(r), 0)
               for r in drv.sched.running] or [(0, 0)]
    arr = np.asarray(rec[: req.trace_len], dtype=np.int64)
    flat = arr[:, 0] * stride + arr[:, 1]
    trace = _interleave_streams(flat, conc)
    meta = {"pool_pages": drv.pool,
            "live_seqs": len(drv.sched.running),
            "concurrency": conc,
            "K": K,
            "utilization": round(drv.alloc.utilization(), 3),
            "contiguity_histogram": contiguity_histogram(m)}
    return ScenarioData(name, m, trace, meta=meta)


def _register(conc: int):
    @scenario(f"accel-gather-x{conc}", family="accelerator",
              description=f"kv-gather DMA recording interleaved as {conc} "
                          "concurrent gather streams sharing one TLB",
              contiguity="kv-gather's mixed buddy runs; per-stream "
                         "locality diluted by the concurrency factor")
    def _build(req: ScenarioRequest, _conc=conc) -> ScenarioData:
        return _accel_gather(req, _conc, f"accel-gather-x{_conc}")
    return _build


for _conc in (64, 256, 1024):
    _register(_conc)
