"""Workload-derived scenarios: mappings/traces recorded from the repo's own
serving and training stacks.

Unlike the synthetic families, these do not *model* contiguity — they run the
in-repo systems and record what their allocators and access loops actually
produce, the methodology of workload-driven translation studies (Victima,
subregion-contiguity; PAPERS.md):

* ``kv-churn`` / ``kv-churn-page`` — the paged KV cache under serving churn:
  requests admitted, grown page-by-page (``PagedKVAllocator.extend``),
  preempted under pool pressure and freed on completion, driven by the same
  :class:`repro_torch.serve.scheduler.KVScheduler` policy code the real
  ``ServingEngine`` uses.  The mapping is the live block tables (one
  power-of-two-aligned virtual region per batch slot, logical KV pages
  consecutive within it); the trace is the decode loop's per-step page sweep.
  ``-page`` uses the vLLM-style page-at-a-time policy (worst-case
  contiguity, the paper's Base analogue).
* ``kv-gather`` — same churned pool, but the trace follows the coalesced
  paged-attention kernel's DMA issue order: per class k (chosen by
  Algorithm 3 from the allocator's live histogram, descending) over that
  class's covered windows, then the class-0 leftovers — the gather order of
  ``repro_torch.kernels.paged_attention``.
* ``train-pipeline`` — the prefetching data pipeline's host batch buffers
  (the JAX package's ``data/pipeline.py``; the port keeps its batch shape
  as :class:`_PipelineShape`): a rolling ring of ``prefetch+1`` step
  buffers carved from a churned heap, producer writes interleaved with
  consumer reads.
* ``ckpt-shards`` — checkpoint save/restore (the JAX package's
  ``checkpoint`` layout): one buffer per pytree leaf (sizes derived from a real ``ModelConfig``),
  sequential save writes followed by elastic-restore reads where every leaf
  is read as ``n_devices`` interleaved shard streams (reshard-on-restore).

All builders are deterministic in the request seeds; churn statistics and
contiguity histograms are reported in ``ScenarioData.meta``.  A copy of
the JAX package's ``scenarios/workload.py``; the two scenario
descriptions that named JAX-package modules name them without the
package prefix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.page_table import (Mapping, contiguity_histogram, make_mapping,
                               next_pow2 as _next_pow2)
from ..kvcache.allocator import PagedKVAllocator
from ..kvcache.block_table import assign_classes, choose_kernel_classes
from ..serve.scheduler import KVScheduler
from .base import ScenarioData, ScenarioRequest, scenario

MAX_BATCH = 8          # batch slots of the churn driver
CHURN_STEPS = 96       # scheduler steps of warm-up churn before recording


def _episode_seed(req: ScenarioRequest) -> list:
    """Workload scenarios record ONE system episode: the mapping and the
    trace come out of the same run, so both seeds jointly seed it (a caller
    varying either gets an independent episode, never a silently identical
    one)."""
    return [req.map_seed, req.trace_seed]


# ---------------------------------------------------------------------------
# KV-cache serving churn
# ---------------------------------------------------------------------------


class _ChurnDriver:
    """Drives KVScheduler + PagedKVAllocator through serving churn.

    Requests are tracked in page units (tokens only matter to the allocator
    at page granularity): a request needs ``prompt`` pages at admission and
    grows by one page per step until ``target`` pages, then completes.
    Preemption is recompute-style: a victim re-enters the queue needing all
    pages it held (prompt absorbs generated state), mirroring
    ``ServingEngine._on_preempt``.
    """

    def __init__(self, pool_pages: int, alloc_policy: str, seed: int):
        self.rng = np.random.default_rng(seed)
        self.alloc = PagedKVAllocator(pool_pages, alloc_policy=alloc_policy)
        self.pool = self.alloc.buddy.n_frames
        self.sched = KVScheduler(self.alloc, MAX_BATCH)
        self.prompt: Dict[int, int] = {}
        self.target: Dict[int, int] = {}
        self._next_rid = 0
        self.extends = 0
        self.completions = 0

    def _draw_request(self) -> None:
        """Log-uniform prompt footprint (spans buddy orders → mixed
        contiguity) plus a short decode tail; one in four requests is a
        long-context outlier so the pool saturates and preemption fires."""
        cap = max(self.pool // 2, 8)
        if self.rng.random() < 0.25:
            p = int(self.rng.integers(cap // 2, cap + 1))
        else:
            p = int(2.0 ** self.rng.uniform(0.0, np.log2(cap // 2)))
        rid = self._next_rid
        self._next_rid += 1
        self.prompt[rid] = max(p, 1)
        self.target[rid] = self.prompt[rid] + int(self.rng.integers(1, 9))
        self.sched.enqueue(rid)

    def _preempt_cb(self, rid: int) -> None:
        self.prompt[rid] = max(len(self.alloc.seqs[rid].pages), 1)

    def step(self, allow_churn: bool = True) -> List[int]:
        """One scheduler iteration; returns the running set after admission.

        With ``allow_churn`` False (recording phase) nothing is preempted or
        freed: sequences at target simply stop growing, and extend failures
        cap growth instead of evicting a victim — the mapping only gains
        pages, so every recorded access exists in the final snapshot.
        """
        sched, alloc = self.sched, self.alloc
        if allow_churn:
            while len(sched.waiting) < 2:
                self._draw_request()
            sched.admit(lambda rid: self.prompt[rid],
                        on_preempt=self._preempt_cb)
        for rid in list(sched.running):
            if rid not in alloc.seqs:    # preempted by an earlier iteration
                continue
            held = len(alloc.seqs[rid].pages)
            if held >= self.target[rid]:
                if allow_churn:
                    sched.release(rid)
                    self.completions += 1
                continue
            if alloc.extend(rid, 1):
                self.extends += 1
                continue
            if allow_churn:
                others = [r for r in sched.running if r != rid]
                if others:
                    sched.preempt(others[-1], self._preempt_cb)
                    if alloc.extend(rid, 1):
                        self.extends += 1
                        continue
                # still no room: cap this sequence where it is
                self.target[rid] = held
            else:
                self.target[rid] = held
        return list(sched.running)

    def churn(self, steps: int = CHURN_STEPS) -> None:
        for _ in range(steps):
            self.step(allow_churn=True)
        # refill the batch so the recording phase always has live sequences
        # (the last churn step may have released everything it was running)
        while len(self.sched.waiting) < 2:
            self._draw_request()
        self.sched.admit(lambda rid: self.prompt[rid],
                         on_preempt=self._preempt_cb)

    # -- snapshotting -----------------------------------------------------
    def slot_stride(self) -> int:
        """Per-slot virtual region size: the next power of two of the
        largest live sequence (block tables are padded to a common shape in
        the engine; the pow-2 stride gives the natural VA alignment
        buddy/THP-style faulting would)."""
        longest = max((len(self.alloc.seqs[r].pages)
                       for r in self.sched.running), default=1)
        return _next_pow2(max(longest, 1))

    def snapshot_mapping(self, stride: int, name: str) -> Mapping:
        ppn = np.full(stride * MAX_BATCH, -1, dtype=np.int64)
        for rid in self.sched.running:
            s = self.sched.slot_of(rid)
            pages = np.asarray(self.alloc.seqs[rid].pages, dtype=np.int64)
            ppn[s * stride: s * stride + pages.shape[0]] = pages
        return make_mapping(ppn, name=name)


def _record_decode_sweep(drv: _ChurnDriver, trace_len: int
                         ) -> List[Tuple[int, int]]:
    """Decode-loop access order: per step, each running sequence reads its
    logical KV pages 0..len-1 in order (the block-table walk every decode
    step performs), while sequences keep growing page by page."""
    rec: List[Tuple[int, int]] = []
    guard = 0
    while len(rec) < trace_len and guard < 4 * trace_len + 64:
        for rid in drv.step(allow_churn=False):
            s = drv.sched.slot_of(rid)
            held = len(drv.alloc.seqs[rid].pages)
            rec.extend((s, j) for j in range(held))
            if len(rec) >= trace_len:
                break
        guard += max(sum(len(drv.alloc.seqs[r].pages)
                         for r in drv.sched.running), 1)
    return rec


def _record_gather_order(drv: _ChurnDriver, trace_len: int, stride: int
                         ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Kernel DMA issue order: Algorithm 3 picks K from the live histogram;
    each simulated decode step then visits, per class k descending, the
    class-k covered windows (whole 2^k-page superblock per descriptor) and
    finally the class-0 leftovers — the per-class pass structure of
    ``repro_torch.kernels.paged_attention``."""
    K = choose_kernel_classes(drv.alloc.contiguity_histogram(), psi=3) or [0]
    per_slot: List[Tuple[int, List[int]]] = []
    for rid in drv.sched.running:
        s = drv.sched.slot_of(rid)
        pages = drv.alloc.seqs[rid].pages
        bt = np.full(stride, -1, dtype=np.int64)
        bt[: len(pages)] = pages
        asg = assign_classes(bt, K)
        order: List[int] = []
        for k in sorted(asg, reverse=True):
            w = 1 << k
            for widx in np.flatnonzero(asg[k]):
                base = int(widx) * w if k > 0 else int(widx)
                order.extend(range(base, base + w) if k > 0 else [base])
        per_slot.append((s, order))
    step_rec: List[Tuple[int, int]] = []
    for s, order in per_slot:
        step_rec.extend((s, j) for j in order)
    rec: List[Tuple[int, int]] = []
    while len(rec) < trace_len and step_rec:
        rec.extend(step_rec)
    return rec, K


def _finish_kv(drv: _ChurnDriver, rec: List[Tuple[int, int]], name: str,
               req: ScenarioRequest, extra_meta: Optional[dict] = None
               ) -> ScenarioData:
    stride = drv.slot_stride()
    m = drv.snapshot_mapping(stride, name=name)
    if not rec:                      # degenerate tiny pools
        rec = [(drv.sched.slot_of(r), 0) for r in drv.sched.running] or [(0, 0)]
    arr = np.asarray(rec[: req.trace_len], dtype=np.int64)
    trace = arr[:, 0] * stride + arr[:, 1]
    meta = {"pool_pages": drv.pool,
            "live_seqs": len(drv.sched.running),
            "preemptions": drv.sched.preemptions,
            "extends": drv.extends,
            "completions": drv.completions,
            "utilization": round(drv.alloc.utilization(), 3),
            "contiguity_histogram": contiguity_histogram(m)}
    meta.update(extra_meta or {})
    return ScenarioData(name, m, trace, meta=meta)


def _kv_pool(req: ScenarioRequest) -> int:
    # n_pages budgets the physical pool; clamp so the python churn loop
    # stays cheap at --full scale and meaningful at --smoke scale
    return int(min(max(req.n_pages, 1 << 10), 1 << 17))


@scenario("kv-churn", family="workload",
          description="paged KV cache under serving churn "
                      "(buddy_best allocation, KVScheduler policy)",
          contiguity="mixed power-of-two buddy runs, fragmented by "
                     "preempt/free cycles")
def _kv_churn(req: ScenarioRequest) -> ScenarioData:
    drv = _ChurnDriver(_kv_pool(req), "buddy_best", _episode_seed(req))
    drv.churn()
    rec = _record_decode_sweep(drv, req.trace_len)
    return _finish_kv(drv, rec, "kv-churn", req)


@scenario("kv-churn-page", family="workload",
          description="paged KV cache under serving churn with vLLM-style "
                      "page-at-a-time allocation",
          contiguity="page-granular blocks: mostly small chunks, longer "
                     "runs only where the churned free list happens to be "
                     "consecutive")
def _kv_churn_page(req: ScenarioRequest) -> ScenarioData:
    drv = _ChurnDriver(_kv_pool(req), "page", _episode_seed(req))
    drv.churn()
    rec = _record_decode_sweep(drv, req.trace_len)
    return _finish_kv(drv, rec, "kv-churn-page", req)


@scenario("kv-gather", family="workload",
          description="coalesced paged-attention DMA gather order over the "
                      "churned KV pool (Algorithm 3 classes, per-class "
                      "descriptor passes)",
          contiguity="same mixed buddy runs as kv-churn; access order "
                     "grouped by alignment class")
def _kv_gather(req: ScenarioRequest) -> ScenarioData:
    drv = _ChurnDriver(_kv_pool(req), "buddy_best", _episode_seed(req))
    drv.churn()
    stride = drv.slot_stride()
    rec, K = _record_gather_order(drv, req.trace_len, stride)
    return _finish_kv(drv, rec, "kv-gather", req, extra_meta={"K": K})


# ---------------------------------------------------------------------------
# Training stack: data pipeline and checkpoint shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PipelineShape:
    """The fields of the JAX package's ``data.pipeline.PipelineConfig``
    that ``train-pipeline`` reads (the port has no data pipeline)."""

    batch: int
    seq: int
    seed: int = 0
    prefetch: int = 2


def _heap_alloc(alloc: PagedKVAllocator, rid: int, n_pages: int
                ) -> np.ndarray:
    """One host-heap buffer as a PagedKVAllocator sequence (the same
    largest-fit buddy policy the serving stack uses); freed via
    ``alloc.free(rid)``."""
    seq = alloc.allocate(rid, n_pages)
    if seq is None:
        raise RuntimeError("buddy pool exhausted")
    return np.asarray(seq.pages, dtype=np.int64)


@scenario("train-pipeline", family="workload",
          description="prefetching data pipeline's rolling ring of host "
                      "batch buffers (data.pipeline, prefetch=2, "
                      "seq-length-bucketed batches)",
          contiguity="per-buffer buddy extents of several bucket sizes; "
                     "heap reuse across the ring mixes them")
def _train_pipeline(req: ScenarioRequest) -> ScenarioData:
    pc = _PipelineShape(batch=8, seq=4096, seed=req.map_seed, prefetch=2)
    # one decoder batch = tokens + labels, int32 (see pipeline._batch_at);
    # batches are bucketed by padded sequence length, so buffer sizes vary
    full_pages = max((pc.batch * pc.seq * 2 * 4) // 4096, 4)
    buckets = [max(full_pages // d, 1) for d in (1, 2, 4, 3)]
    n_steps = max(req.n_pages // full_pages, pc.prefetch + 2)
    rng = np.random.default_rng(_episode_seed(req))
    heap = PagedKVAllocator(4 * full_pages * (pc.prefetch + 2), max_order=10)
    # heap warm-up: scattered small allocations fragment the pool the way a
    # long-running training process's host heap is
    n_warm = 4 * (pc.prefetch + 2)
    for i in range(n_warm):
        _heap_alloc(heap, -1 - i, int(rng.integers(1, 8)))
    for i in range(0, n_warm, 2):
        heap.free(-1 - i)

    ring: List[int] = []                        # live buffer rids, oldest 1st
    va_bases: List[int] = []
    sizes: List[int] = []
    phys: List[np.ndarray] = []
    va = 0
    rec: List[int] = []
    for step in range(n_steps):
        n = buckets[int(rng.integers(0, len(buckets)))]
        pages = _heap_alloc(heap, step, n)
        ring.append(step)
        a = _next_pow2(n)
        va = (va + a - 1) & ~(a - 1)
        va_bases.append(va)
        sizes.append(n)
        phys.append(pages)
        va += n
        # producer writes buffer `step`; consumer reads `step - prefetch`
        # concurrently (the host→device copy overlapping compute) —
        # interleave the two sequential streams
        writer = np.arange(n) + va_bases[step]
        if step >= pc.prefetch:
            prev = step - pc.prefetch
            reader = np.arange(sizes[prev]) + va_bases[prev]
            ln = max(writer.shape[0], reader.shape[0])
            inter = np.empty(2 * ln, dtype=np.int64)
            inter[0::2] = np.resize(writer, ln)
            inter[1::2] = np.resize(reader, ln)
            rec.extend(inter.tolist())
        else:
            rec.extend(writer.tolist())
        if len(ring) > pc.prefetch + 1:          # batch consumed: free it
            heap.free(ring.pop(0))
            # (physical pages recycled; the vpn keeps its last backing)
    ppn = np.full(va, -1, dtype=np.int64)
    for base, pages in zip(va_bases, phys):
        ppn[base: base + pages.shape[0]] = pages
    m = make_mapping(ppn, name="train-pipeline")
    trace = np.asarray(rec, dtype=np.int64)
    reps = -(-req.trace_len // max(trace.shape[0], 1))
    trace = np.tile(trace, reps)[: req.trace_len]
    return ScenarioData("train-pipeline", m, trace,
                        meta={"bucket_pages": buckets,
                              "steps": n_steps,
                              "contiguity_histogram":
                                  contiguity_histogram(m)})


def _model_leaf_pages(cap_pages: int) -> List[int]:
    """Per-leaf page counts of a real model's checkpoint (fp32), from the
    internlm2-1.8b ModelConfig, truncated to the ``cap_pages`` budget."""
    from ..configs import get_config
    cfg = get_config("internlm2-1.8b")
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    qh = cfg.n_heads * cfg.head_dim
    kvh = cfg.n_kv_heads * cfg.head_dim
    per_layer = [d * qh, d * kvh, d * kvh, qh * d,      # q k v o
                 d * dff, d * dff, dff * d,             # gate up down
                 d, d]                                  # norms
    elems = [v * d] + per_layer * cfg.n_layers + [d, v * d]
    pages = [max((e * 4) // 4096, 1) for e in elems]
    # scale the whole tree to the page budget so the structural mix (huge
    # matrices next to page-sized norm vectors) survives at any size
    scale = min(cap_pages / max(sum(pages), 1), 1.0)
    return [max(int(p * scale), 1) for p in pages]


@scenario("ckpt-shards", family="workload",
          description="checkpoint save + elastic restore: one buffer per "
                      "pytree leaf (checkpoint layout), leaves read "
                      "back as interleaved per-device shard streams",
          contiguity="large per-leaf extents (weight matrices) next to "
                     "page-sized norm leaves")
def _ckpt_shards(req: ScenarioRequest) -> ScenarioData:
    n_devices = 8
    leaf_pages = _model_leaf_pages(req.n_pages)
    rng = np.random.default_rng(_episode_seed(req))
    cache = PagedKVAllocator(4 * max(sum(leaf_pages), 1024), max_order=11)
    # page-cache churn before the save lands
    warm = list(range(-64, 0))
    for i in warm:
        _heap_alloc(cache, i, int(rng.integers(1, 16)))
    rng.shuffle(warm)
    for i in warm[: len(warm) // 2]:
        cache.free(i)

    va = 0
    va_bases: List[int] = []
    phys: List[np.ndarray] = []
    meta_rids: List[int] = []
    for leaf, n in enumerate(leaf_pages):
        pages = _heap_alloc(cache, leaf, n)
        a = _next_pow2(n)
        va = (va + a - 1) & ~(a - 1)
        va_bases.append(va)
        phys.append(pages)
        # leaves are separate .npy files: a guard page keeps their extents
        # from merging in VA, and the writer's interleaved metadata I/O
        # (manifest, dirents) punches small allocations between leaf extents
        va += n + 1
        rid = 100_000 + leaf
        _heap_alloc(cache, rid, int(rng.integers(1, 4)))
        meta_rids.append(rid)
        if len(meta_rids) > 4:
            cache.free(meta_rids.pop(0))
    ppn = np.full(va, -1, dtype=np.int64)
    for base, pages in zip(va_bases, phys):
        ppn[base: base + pages.shape[0]] = pages
    m = make_mapping(ppn, name="ckpt-shards")

    rec: List[int] = []
    # save: the serialization thread writes each leaf sequentially
    for base, n in zip(va_bases, leaf_pages):
        rec.extend(range(base, base + n))
    # elastic restore: each leaf is split into n_devices contiguous shards
    # read concurrently (device_put against the target mesh) — round-robin
    # across the shard streams; ceil-division so tail pages are covered
    for base, n in zip(va_bases, leaf_pages):
        shard = -(-n // n_devices)
        offs = [base + d * shard for d in range(n_devices) if d * shard < n]
        lens = [min(shard, base + n - o) for o in offs]
        for i in range(max(lens)):
            rec.extend(o + i for o, ln in zip(offs, lens) if i < ln)
    trace = np.asarray(rec, dtype=np.int64)
    reps = -(-req.trace_len // max(trace.shape[0], 1))
    trace = np.tile(trace, reps)[: req.trace_len]
    return ScenarioData("ckpt-shards", m, trace,
                        meta={"n_leaves": len(leaf_pages),
                              "n_devices": n_devices,
                              "contiguity_histogram":
                                  contiguity_histogram(m)})
