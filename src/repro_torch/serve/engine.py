"""Serving engine: continuous batching over a coalesced paged KV cache.

The port of the JAX package's ``serve/engine.py``.  Where the paper's
pieces meet end to end:

* the buddy :class:`PagedKVAllocator` produces mixed-contiguity block tables
  under admission/finish churn (the OS of §2);
* Algorithm 3 (``choose_kernel_classes``) picks the kernel classes K from
  the allocator's live contiguity histogram, re-evaluated when
  fragmentation drifts (a utilization-delta trigger);
* each decode step runs the class-k paged-attention kernel once per class
  and layer, reading each covered 2^k-page window through one descriptor;
* scheduler: FCFS admission with KV-capacity admission control,
  preempt-and-requeue on pool exhaustion (vLLM-style), per-step
  descriptor counts (the analogue of TLB-miss counts).

Attention positions of the model keep their K/V in the paged pools;
recurrent positions (Mamba, mLSTM, sLSTM) keep one state per batch slot,
which a request's prefill overwrites in its slot, as the JAX engine does.
A model with no attention position (xLSTM) serves with no pool and never
launches the paged kernel; the allocator's pages and the descriptor counts
are kept all the same, as the JAX engine keeps them.

The engine serves every decoding family; a VLM (``llava-next-34b``) is
served on text prompts, as the JAX engine serves it (it takes no
``patch_embeds``: ``Model.prefill`` does), and an encoder is refused, as
there.  The engine runs on the card unless ``device="cpu"`` is asked for
(then the paged op takes its plain version).  ``snapshot`` / ``restore``
checkpoint the whole engine through the port's ``Checkpointer`` for
crash-restart.  Of the JAX ``EngineConfig``, ``interpret`` (Pallas
interpret mode) has no meaning here and ``greedy`` is read nowhere
(decoding is greedy): both are dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.paged_attention.ops import build_descriptors, dma_stats
from ..kvcache.allocator import PagedKVAllocator
from ..kvcache.block_table import choose_kernel_classes
from ..models.common import tree_map
from ..models.model import (Model, attn_positions, block_period,
                            init_decode_state, n_superblocks)
from .scheduler import KVScheduler


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "waiting"          # waiting | running | done | preempted


@dataclasses.dataclass
class EngineConfig:
    page_size: int = 16
    num_pages: int = 512
    max_batch: int = 4
    max_seq: int = 512              # logical pages per seq = max_seq/page_size
    psi: int = 3                    # |K| bound for Algorithm 3
    refresh_util_delta: float = 0.15
    alloc_policy: str = "buddy_best"


class ServingEngine:
    def __init__(self, model: Model, params: Any, ec: EngineConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.ec = ec
        self.params = model.compute_params(
            tree_map(lambda a: a.to(self.device), params))
        assert self.cfg.family != "encoder", "encoder models don't decode"
        self.nsb = n_superblocks(self.cfg)
        self.period = block_period(self.cfg)
        self.attn = set(attn_positions(self.cfg))
        self.allocator = PagedKVAllocator(ec.num_pages,
                                          alloc_policy=ec.alloc_policy)
        self.sched = KVScheduler(self.allocator, ec.max_batch)
        self.K: List[int] = []
        self._k_util = 0.0
        self.requests: Dict[int, Request] = {}
        self._next_id = 0
        self.metrics: Dict[str, float] = {
            "steps": 0, "tokens": 0, "dma_descriptors": 0,
            "dma_descriptors_page_granular": 0, "preemptions": 0,
            "kv_quarantined_pages": 0}
        self._init_state()

    # ------------------------------------------------------------------
    def _init_state(self):
        """Pools for the attention positions, per-slot recurrent state (of
        ``init_decode_state``) for the others."""
        cfg, ec = self.cfg, self.ec
        shape = (self.nsb, ec.num_pages, ec.page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        dt = self.model.cdt
        rec = init_decode_state(cfg, ec.max_batch, 8, dt, self.device)
        self.state = {}
        for j in range(self.period):
            if j in self.attn:
                self.state[f"pos{j}"] = {
                    "pool_k": torch.zeros(shape, dtype=dt, device=self.device),
                    "pool_v": torch.zeros(shape, dtype=dt,
                                          device=self.device)}
            else:
                self.state[f"pos{j}"] = rec[f"pos{j}"]

    # ------------------------------------------------------------------
    def add_request(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        # An oversized request can never be served: its block table would
        # silently truncate past max_seq pages, and one whose page need
        # exceeds the whole pool live-locks admission forever (the FCFS
        # head retries every step, preempting the rest of the batch).
        # Reject at the door instead.
        total = len(prompt) + max_new_tokens
        if total > self.ec.max_seq:
            raise ValueError(
                f"request needs {total} tokens (prompt {len(prompt)} + "
                f"max_new_tokens {max_new_tokens}) but max_seq is "
                f"{self.ec.max_seq}")
        need = -(-total // self.ec.page_size)
        if need > self.ec.num_pages:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.ec.num_pages}: it could never be admitted")
        rid = self._next_id
        self._next_id += 1
        self.requests[rid] = Request(rid, [int(t) for t in prompt],
                                     max_new_tokens)
        self.sched.enqueue(rid)
        return rid

    @property
    def waiting(self):
        return self.sched.waiting

    @property
    def running(self) -> List[int]:
        return self.sched.running

    def _maybe_refresh_k(self):
        util = self.allocator.utilization()
        if not self.K or abs(util - self._k_util) > self.ec.refresh_util_delta:
            hist = self.allocator.contiguity_histogram()
            self.K = choose_kernel_classes(hist, psi=self.ec.psi) or [0]
            self._k_util = util

    def _need_pages(self, rid: int) -> int:
        req = self.requests[rid]
        return -(-(len(req.prompt) + req.max_new_tokens) // self.ec.page_size)

    def _admit(self):
        self.sched.admit(self._need_pages, on_admit=self._on_admit,
                         on_preempt=self._on_preempt)

    def _on_admit(self, rid: int) -> None:
        self.requests[rid].state = "running"
        self._prefill(rid)

    def _on_preempt(self, rid: int) -> None:
        """Recompute-style preemption bookkeeping: the victim keeps its
        ``generated`` list; on re-admission :meth:`_prefill` recomputes the
        KV for ``prompt + generated`` and decoding continues from there."""
        self.requests[rid].state = "preempted"
        self.metrics["preemptions"] += 1

    def _slot_of(self, rid: int) -> int:
        return self.sched.slot_of(rid)

    @torch.no_grad()
    def _prefill(self, rid: int):
        """Run prompt (+ any recompute-preempted generation) through the
        model, write its KV into the sequence's pages and its recurrent
        states into its batch slot."""
        req = self.requests[rid]
        toks_list = req.prompt + req.generated
        toks = torch.tensor([toks_list], dtype=torch.long, device=self.device)
        logits, states = self.model.prefill(self.params, toks)
        bt = self.allocator.block_table(rid, self.max_pages)
        T = self.ec.page_size
        S = len(toks_list)
        n_full = -(-S // T)
        pages = torch.from_numpy(bt[:n_full].astype(np.int64)).to(self.device)
        slot = self._slot_of(rid)
        for j in range(self.period):
            pos = f"pos{j}"
            if j not in self.attn:
                for key, val in states[pos].items():
                    self.state[pos][key][:, slot] = val[:, 0]
                continue
            for key, pool_key in (("k", "pool_k"), ("v", "pool_v")):
                kv = states[pos][key][:, 0, :S]          # [nsb, S, KVH, D]
                pool = self.state[pos][pool_key]
                padded = torch.zeros((self.nsb, n_full * T) + kv.shape[2:],
                                     dtype=pool.dtype, device=self.device)
                padded[:, :S] = kv
                pool[:, pages] = padded.reshape(self.nsb, n_full, T,
                                                *kv.shape[2:])
        # seed the first generated token greedily from the last position
        nxt = int(torch.argmax(logits[0, S - 1, : self.cfg.vocab]))
        req.generated.append(nxt)

    @property
    def max_pages(self) -> int:
        return self.ec.max_seq // self.ec.page_size

    def _reap_finished(self) -> None:
        """Release running requests that hit their token budget (a
        re-admitted preemption victim may reach it at prefill, before any
        decode step — decoding it again would append an extra token)."""
        for rid in list(self.running):
            req = self.requests[rid]
            if len(req.generated) >= req.max_new_tokens:
                req.state = "done"
                self.sched.release(rid)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """One engine iteration: admit, decode one token for all running."""
        self._admit()
        self._reap_finished()
        if not self.running:
            return bool(self.waiting)
        self._maybe_refresh_k()
        ec = self.ec
        B = ec.max_batch
        toks = np.zeros((B, 1), np.int64)
        lens = np.zeros((B,), np.int32)
        tables = np.full((B, self.max_pages), -1, np.int32)
        for rid in self.running:
            slot = self._slot_of(rid)
            req = self.requests[rid]
            toks[slot, 0] = req.generated[-1]
            lens[slot] = len(req.prompt) + len(req.generated) - 1
            tables[slot] = self.allocator.block_table(rid, self.max_pages)

        descriptors = build_descriptors(tables, self.K)
        st = dma_stats(tables, self.K)
        self.metrics["dma_descriptors"] += st["descriptors_coalesced"]
        self.metrics["dma_descriptors_page_granular"] += st["pages"]

        logits, self.state = self.model.decode_step_paged(
            self.params, self.state, torch.from_numpy(toks).to(self.device),
            lens, tables, descriptors, page_size=ec.page_size,
            K_classes=tuple(self.K))

        nxt = torch.argmax(logits[:, 0, : self.cfg.vocab], dim=-1).cpu()
        finished = []
        for rid in list(self.running):
            slot = self._slot_of(rid)
            req = self.requests[rid]
            req.generated.append(int(nxt[slot]))
            self.metrics["tokens"] += 1
            if len(req.generated) >= req.max_new_tokens:
                req.state = "done"
                finished.append(rid)
        for rid in finished:
            self.sched.release(rid)
        self.metrics["steps"] += 1
        return bool(self.running or self.waiting)

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[str, float]:
        for _ in range(max_steps):
            if not self.step():
                break
        m = dict(self.metrics)
        # max_steps exhaustion must never be silent: `stalled` counts the
        # requests still waiting/running when the loop gave up (0 = drained)
        m["stalled"] = len(self.waiting) + len(self.running)
        pg = m["dma_descriptors_page_granular"]
        m["descriptor_reduction"] = 1.0 - m["dma_descriptors"] / max(pg, 1)
        m["K"] = list(self.K)
        return m

    # ------------------------------------------------------------------
    # Robustness: crash-restart checkpoints and KV-page quarantine
    # ------------------------------------------------------------------
    def snapshot(self, ckpt_dir: str, step: int = None) -> int:
        """Checkpoint the complete engine state: the KV pools and per-slot
        recurrent state through the atomic
        :class:`~repro_torch.checkpoint.checkpointer.Checkpointer`, the
        request/scheduler/allocator bookkeeping in its ``extras``.  A fresh
        engine built from the same (model, params, config) continues
        token-exactly from it after :meth:`restore`."""
        from ..checkpoint.checkpointer import Checkpointer
        extras = dict(
            requests={str(r): dict(prompt=[int(t) for t in q.prompt],
                                   max_new_tokens=int(q.max_new_tokens),
                                   generated=[int(t) for t in q.generated],
                                   state=q.state)
                      for r, q in self.requests.items()},
            scheduler=self.sched.snapshot_state(),
            allocator=self.allocator.snapshot_state(),
            K=list(self.K), k_util=self._k_util, next_id=self._next_id,
            metrics=dict(self.metrics))
        step = int(self.metrics["steps"]) if step is None else int(step)
        Checkpointer(ckpt_dir).save(step, self.state, extras, blocking=True)
        return step

    def restore(self, ckpt_dir: str, step: int = None) -> int:
        """Reload a :meth:`snapshot` into this engine (crash-restart): each
        saved tensor is copied into the engine's own state tensor on its
        device.  Returns the engine step the snapshot was taken at."""
        from ..checkpoint.checkpointer import Checkpointer, leaf_paths
        tree, extras = Checkpointer(ckpt_dir).restore(step, target=self.state,
                                                      device="cpu")
        for (path, dst), (_, src) in zip(leaf_paths(self.state),
                                         leaf_paths(tree)):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"checkpoint leaf {path}: {src.dtype} "
                                 f"{tuple(src.shape)}, the engine's "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
        self.requests = {
            int(r): Request(int(r), [int(t) for t in d["prompt"]],
                            int(d["max_new_tokens"]),
                            [int(t) for t in d["generated"]], d["state"])
            for r, d in extras["requests"].items()}
        self.sched.restore_state(extras["scheduler"])
        self.allocator.restore_state(extras["allocator"])
        self.K = [int(k) for k in extras["K"]]
        self._k_util = float(extras["k_util"])
        self._next_id = int(extras["next_id"])
        self.metrics = dict(extras["metrics"])
        return int(extras["metrics"]["steps"])

    def quarantine_pages(self, pages) -> List[int]:
        """Corrupted-KV-page recovery: recompute-preempt every owning
        request (its ``generated`` tokens are kept, so re-prefill rebuilds
        the exact KV the corrupted pages held), then retire the poisoned
        physical pages from the pool permanently so re-admission cannot
        land on them.  Returns the preempted request ids."""
        owners = self.allocator.owners_of(pages)
        for rid in owners:
            self.sched.preempt(rid, self._on_preempt)
        retired = self.allocator.retire_pages(pages)
        self.metrics["kv_quarantined_pages"] += len(retired)
        return owners
