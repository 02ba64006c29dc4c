"""Paged KV-cache physical allocator — a copy of the JAX package's
``kvcache/allocator.py`` (numpy only).

A binary-buddy allocator over the physical KV page pool — deliberately the
same mechanism as :class:`repro_torch.core.mappings.BuddyAllocator`,
because the paper's whole premise is that buddy allocation under churn
produces *mixed contiguity* (§2): fresh pools serve large aligned runs
(large contiguity), long-running serving workloads fragment them
(small/medium contiguity).

Buddy blocks of order k are 2^k-aligned in the pool, which is exactly the
alignment the class-k paged-attention kernel needs: it reads a window as
one contiguous ``2^k``-page run at window index ``phys_start >> k``
(``repro_torch.kernels.paged_attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.mappings import BuddyAllocator
from ..core.page_table import compute_runs


@dataclasses.dataclass
class SeqAlloc:
    """Block table of one sequence: logical KV page → physical page."""
    seq_id: int
    pages: List[int]                 # physical page ids, logical order
    blocks: List[tuple]              # (base, order) buddy blocks held


class PagedKVAllocator:
    """Allocates physical KV pages for sequences; tracks contiguity.

    ``alloc_policy``:
      * "buddy_best"  — largest buddy block ≤ remaining need (default; gives
        the large/mixed contiguity the coalesced kernel exploits)
      * "page"        — page-at-a-time (vLLM-style; worst-case contiguity,
        the baseline the paper compares against)
    """

    def __init__(self, num_pages: int, max_order: int = 8,
                 alloc_policy: str = "buddy_best"):
        self.num_pages = num_pages
        max_order = min(max_order, int(np.floor(np.log2(max(num_pages, 1)))))
        self.max_order = max_order
        self.policy = alloc_policy
        self.buddy = BuddyAllocator(num_pages, max_order=max_order)
        assert self.buddy.n_frames > 0, "pool smaller than one buddy block"
        self.seqs: Dict[int, SeqAlloc] = {}

    # ------------------------------------------------------------------
    def allocate(self, seq_id: int, n_pages: int) -> Optional[SeqAlloc]:
        if seq_id in self.seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        alloc = SeqAlloc(seq_id, [], [])
        need = n_pages
        while need > 0:
            if self.policy == "page":
                order = 0
            else:
                order = min(int(np.floor(np.log2(max(need, 1)))),
                            self.max_order)
            base = None
            while base is None and order >= 0:
                base = self.buddy.alloc(order)
                if base is None:
                    order -= 1
            if base is None:
                # rollback: the seq is not registered yet, so return its
                # partial blocks to the buddy directly (self.free would be a
                # no-op here and leak them)
                for b, o in alloc.blocks:
                    self.buddy.free_block(b, o)
                return None
            take = min(1 << order, need)
            alloc.blocks.append((base, order))
            alloc.pages.extend(range(base, base + take))
            # unused tail of the block stays held (internal fragmentation,
            # as in real pools); freed with the sequence.
            need -= take
        self.seqs[seq_id] = alloc
        return alloc

    def extend(self, seq_id: int, n_pages: int) -> bool:
        """Append pages to a sequence (decode growth)."""
        alloc = self.seqs[seq_id]
        need = n_pages
        while need > 0:
            order = 0 if self.policy == "page" else min(
                int(np.floor(np.log2(max(need, 1)))), self.max_order)
            base = None
            while base is None and order >= 0:
                base = self.buddy.alloc(order)
                if base is None:
                    order -= 1
            if base is None:
                return False
            take = min(1 << order, need)
            alloc.blocks.append((base, order))
            alloc.pages.extend(range(base, base + take))
            need -= take
        return True

    def free(self, seq_id: int) -> None:
        alloc = self.seqs.pop(seq_id, None)
        if alloc is None:
            return
        for base, order in alloc.blocks:
            self.buddy.free_block(base, order)

    # ------------------------------------------------------------------
    def block_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Padded block table (−1 beyond the sequence)."""
        pages = self.seqs[seq_id].pages
        out = np.full(max_pages, -1, dtype=np.int32)
        out[: len(pages)] = pages[:max_pages]
        return out

    def contiguity_histogram(self) -> Dict[int, int]:
        """Chunk-size histogram over all live block tables (input to
        Algorithm 3 for choosing the kernel's K classes)."""
        hist: Dict[int, int] = {}
        for alloc in self.seqs.values():
            phys = np.asarray(alloc.pages, dtype=np.int64)
            if len(phys) == 0:
                continue
            _, run_len = compute_runs(phys)
            starts = np.flatnonzero(np.diff(np.concatenate(
                [[-2], phys])) != 1)
            for s in starts:
                size = int(run_len[s])
                hist[size] = hist.get(size, 0) + 1
        return hist

    def utilization(self) -> float:
        free, _ = self.buddy.frag_stats()
        return 1.0 - free / max(self.buddy.n_frames, 1)

    # ------------------------------------------------------------------
    # Robustness: crash-restart snapshots and bad-page retirement
    # ------------------------------------------------------------------
    def snapshot_state(self) -> Dict:
        """Complete mutable state as a JSON-serializable dict (sequence
        block tables + buddy free lists) for engine checkpoints."""
        return dict(
            seqs={str(r): dict(pages=list(a.pages),
                               blocks=[[int(b), int(o)] for b, o in a.blocks])
                  for r, a in self.seqs.items()},
            free=self.buddy.snapshot())

    def restore_state(self, snap: Dict) -> None:
        self.buddy.restore(snap["free"])
        self.seqs = {
            int(r): SeqAlloc(int(r), [int(p) for p in d["pages"]],
                             [(int(b), int(o)) for b, o in d["blocks"]])
            for r, d in snap["seqs"].items()}

    def owners_of(self, pages) -> List[int]:
        """Sequence ids whose block tables touch any of ``pages``."""
        bad = set(int(p) for p in pages)
        return sorted(r for r, a in self.seqs.items() if bad & set(a.pages))

    def retire_pages(self, pages) -> List[int]:
        """Permanently remove FREE physical pages from the pool (corrupted
        KV backing store).  Owned pages are skipped — free the owning
        sequence first (quarantine-and-recompute does).  Returns the pages
        actually retired."""
        return [int(p) for p in pages if self.buddy.retire(int(p))]
