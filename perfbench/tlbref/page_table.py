"""Contiguity-annotated page table (paper §2, Definition 1 and §3.1).

A memory mapping for a process is modelled as a dense array ``ppn`` over a
virtual footprint of ``n_pages`` pages: ``ppn[vpn]`` is the physical page
number backing virtual page ``vpn`` (``-1`` = unmapped).

From ``ppn`` we derive, exactly as the paper's OS would by scanning the page
table:

* ``run_start[vpn]`` / ``run_len[vpn]``: the *contiguity chunk* (Def. 1)
  containing ``vpn`` — the maximal range of pages contiguous in both VA and
  PA.  The per-PTE ``contiguity`` field of §3.1 is
  ``run_start[vpn] + run_len[vpn] - vpn``.
* the contiguity-chunk list and the contiguity histogram used by Algorithm 3.

A frozen copy of the first part of ``src/repro_torch/core/page_table.py``:
the benchmark builds its input mappings with it.  Not to be edited.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

UNMAPPED = -1


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A virtual→physical page mapping with derived contiguity metadata."""

    ppn: np.ndarray        # int64[n_pages], -1 where unmapped
    run_start: np.ndarray  # int64[n_pages], start vpn of containing chunk
    run_len: np.ndarray    # int64[n_pages], size of containing chunk
    name: str = "mapping"

    @property
    def n_pages(self) -> int:
        return int(self.ppn.shape[0])

    def contiguity(self, vpn) -> np.ndarray:
        """Per-PTE contiguity field (§3.1): pages contiguously mapped starting
        at ``vpn``, *including* ``vpn`` itself.  0 for unmapped pages."""
        vpn = np.asarray(vpn)
        mapped = self.ppn[vpn] != UNMAPPED
        return np.where(mapped, self.run_start[vpn] + self.run_len[vpn] - vpn, 0)


def compute_runs(ppn: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized contiguity-chunk extraction.

    A chunk boundary occurs at ``i`` when ``ppn[i] != ppn[i-1] + 1`` or when
    either side is unmapped.
    """
    ppn = np.asarray(ppn, dtype=np.int64)
    n = ppn.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    mapped = ppn != UNMAPPED
    cont_with_prev = np.zeros(n, dtype=bool)
    cont_with_prev[1:] = mapped[1:] & mapped[:-1] & (ppn[1:] == ppn[:-1] + 1)
    # run id increments where a new run starts
    new_run = ~cont_with_prev
    run_id = np.cumsum(new_run) - 1
    starts = np.flatnonzero(new_run)
    run_start = starts[run_id]
    counts = np.bincount(run_id)
    run_len = counts[run_id]
    # unmapped pages belong to no chunk
    run_len = np.where(mapped, run_len, 0)
    run_start = np.where(mapped, run_start, np.arange(n))
    return run_start.astype(np.int64), run_len.astype(np.int64)


def make_mapping(ppn: np.ndarray, name: str = "mapping") -> Mapping:
    run_start, run_len = compute_runs(ppn)
    return Mapping(ppn=np.asarray(ppn, np.int64), run_start=run_start,
                   run_len=run_len, name=name)


def contiguity_chunks(m: Mapping) -> List[Tuple[int, int]]:
    """All contiguity chunks as ``(start_vpn, size)`` (Definition 1)."""
    mapped = m.ppn != UNMAPPED
    starts = np.unique(m.run_start[mapped])
    return [(int(s), int(m.run_len[s])) for s in starts]


def contiguity_histogram(m: Mapping) -> Dict[int, int]:
    """The OS-maintained contiguity histogram (paper §3.3): chunk size → count.

    Mirrors the structure consumed by Algorithm 3: a list of (size, freq).
    """
    chunks = contiguity_chunks(m)
    hist: Dict[int, int] = {}
    for _, size in chunks:
        hist[size] = hist.get(size, 0) + 1
    return hist
