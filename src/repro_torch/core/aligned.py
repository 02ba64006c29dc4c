"""K-bit aligned page-table entries — reference semantics (paper §3.1–3.2).

A copy of the JAX package's ``core/aligned.py`` (plain python, no
framework).  This module is the *pure-python oracle* for the batched
simulator behind :mod:`repro_torch.core.simulator` and for the
device-side translation used by the paged KV cache.  Every rule here is
deliberately written as close to the paper's prose as possible.

Notes on fidelity:

* **Rightward Compatible Rule** — an entry aligned for several k ∈ K is
  labelled with the maximum such k (`alignment_class`).
* **Stored contiguity** — a k-bit aligned entry records the number of pages
  contiguously mapped in the following 2^k pages *including itself*
  (`stored_contiguity`), i.e. ``min(contiguity(vpn_k), 2**k)``.
* **Coverage test** — the paper's Algorithms 1–2 write
  ``Entry.contiguity >= (VPN - VPN_k)``; with contiguity *including* the
  aligned page itself (Fig. 4/5: VPN 8 covers VPN 13 with contiguity 6,
  diff 5) the consistent test is ``contiguity > diff``.  We implement
  ``contiguity > diff`` and treat the paper's ``>=`` as an off-by-one in the
  pseudo-code; all of the paper's worked examples agree with ``>``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from .page_table import Mapping, UNMAPPED

REGULAR = -1  # k-class tag for a non-coalesced entry


def aligned_vpn(vpn: int, k: int) -> int:
    """Clear the k LSBs of vpn (the k-bit aligned VPN)."""
    return vpn & ~((1 << k) - 1)


def alignment_class(vpn: int, K: Sequence[int]) -> int:
    """Rightward Compatible Rule: the max k in K for which vpn is k-aligned;
    REGULAR (-1) if none."""
    best = REGULAR
    for k in K:
        if vpn & ((1 << k) - 1) == 0 and k > best:
            best = k
    return best


def stored_contiguity(m: Mapping, vpn_k: int, k: int) -> int:
    """Contiguity recorded by the k-bit aligned entry at vpn_k (§3.1)."""
    if vpn_k >= m.n_pages or m.ppn[vpn_k] == UNMAPPED:
        return 0
    return int(min(m.contiguity(vpn_k), 1 << k))


def covers(m: Mapping, vpn: int, vpn_k: int, k: int) -> bool:
    """Does the aligned entry at (vpn_k, k) translate vpn?"""
    return stored_contiguity(m, vpn_k, k) > (vpn - vpn_k)


@dataclasses.dataclass(frozen=True)
class Entry:
    """A (possibly coalesced) translation entry as held in the L2 TLB."""

    tag: int          # vpn of the entry (aligned vpn for k >= 0)
    kcls: int         # alignment class; REGULAR for a plain 4KB entry
    contiguity: int   # pages covered starting at tag (1 for regular)
    ppn: int          # physical page of `tag`

    def translate(self, vpn: int) -> Optional[int]:
        diff = vpn - self.tag
        if 0 <= diff < self.contiguity:
            return self.ppn + diff
        return None


def fill_select(m: Mapping, vpn: int, K: Sequence[int]) -> Entry:
    """Algorithm 1 — choose the entry inserted into L2 after a page walk.

    Probes aligned entries in descending k and returns the first whose stored
    contiguity covers ``vpn``; otherwise the regular entry for ``vpn``.
    """
    for k in sorted(K, reverse=True):
        vk = aligned_vpn(vpn, k)
        if covers(m, vpn, vk, k):
            return Entry(tag=vk, kcls=k,
                         contiguity=stored_contiguity(m, vk, k),
                         ppn=int(m.ppn[vk]))
    return Entry(tag=vpn, kcls=REGULAR, contiguity=1, ppn=int(m.ppn[vpn]))


def aligned_lookup(entries: Sequence[Entry], vpn: int, K: Sequence[int],
                   first_k: Optional[int] = None) -> Tuple[Optional[int], int, Optional[int]]:
    """Algorithm 2 — aligned lookup over a set of resident entries.

    Probes alignments ``first_k`` (the predictor's guess, §3.2) then the rest
    of K in descending order.  Returns ``(ppn | None, n_probes, hit_k)``.
    """
    order: List[int] = []
    if first_k is not None and first_k in K:
        order.append(first_k)
    order += [k for k in sorted(K, reverse=True) if k not in order]
    probes = 0
    for k in order:
        probes += 1
        vk = aligned_vpn(vpn, k)
        for e in entries:
            if e.kcls == k and e.tag == vk and e.contiguity > (vpn - vk):
                return e.ppn + (vpn - vk), probes, k
    return None, probes, None


class ReferenceTLB:
    """Fully-associative LRU TLB over :class:`Entry` — the miss-count oracle.

    Set-associativity is modelled by the batched engine; this reference uses
    full associativity so property tests can check *translation correctness* and
    upper-bound behaviour of the engine independent of set-index choices.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: "OrderedDict[Tuple[int, int], Entry]" = OrderedDict()

    def probe_regular(self, vpn: int) -> Optional[Entry]:
        e = self.entries.get((vpn, REGULAR))
        if e is not None:
            self.entries.move_to_end((vpn, REGULAR))
        return e

    def probe_aligned(self, vpn: int, K: Sequence[int],
                      first_k: Optional[int] = None) -> Tuple[Optional[int], int]:
        order: List[int] = []
        if first_k is not None and first_k in K:
            order.append(first_k)
        order += [k for k in sorted(K, reverse=True) if k not in order]
        probes = 0
        for k in order:
            probes += 1
            vk = aligned_vpn(vpn, k)
            e = self.entries.get((vk, k))
            if e is not None and e.contiguity > (vpn - vk):
                self.entries.move_to_end((vk, k))
                return e.ppn + (vpn - vk), probes
        return None, probes

    def insert(self, e: Entry) -> None:
        key = (e.tag, e.kcls)
        if key in self.entries:
            self.entries.move_to_end(key)
        self.entries[key] = e
        while len(self.entries) > self.capacity:
            self.entries.popitem(last=False)

    def coverage(self) -> int:
        """Table 5 metric: entries + extra pages covered by coalescing."""
        return sum(e.contiguity for e in self.entries.values())


def simulate_reference(m: Mapping, trace: Sequence[int], K: Sequence[int],
                       capacity: int = 1024) -> dict:
    """End-to-end reference simulation (no L1, fully-associative L2).

    Used by property tests as the oracle for the batched engine and by unit
    tests to sanity-check Algorithms 1–3 against the paper's worked examples.
    """
    tlb = ReferenceTLB(capacity)
    walks = reg_hits = al_hits = probes_total = pred_correct = 0
    pred_k: Optional[int] = None
    for vpn in trace:
        vpn = int(vpn)
        e = tlb.probe_regular(vpn)
        if e is not None:
            reg_hits += 1
            continue
        ppn, probes = tlb.probe_aligned(vpn, K, first_k=pred_k)
        if ppn is not None:
            al_hits += 1
            probes_total += probes
            if probes == 1:
                pred_correct += 1
            # record the alignment that hit, for the 4-bit predictor
            for k in ([pred_k] if pred_k is not None else []) + sorted(K, reverse=True):
                if k is not None and covers(m, vpn, aligned_vpn(vpn, k), k):
                    pred_k = k
                    break
            assert ppn == int(m.ppn[vpn]), "aligned translation must be exact"
            continue
        walks += 1
        ins = fill_select(m, vpn, K)
        if ins.kcls != REGULAR:
            pred_k = ins.kcls
        tlb.insert(ins)
    return dict(walks=walks, regular_hits=reg_hits, aligned_hits=al_hits,
                probes=probes_total, pred_correct=pred_correct,
                coverage=tlb.coverage())
