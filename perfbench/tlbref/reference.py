"""The plain reference of a TLB-sweep cell: one method of the paper's roster
over one static mapping and its trace, one access at a time, in plain
Python.

It is written from the paper (arXiv:1908.08774: the K-bit aligned entry of
§3.1, Algorithm 1's fill, the probe order, predictor and latencies of §3.5,
Table 2's hierarchy) and the baselines the paper compares with (THP's 2MB
pages, COLT's coalescing within an 8-PTE line, the Cluster TLB's 8-page
bitmaps, RMM's ranges, Anchor's single aligned class).  What a walk
installs is worked out at that walk from the page table alone, the ppn of
each vpn: the physically contiguous run that holds a page is found by
scanning its neighbours.  It imports nothing of the program and shares no
code with it; the program's packing builds its fill records its own way.

Replacement everywhere is LRU by the step of last use: a fill takes the
first free way of its set, else the least recently used one.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import numpy as np

# Table 2 and §3.5: latencies in cycles
LAT_L1 = 0            # in parallel with the cache access
LAT_L2_REG = 7        # a regular L2 entry
LAT_COAL = 8          # a coalesced, aligned, range or cluster entry
LAT_EXTRA_PROBE = 7   # each aligned probe after the first
LAT_WALK = 50         # a page walk, after the failed lookups

# geometries (Table 2)
L1_SETS, L1_WAYS = 16, 4          # 4KB L1
L1H_SETS, L1H_WAYS = 8, 4         # 2MB L1 (THP)
RMM_ENTRIES = 32                  # range table, fully associative
CLUS_SETS, CLUS_WAYS = 64, 5      # clustered TLB, 8-page windows
N_COV_SAMPLES = 64                # coverage sampled this often a lane

REGULAR = -1          # class of a one-page entry
HUGE = 9              # class of a THP 2MB entry (2^9 pages)
FREE = -2             # class of an empty L2 way

#: the counters compared, besides the name, the coverage mean and the ppns
FIELDS = ("accesses", "l1_hits", "l2_regular_hits", "l2_coalesced_hits",
          "walks", "aligned_probes", "pred_correct", "cycles", "shootdowns")

#: the kinds of the paper's roster that this reference simulates
KINDS = ("base", "thp", "rmm", "colt", "cluster", "anchor", "kaligned")


def miss_chain(spec) -> int:
    """Cycles of the failed lookups before a walk: every aligned probe on
    aligned lanes, one coalesced-latency probe where a coalesced or side
    structure is looked up, else one regular L2 lookup."""
    if spec.K and spec.kind in ("kaligned", "anchor"):
        return LAT_COAL + LAT_EXTRA_PROBE * (len(spec.K) - 1)
    if spec.kind == "colt" or spec.side is not None:
        return LAT_COAL
    return LAT_L2_REG


class PageTable:
    """A static mapping as the walker sees it: ``ppn[vpn]`` (-1 where
    unmapped), and the physically contiguous run holding a page, found by
    scanning on demand and remembered."""

    def __init__(self, ppn):
        self.ppn = [int(p) for p in np.asarray(ppn).tolist()]
        self.n = len(self.ppn)
        self._start = [-1] * self.n
        self._len = [0] * self.n

    def run(self, v: int):
        """``(start, length)`` of the run of pages, each mapped to the
        frame after its predecessor's, that holds ``v``; ``(v, 0)`` for an
        unmapped page."""
        ppn = self.ppn
        if ppn[v] < 0:
            return v, 0
        if self._len[v]:
            return self._start[v], self._len[v]
        a = v
        while a > 0 and ppn[a - 1] >= 0 and ppn[a - 1] + 1 == ppn[a]:
            a -= 1
        b = v + 1
        while b < self.n and ppn[b] >= 0 and ppn[b] == ppn[b - 1] + 1:
            b += 1
        for u in range(a, b):
            self._start[u] = a
            self._len[u] = b - a
        return a, b - a

    def contig_from(self, v: int) -> int:
        """Pages contiguously mapped from ``v`` on, ``v`` included."""
        s, n = self.run(v)
        return s + n - v if n else 0


def walk_fill(spec, pt: PageTable, vpn: int):
    """What a walk to ``vpn`` installs in the L2: ``(tag, class,
    pages covered, ppn of the tag)``.

    * K-aligned and Anchor (Algorithm 1): for each k of K, largest first,
      the entry of the 2^k-aligned block holding ``vpn`` covers the pages
      contiguous from the block's base, at most 2^k; the first that covers
      ``vpn`` is installed, tagged by the block's base.
    * COLT: the run holding ``vpn``, clipped to ``vpn``'s 8-PTE line.
    * THP: the 2MB page when its 512 pages are contiguous from a
      512-aligned frame.
    * otherwise, and where nothing covers, the one-page entry.
    """
    ppn = pt.ppn
    kind = spec.kind
    if kind in ("kaligned", "anchor"):
        for k in spec.K:
            vk = vpn & ~((1 << k) - 1)
            cover = min(pt.contig_from(vk), 1 << k)
            if cover > vpn - vk:
                return vk, k, cover, ppn[vk]
    elif kind == "colt":
        line = vpn & ~7
        s, n = pt.run(vpn)
        tag = max(s, line)
        cover = max(min(s + n, line + 8) - tag, 1)
        return tag, (3 if cover > 1 else REGULAR), cover, ppn[tag]
    elif kind == "thp":
        b = vpn & ~511
        if b + 512 <= pt.n and ppn[b] >= 0 and ppn[b] % 512 == 0 \
                and pt.contig_from(b) >= 512:
            return vpn >> 9, HUGE, 512, ppn[b]
    return vpn, REGULAR, 1, ppn[vpn]


def cluster_bits(pt: PageTable, vpn: int) -> int:
    """The Cluster TLB's bitmap for ``vpn``: bit j for page j of its
    8-page virtual window when that page maps into the same 8-frame
    physical cluster as ``vpn``."""
    ppn = pt.ppn
    if ppn[vpn] < 0:
        return 0
    c = ppn[vpn] >> 3
    base = vpn & ~7
    bm = 0
    for j in range(8):
        p = base + j
        if p < pt.n and ppn[p] >= 0 and ppn[p] >> 3 == c:
            bm |= 1 << j
    return bm


def _victim(valid, lru, base: int, ways: int) -> int:
    """The way a fill takes: the first free one, else the least recently
    used."""
    best, best_lru = 0, None
    for w in range(ways):
        i = base + w
        if not valid(i):
            return w
        if best_lru is None or lru[i] < best_lru:
            best, best_lru = w, lru[i]
    return best


def simulate(spec, ppn, trace: Sequence[int], fill=walk_fill) -> Dict:
    """One lane: ``spec`` over the static mapping ``ppn`` and ``trace``
    (``fill`` is what a walk installs).  Returns the compared fields (see
    :func:`summary`)."""
    if spec.kind not in KINDS:
        raise ValueError(f"the reference has no kind {spec.kind!r}")
    pt = PageTable(ppn)
    ppn = pt.ppn
    trace = [int(v) for v in np.asarray(trace).tolist()]
    T = len(trace)
    Ks = tuple(spec.K)
    shift = spec.index_shift
    S2, W2 = spec.l2_sets, spec.l2_ways
    mask = S2 - 1
    chain = miss_chain(spec)
    is_colt, is_thp = spec.kind == "colt", spec.kind == "thp"
    has_rmm, has_clus = spec.side == "rmm", spec.side == "cluster"
    predict = bool(spec.use_predictor and Ks)

    l1_tag, l1_ppn, l1_lru = [-1] * 64, [-1] * 64, [0] * 64
    lh_tag, lh_ppn, lh_lru = [-1] * 32, [-1] * 32, [0] * 32
    n2 = S2 * W2
    l2_tag, l2_k, l2_cov = [-1] * n2, [FREE] * n2, [0] * n2
    l2_ppn, l2_lru = [-1] * n2, [0] * n2
    r_start, r_len, r_ppn, r_lru = ([-1] * RMM_ENTRIES, [0] * RMM_ENTRIES,
                                    [-1] * RMM_ENTRIES, [0] * RMM_ENTRIES)
    c_tag, c_bm, c_lru = [-1] * 320, [0] * 320, [0] * 320
    pred = Ks[0] if Ks else 0

    n_l1 = n_reg = n_coal = n_walk = n_probe = n_pred = cycles = cov = 0
    every = max(T // N_COV_SAMPLES, 1)
    samples = [0] * N_COV_SAMPLES
    out = [0] * T

    for t, vpn in enumerate(trace):
        true_ppn = ppn[vpn]
        # ---- L1 (and the 2MB L1 on THP lanes)
        b1 = (vpn & (L1_SETS - 1)) * L1_WAYS
        w1 = next((w for w in range(L1_WAYS) if l1_tag[b1 + w] == vpn), -1)
        hv = vpn >> 9
        bh = (hv & (L1H_SETS - 1)) * L1H_WAYS
        wh = next((w for w in range(L1H_WAYS) if lh_tag[bh + w] == hv), -1)
        l1_hit = w1 >= 0
        served1 = l1_hit or (is_thp and wh >= 0)
        if l1_hit:
            l1_out = l1_ppn[b1 + w1]
        elif served1:
            l1_out = lh_ppn[bh + wh] + (vpn & 511)

        # ---- L2
        s2 = (vpn >> shift) & mask
        b2 = s2 * W2
        reg_hit = coal_hit = False
        probes = pred_ok = 0
        hit_k = -1
        l2_out = -1
        touch = -1                      # the L2 slot a hit refreshes
        if is_colt:
            for w in range(W2):
                i = b2 + w
                if l2_k[i] != FREE and 0 <= vpn - l2_tag[i] < l2_cov[i]:
                    reg_hit = l2_cov[i] == 1
                    coal_hit = not reg_hit
                    l2_out = l2_ppn[i] + vpn - l2_tag[i]
                    touch = i
                    break
        elif is_thp:
            bhv = (hv & mask) * W2
            for w in range(W2):
                i = b2 + w
                if l2_k[i] == REGULAR and l2_tag[i] == vpn:
                    reg_hit, l2_out, touch = True, l2_ppn[i], i
                    break
            else:
                for w in range(W2):
                    i = bhv + w
                    if l2_k[i] == HUGE and l2_tag[i] == hv:
                        reg_hit, touch = True, i
                        l2_out = l2_ppn[i] + vpn - (hv << 9)
                        break
        else:
            for w in range(W2):
                i = b2 + w
                if l2_k[i] == REGULAR and l2_tag[i] == vpn:
                    reg_hit, l2_out, touch = True, l2_ppn[i], i
                    break
            if Ks and not reg_hit:
                order = ((pred,) + tuple(k for k in Ks if k != pred)
                         if spec.use_predictor else Ks)
                for k in order:
                    probes += 1
                    vk = vpn & ~((1 << k) - 1)
                    for w in range(W2):
                        i = b2 + w
                        if l2_k[i] == k and l2_tag[i] == vk \
                                and l2_cov[i] > vpn - vk:
                            coal_hit, hit_k, touch = True, k, i
                            l2_out = l2_ppn[i] + vpn - vk
                            break
                    if coal_hit:
                        break
                if spec.use_predictor and coal_hit and hit_k == order[0]:
                    pred_ok = 1
        l2_hit = reg_hit or coal_hit

        # ---- side structures
        side_hit = False
        side_out = -1
        rw = -1
        if has_rmm:
            for e in range(RMM_ENTRIES):
                if 0 <= vpn - r_start[e] < r_len[e]:
                    side_hit, rw = True, e
                    side_out = r_ppn[e] + vpn - r_start[e]
                    break
        cwd = vpn >> 3
        bc = (cwd & (CLUS_SETS - 1)) * CLUS_WAYS
        if has_clus:
            bit = vpn & 7
            for w in range(CLUS_WAYS):
                i = bc + w
                if c_tag[i] == cwd and (c_bm[i] >> bit) & 1:
                    side_hit, side_out = True, true_ppn
                    break

        walk = not (served1 or l2_hit or side_hit)

        # ---- latency
        if served1:
            cyc = LAT_L1
        elif reg_hit:
            cyc = LAT_L2_REG
        elif coal_hit:
            cyc = LAT_COAL + LAT_EXTRA_PROBE * max(probes - 1, 0)
        elif side_hit:
            cyc = LAT_COAL
        else:
            cyc = chain + LAT_WALK

        # ---- what a walk to this page would install
        if walk or (is_thp and not served1):
            f_tag, f_k, f_cov, f_ppn = fill(spec, pt, vpn)
        else:
            f_k = REGULAR
        huge = is_thp and f_k == HUGE

        # ---- L2 fill or refresh
        if walk:
            bf = ((hv & mask) * W2) if huge else b2
            w = _victim(lambda i: l2_k[i] != FREE, l2_lru, bf, W2)
            i = bf + w
            evicted = l2_cov[i] if l2_k[i] != FREE else 0
            l2_tag[i], l2_k[i], l2_cov[i] = f_tag, f_k, f_cov
            l2_ppn[i], l2_lru[i] = f_ppn, t
            cov += f_cov - evicted
        elif l2_hit and not served1:
            l2_lru[touch] = t

        # ---- side fills
        if has_rmm:
            if walk:
                s, n = pt.run(vpn)
                e = _victim(lambda j: r_len[j] > 0, r_lru, 0, RMM_ENTRIES)
                evicted = r_len[e]
                r_start[e], r_len[e], r_ppn[e], r_lru[e] = s, n, ppn[s], t
                cov += n - evicted
            elif side_hit:
                r_lru[rw] = t
        if has_clus:
            bm = cluster_bits(pt, vpn) if walk else 0
            if walk and bm != 1 << (vpn & 7):
                w = _victim(lambda i: c_bm[i] != 0, c_lru, bc, CLUS_WAYS)
                c_tag[bc + w], c_bm[bc + w], c_lru[bc + w] = cwd, bm, t
            elif side_hit:
                w = next(w for w in range(CLUS_WAYS) if c_tag[bc + w] == cwd)
                c_lru[bc + w] = t

        # ---- L1 fills
        if is_thp:
            if not served1 and huge:
                w = _victim(lambda i: lh_tag[i] >= 0, lh_lru, bh, L1H_WAYS)
                lh_tag[bh + w], lh_ppn[bh + w], lh_lru[bh + w] = hv, f_ppn, t
            if served1 and not l1_hit:
                lh_lru[bh + wh] = t
            fill1 = not served1 and not huge
        else:
            fill1 = not served1
        if fill1:
            w = _victim(lambda i: l1_tag[i] >= 0, l1_lru, b1, L1_WAYS)
            l1_tag[b1 + w], l1_ppn[b1 + w], l1_lru[b1 + w] = vpn, true_ppn, t
        if l1_hit:
            l1_lru[b1 + w1] = t

        # ---- the predictor learns the class that served or was filled
        if predict:
            if coal_hit:
                pred = hit_k
            elif walk and f_k >= 0:
                pred = f_k

        # ---- counters
        if served1:
            n_l1 += 1
        else:
            if reg_hit:
                n_reg += 1
            elif coal_hit or side_hit:
                n_coal += 1
            if coal_hit:
                n_probe += probes
            n_pred += pred_ok
        n_walk += walk
        cycles += cyc
        if t % every == every - 1:
            samples[min(t // every, N_COV_SAMPLES - 1)] = cov
        out[t] = (l1_out if served1 else l2_out if l2_hit
                  else side_out if side_hit else true_ppn)

    return {"name": spec.name, "accesses": T, "l1_hits": n_l1,
            "l2_regular_hits": n_reg, "l2_coalesced_hits": n_coal,
            "walks": n_walk, "aligned_probes": n_probe,
            "pred_correct": n_pred, "cycles": cycles, "shootdowns": 0,
            "coverage_mean": float(np.mean(np.asarray(samples, np.int64))),
            "ppn_sha256": ppn_digest(out)}


def run_job(world: str, n_pages: int, trace_len: int, map_seed: int,
            trace_seed: int, spec: Dict, fill=walk_fill) -> Dict:
    """One lane, as a job for a worker process: the world is built again
    from its name, sizes and seeds (every builder is deterministic), so a
    job pickles a few numbers, not a world."""
    from .specs import MethodSpec
    from .worlds import build_world
    w = build_world(world, n_pages, trace_len, map_seed, trace_seed)
    sp = MethodSpec(**dict(spec, K=tuple(spec["K"])))
    return simulate(sp, w.mapping.ppn, w.trace, fill=fill)


def ppn_digest(ppn) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(ppn, dtype=np.int64).tobytes()).hexdigest()


def accesses(r) -> int:
    return r["accesses"] if isinstance(r, dict) else int(r.accesses)


def summary(r) -> Dict:
    """A program ``SimResult``'s compared fields, as :func:`simulate`
    gives them (a dict of them is returned as it is)."""
    if isinstance(r, dict):
        return dict(r)
    out = {f: int(getattr(r, f)) for f in FIELDS}
    out.update(name=r.name, coverage_mean=float(r.coverage_mean),
               ppn_sha256=ppn_digest(r.ppn))
    return out
