"""Memory-access trace generators (paper §4: Pin traces of SPEC2006/graph500/gups).

We have no Pin traces offline, so each paper benchmark is represented by a
synthetic *access-pattern analogue* with the locality structure that drives
its TLB behaviour.  Trace entries are virtual page numbers (one entry per
memory access that reaches the TLB).

Patterns:

* ``sequential`` — streaming array sweeps (bwaves/zeusmp/wrf-like)
* ``strided``    — fixed-stride sweeps with several interleaved streams
* ``random``     — uniform random pages (gups: the worst case)
* ``zipf``       — skewed reuse (mcf/omnetpp/xalancbmk-like)
* ``bfs``        — frontier expansion with neighbourhood locality (graph500)
* ``blocked``    — tiled compute: dwell in a block, move on (gromacs/namd)
* ``mixed_phase``— phases alternating among the above (astar/sjeng-like)
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _seq(n_pages: int, length: int, rng: np.random.Generator) -> np.ndarray:
    starts = rng.integers(0, n_pages, size=max(1, length // 4096))
    out = (np.arange(length) % 4096)[None, :]
    segs = (starts[:, None] + out) % n_pages
    return segs.reshape(-1)[:length]


def _strided(n_pages: int, length: int, rng: np.random.Generator,
             stride: int = 7, streams: int = 4) -> np.ndarray:
    base = rng.integers(0, n_pages, size=streams)
    idx = np.arange(length)
    s = idx % streams
    step = idx // streams
    return (base[s] + step * stride) % n_pages


def _random(n_pages: int, length: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, n_pages, size=length)


def _zipf(n_pages: int, length: int, rng: np.random.Generator,
          a: float = 1.2) -> np.ndarray:
    # zipf over a shuffled page id space so hot pages are scattered
    raw = rng.zipf(a, size=length)
    raw = np.minimum(raw - 1, n_pages - 1)
    perm = rng.permutation(n_pages)
    return perm[raw]


def _bfs(n_pages: int, length: int, rng: np.random.Generator,
         hood: int = 64, p_jump: float = 0.05) -> np.ndarray:
    jumps = rng.random(length) < p_jump
    targets = rng.integers(0, n_pages, size=length)
    offs = rng.integers(-hood, hood + 1, size=length)
    out = np.empty(length, dtype=np.int64)
    cur = int(rng.integers(0, n_pages))
    # vectorized-ish: segment between jumps shares a frontier centre
    centres = targets[np.searchsorted(np.flatnonzero(jumps), np.arange(length), side="right") - 1] \
        if jumps.any() else np.full(length, cur)
    centres[:int(np.argmax(jumps))] = cur if jumps.any() else cur
    out = (centres + offs) % n_pages
    return out.astype(np.int64)


def _blocked(n_pages: int, length: int, rng: np.random.Generator,
             block: int = 256, dwell: int = 2048) -> np.ndarray:
    n_blocks = max(1, -(-length // dwell))
    bases = rng.integers(0, max(1, n_pages - block), size=n_blocks)
    within = rng.integers(0, block, size=length)
    return (np.repeat(bases, dwell)[:length] + within) % n_pages


def _multiscale(n_pages: int, length: int, rng: np.random.Generator,
                seg: int = 2000, min_region: int = 256) -> np.ndarray:
    """Hierarchical working sets: dwell in a region whose size is drawn
    log-uniformly in [min_region, n_pages], then move on.

    Real programs exhibit reuse at many scales simultaneously (loop nests,
    data-structure traversals, phase behaviour); this is the pattern that
    makes TLB misses scale smoothly with translation *reach*, which is what
    the paper's SPEC-based traces show.
    """
    n_seg = max(1, length // seg)
    lo, hi = np.log2(min_region), np.log2(max(n_pages, min_region + 1))
    sizes = (2.0 ** rng.uniform(lo, hi, size=n_seg)).astype(np.int64)
    sizes = np.minimum(sizes, n_pages)
    bases = (rng.random(n_seg) * np.maximum(n_pages - sizes, 1)).astype(np.int64)
    offs = rng.random(length)
    seg_idx = np.minimum(np.arange(length) // seg, n_seg - 1)
    return bases[seg_idx] + (offs * sizes[seg_idx]).astype(np.int64)


def _mixed_phase(n_pages: int, length: int, rng: np.random.Generator) -> np.ndarray:
    gens = [_seq, _strided, _random, _zipf, _blocked]
    parts = []
    per = length // len(gens)
    for g in gens:
        parts.append(g(n_pages, per, rng))
    out = np.concatenate(parts)
    if out.shape[0] < length:
        out = np.concatenate([out, _seq(n_pages, length - out.shape[0], rng)])
    return out[:length]


PATTERNS = {
    "sequential": _seq,
    "strided": _strided,
    "random": _random,
    "zipf": _zipf,
    "bfs": _bfs,
    "blocked": _blocked,
    "multiscale": _multiscale,
    "mixed_phase": _mixed_phase,
}

# The paper's 16 benchmarks → access-pattern analogue + footprint (pages).
# Footprints are chosen so working sets well exceed the 1024-entry L2 reach
# (4MB), as for the paper's big-memory workloads.
BENCHMARKS: Dict[str, Tuple[str, int]] = {
    "astar": ("multiscale", 1 << 18),
    "bzip2": ("blocked", 1 << 17),
    "mcf": ("multiscale", 1 << 20),
    "omnetpp": ("zipf", 1 << 18),
    "povray": ("blocked", 1 << 16),
    "sjeng": ("mixed_phase", 1 << 17),
    "hmmer": ("strided", 1 << 16),
    "libquantum": ("sequential", 1 << 19),
    "bwaves": ("sequential", 1 << 19),
    "zeusmp": ("strided", 1 << 18),
    "gromacs": ("blocked", 1 << 17),
    "namd": ("multiscale", 1 << 17),
    "xalancbmk": ("zipf", 1 << 17),
    "wrf": ("multiscale", 1 << 19),
    "graph500": ("bfs", 1 << 20),
    "gups": ("random", 1 << 20),
}


def generate_trace(pattern: str, n_pages: int, length: int,
                   seed: int = 0, mapping=None) -> np.ndarray:
    """Generate a VPN trace.

    With ``mapping`` the pattern indexes the *mapped* pages only (VA-aligned
    mappings have unmapped alignment holes that a process never touches) and
    the returned trace contains true VPNs of that mapping.
    """
    rng = np.random.default_rng(seed)
    if mapping is not None:
        from .mappings import mapped_vpns
        mv = mapped_vpns(mapping)
        idx = PATTERNS[pattern](mv.shape[0], length, rng)
        return mv[np.asarray(idx, np.int64) % mv.shape[0]]
    vpns = PATTERNS[pattern](n_pages, length, rng)
    return np.asarray(vpns, dtype=np.int64) % n_pages


def benchmark_trace(name: str, length: int = 200_000, seed: int = 0,
                    mapping=None) -> Tuple[np.ndarray, int]:
    """Returns (trace, footprint_pages) for a named benchmark analogue."""
    pattern, n_pages = BENCHMARKS[name]
    return generate_trace(pattern, n_pages, length, seed=seed,
                          mapping=mapping), n_pages
