"""The worlds of the paper's Table 4 batch as the benchmark builds them: a
synthetic mapping of Table 3's chunk-size family and a multiscale trace
over its mapped pages (a frozen copy of ``synth-<kind>`` of
``src/repro_torch/scenarios/synthetic.py``).  Deterministic in the sizes
and seeds; numpy and the frozen copies beside it only.  Not to be edited.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .mappings import synthetic_mapping
from .page_table import Mapping, contiguity_histogram
from .traces import generate_trace

SYNTH_KINDS = ("small", "medium", "large", "mixed")


@dataclasses.dataclass(frozen=True)
class World:
    """A static mapping, its trace (read-only int64) and its contiguity
    histogram (Algorithm 3's input)."""

    name: str
    mapping: Mapping
    trace: np.ndarray
    histogram: Dict[int, int]


def build_world(name: str, n_pages: int, trace_len: int, map_seed: int,
                trace_seed: int) -> World:
    """``synth-<kind>``: ``n_pages`` mapped pages in chunks of Table 3's
    ``kind``, and ``trace_len`` multiscale accesses over them."""
    kind = name.removeprefix("synth-")
    if not name.startswith("synth-") or kind not in SYNTH_KINDS:
        raise ValueError(f"no world {name!r}")
    m = synthetic_mapping(kind, int(n_pages), seed=int(map_seed))
    trace = np.ascontiguousarray(
        generate_trace("multiscale", 0, int(trace_len), seed=int(trace_seed),
                       mapping=m), dtype=np.int64)
    trace.setflags(write=False)
    return World(name, m, trace, contiguity_histogram(m))
