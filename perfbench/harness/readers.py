"""What the per-layer metrics of the sweep cells read from a driver's
observations (``drivers/tlb_sweep.py`` documents the keys), shared by the
readers in ``metrics/``.  Each returns None where the run holds nothing to
read (a run without a trace, a traced window without the kernel), never 0
for a share of a peak."""
from __future__ import annotations

from perfbench.harness import bench, peaks

#: the TLB-sweep kernel, by a fragment of its name in the device trace
TLB_KERNEL = "tlb_sweep_kernel"


def kernel_ms_per_call(fragment: str):
    """Device milliseconds of the kernels named by ``fragment`` a call."""
    def read(obs):
        tr = obs.get("trace")
        if tr is None or not obs["calls"] or not tr.kernel_s(fragment):
            return None
        return tr.kernel_s(fragment) / len(obs["calls"]) * 1e3
    return read


def host_ms_per_call(fragment: str):
    """Host milliseconds of a call: its wall less the device time of the
    kernels named by ``fragment``, means over the window's calls."""
    def read(obs):
        tr = obs.get("trace")
        if tr is None or not obs["calls"]:
            return None
        wall = sum(c["wall_s"] for c in obs["calls"])
        return (wall - tr.kernel_s(fragment)) / len(obs["calls"]) * 1e3
    return read


def roofline(count: str, fragment: str):
    """100 x the least time of every call's work (``counts/<count>.py``,
    from each batch's inputs and first results, which every call equals)
    over the device time of the kernels named by ``fragment``."""
    def read(obs):
        tr = obs.get("trace")
        t = tr.kernel_s(fragment) if tr is not None else 0.0
        if not t:
            return None
        c = bench.count(count)
        per_batch = []
        for b in obs["batches"]:
            if b["results"] is None:
                per_batch.append(0.0)
                continue
            lanes = [(w, s, r) for (w, s), r in zip(b["lanes"],
                                                     b["results"])]
            per_batch.append(c.bound_s(c.work(lanes), peaks.INT32_OPS_PER_S,
                                       peaks.HBM_BYTES_PER_S))
        least = sum(per_batch[call["batch"]] for call in obs["calls"])
        return 100.0 * least / t
    return read


def device_idle_pct(obs):
    """Share of the traced window in which no kernel ran."""
    tr = obs.get("trace")
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
