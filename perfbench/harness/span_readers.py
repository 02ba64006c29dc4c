"""What the per-layer metrics that read the program's host spans and the
packing counter share (``metrics/sweep_*_ms.sweep.py``,
``metrics/sweep_upload_gbps.sweep.py``).  Each returns None where the run
holds nothing to read: no trace, a span never recorded (a program that
has none), no bytes counted or no upload seen; never 0 for that."""
from __future__ import annotations

#: the pageable copies host to device, by a fragment of their name
HTOD = "Memcpy HtoD"


def span_ms_per_call(name: str):
    """Host milliseconds of the program's spans called ``name`` a call,
    means over the window's calls."""
    def read(obs):
        tr = obs.get("trace")
        if tr is None or not obs["calls"] or not tr.span_count(name):
            return None
        return tr.span_s(name) / len(obs["calls"]) * 1e3
    return read


def upload_gbps(obs):
    """GB/s of the upload: the bytes the program packed in the window's
    calls (``run_sweep``'s ``packed_bytes``) over the device time of the
    copies host to device."""
    tr = obs.get("trace")
    if tr is None:
        return None
    moved = sum(c["stats"].get("packed_bytes", 0) for c in obs["calls"])
    t = tr.kernel_s(HTOD)
    if not moved or not t:
        return None
    return moved / t / 1e9
