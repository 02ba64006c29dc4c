"""The device trace of a traced run, reduced to the numbers the result
line carries: the seconds in which a kernel ran (``busy_s``) within the
traced window (``window_s``), device time by kernel name, the device
operations that took most time and the longest idle gaps, each named by
what the host was doing then.

``torch.profiler`` (CUPTI) records the kernels; the window is timed by
the host clock and ends in a synchronise.  Kernels of overlapping streams
count once: busy time is the length of the union of their intervals.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

#: entries of each breakdown list
TOP = 10
#: the host span after the window
_END = "bench.window_end"


class DeviceTrace:
    """Profile a block of work: ``with DeviceTrace() as tr: ...``; then
    ``tr.window_s``, ``tr.busy_s``, ``tr.kernel_s(fragment)``,
    ``tr.kernel_count(fragment)``, ``tr.span_s(name)``,
    ``tr.span_count(name)``, ``tr.breakdown()``.  Host spans named
    with :meth:`span` label the idle gaps they hold."""

    def __init__(self):
        self.window_s = 0.0
        self._kernels: List[Tuple[float, float, str]] = []
        self._host: List[Tuple[float, float, str, int]] = []
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        # kernels after the window, which the reduction leaves out: the
        # profiler has been seen to lose the final events of a profile
        with self.span(_END):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start
        takes seconds (CUPTI), which would otherwise fall in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @staticmethod
    def span(name: str):
        """A host span (``record_function``) that names idle gaps."""
        from torch.profiler import record_function
        return record_function(name)

    def _reduce(self) -> None:
        from torch.autograd import DeviceType
        evs = list(self._prof.events())
        kernels, host = [], []
        for ev in evs:
            tr = ev.time_range
            if ev.device_type == DeviceType.CUDA:
                if ev.name.startswith("bench."):
                    continue        # a host span's shadow on the device
                kernels.append((tr.start / 1e6, tr.end / 1e6, ev.name))
            else:
                host.append((tr.start / 1e6, tr.end / 1e6, ev.name,
                             0 if ev.name.startswith("bench.") else 1))
        # every kernel of the window ended before the synchronise that
        # precedes the end marker's span
        end = min((a for a, _, n, _ in host if n == _END), default=None)
        if end is not None:
            kernels = [k for k in kernels if k[0] < end]
            host = [h for h in host if h[2] != _END]
        kernels.sort()
        self._kernels = kernels
        self._host = host

    # -- readings -------------------------------------------------------
    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for a, b, _ in self._kernels:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged())

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the kernels whose names hold ``fragment``."""
        return sum(b - a for a, b, n in self._kernels if fragment in n)

    def kernel_count(self, fragment: str) -> int:
        """Launches of the kernels whose names hold ``fragment``."""
        return sum(fragment in n for _, _, n in self._kernels)

    def span_s(self, name: str) -> float:
        """Host seconds of the spans (``record_function``) called ``name``,
        the program's or the benchmark's, summed."""
        return sum(b - a for a, b, n, _ in self._host if n == name)

    def span_count(self, name: str) -> int:
        return sum(n == name for _, _, n, _ in self._host)

    def device_ops(self) -> List[List]:
        by: Dict[str, float] = {}
        for a, b, n in self._kernels:
            by[n] = by.get(n, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in top]

    def _host_at(self, t: float) -> str:
        """The innermost host op running at ``t``, inside the innermost
        benchmark span (``bench.*``) that holds it."""
        op: Optional[Tuple[float, str]] = None
        span: Optional[Tuple[float, str]] = None
        for a, b, n, kind in self._host:
            if a <= t <= b:
                if kind == 0:
                    if span is None or b - a < span[0]:
                        span = (b - a, n)
                elif op is None or b - a < op[0]:
                    op = (b - a, n)
        what = op[1] if op else "python"
        return f"{what} in {span[1]}" if span else what

    def idle_gaps(self) -> List[List]:
        merged = self._merged()
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])
                if a1 > b0]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2)[:160], b - a]
                for a, b in gaps[:TOP]]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}
