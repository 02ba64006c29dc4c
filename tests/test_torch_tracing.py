"""The port's profiler spans and the sweep's ``packed_bytes`` counter, and
the benchmark's readers of them, on the CPU.

``repro_torch.tracing.span`` marks host work on ``torch.profiler``'s
timeline while a profiler records and is one shared no-op otherwise.
``run_sweep`` carries five spans a packed batch (``sweep.pack`` holding
``sweep.pack.fills``, ``sweep.pack.clusters`` and ``sweep.pack.stack``,
then ``sweep.unpack``) and counts the bytes it packs; a span changes no
result.  ``perfbench/metrics/sweep_*.sweep.py`` read them, and find
nothing to read in an untraced run.
"""
import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as tcore
from _torch_helpers import pkg
from repro_torch import tracing
from repro_torch.core.sweep import SweepCell, pack_batch, run_sweep
from repro_torch.robustness.faults import backend_fault_injection

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:          # perfbench is imported from the root
    sys.path.insert(0, str(REPO))

T = pkg(tcore)
SPANS = ("sweep.pack", "sweep.pack.fills", "sweep.pack.clusters",
         "sweep.pack.stack", "sweep.unpack")
INNER = SPANS[1:4]
METRICS = {"sweep_pack_ms.sweep": "sweep.pack",
           "sweep_fill_ms.sweep": "sweep.pack.fills",
           "sweep_cluster_ms.sweep": "sweep.pack.clusters",
           "sweep_stack_ms.sweep": "sweep.pack.stack",
           "sweep_unpack_ms.sweep": "sweep.unpack"}
UPLOAD = "sweep_upload_gbps.sweep"


@pytest.fixture(scope="module")
def cells():
    """A tiny batch of one static world (200 accesses, the shortest padded
    trace): base, a cluster lane, K-aligned."""
    m = T.mappings.demand_mapping(1 << 10, seed=11)
    tr = T.traces.generate_trace("multiscale", 0, 200, seed=4, mapping=m)
    b = T.baselines
    specs = [b.base_spec(), b.cluster_spec(), b.kaligned_spec([6, 4])]
    return [SweepCell(s, m, tr) for s in specs]


@pytest.fixture(scope="module")
def traced(cells):
    """One sweep under the profiler: its result and the span intervals
    (ns).  The intervals come from the profiler's raw results: the plain
    version's ~600k operations take a minute to build into
    ``prof.events()``'s tree, and a second to list raw."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run_sweep(cells, cache=False, device="cpu")
    spans = {n: [] for n in SPANS}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in spans:
            spans[ev.name()].append((ev.start_ns(), ev.end_ns()))
    return res, spans


def _fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _assert_same(a, b):
    for x, y in zip(a, b):
        fx, fy = _fields(x), _fields(y)
        assert fx.keys() == fy.keys()
        for k in fx:
            if isinstance(fx[k], np.ndarray):
                np.testing.assert_array_equal(fx[k], fy[k], err_msg=k)
            else:
                assert fx[k] == fy[k], k


def test_each_span_once_per_batch(traced):
    res, spans = traced
    assert res.stats["n_batches"] == 1
    assert {n: len(v) for n, v in spans.items()} == {n: 1 for n in SPANS}


def test_stages_lie_inside_the_pack_span(traced):
    _, spans = traced
    (a, b), = spans["sweep.pack"]
    for n in INNER:
        (x, y), = spans[n]
        assert a <= x <= y <= b, n
    (u, _), = spans["sweep.unpack"]
    assert u >= b


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = tracing.span("sweep.pack")
    assert off is tracing.span("sweep.unpack")
    with off as got:
        assert got is None


def test_span_records_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = tracing.span("test.span")
        assert on is not tracing.span("sweep.pack")
        with on:
            pass
    assert [e.name for e in prof.events()].count("test.span") == 1


def test_results_equal_with_the_profiler_on_and_off(cells, traced):
    res, _ = traced
    off = run_sweep(cells, cache=False, device="cpu")
    _assert_same(res.results, off.results)
    assert {**res.stats, "wall_s": 0} == {**off.stats, "wall_s": 0}


def test_packed_bytes_counts_pack_batch_arrays(cells, traced):
    res, _ = traced
    lanes, stacks, st0, _ = pack_batch(cells)
    want = sum(a.nbytes for d in (lanes, stacks, st0) for a in d.values())
    assert want > 0 and res.stats["packed_bytes"] == want


def test_packed_bytes_counts_what_the_ladder_packs_again(cells):
    """A batch that fails before its launch packs nothing; its two halves
    are packed, and counted, each."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with backend_fault_injection(n_failures=1, backends=("cpu",)):
            res = run_sweep(cells, cache=False, device="cpu")
    assert res.stats["bisections"] == 1
    halves = (cells[:1], cells[1:])
    want = 0
    for half in halves:
        lanes, stacks, st0, _ = pack_batch(half)
        want += sum(a.nbytes for d in (lanes, stacks, st0)
                    for a in d.values())
    assert res.stats["packed_bytes"] == want


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans and the counter
# ---------------------------------------------------------------------------

def _reader(name):
    from perfbench.harness import bench
    return bench.load_module(REPO / "perfbench" / "metrics" / f"{name}.py")


#: seconds of each span in the stand-in window of 4 calls
SPAN_S = {"sweep.pack": 2.0, "sweep.pack.fills": 1.2,
          "sweep.pack.clusters": 0.2, "sweep.pack.stack": 0.4,
          "sweep.unpack": 0.004}


class _Trace:
    """A traced window as the readers see it: each span once a call, and
    0.5 s of copies host to device."""
    spans = SPAN_S

    def span_s(self, name):
        return self.spans.get(name, 0.0)

    def span_count(self, name):
        return 4 if name in self.spans else 0

    def kernel_s(self, fragment):
        return 0.5 if fragment == "Memcpy HtoD" else 0.0


class _NoSpans(_Trace):
    """The window of a program that has no spans."""
    spans = {}


def _obs(trace, packed=(3e8, 2e8, 3e8, 2e8)):
    return {"trace": trace, "window_s": 10.0,
            "calls": [{"batch": 0, "wall_s": 2.5, "launches": {},
                       "stats": {"packed_bytes": int(b)}} for b in packed],
            "batches": []}


@pytest.mark.parametrize("name", [*METRICS, UPLOAD])
def test_metric_reads_nothing_untraced(name):
    assert _reader(name).read(_obs(None)) is None


@pytest.mark.parametrize("name", list(METRICS))
def test_span_metric_reads_ms_a_call(name):
    read = _reader(name).read
    assert read(_obs(_Trace())) == pytest.approx(
        SPAN_S[METRICS[name]] / 4 * 1e3)
    assert read(_obs(_NoSpans())) is None    # never recorded: not 0


def test_upload_metric_reads_packed_bytes_over_the_copies():
    read = _reader(UPLOAD).read
    assert read(_obs(_Trace())) == pytest.approx(1e9 / 0.5 / 1e9)
    assert read(_obs(_Trace(), packed=(0, 0))) is None

    class NoCopy(_Trace):
        def kernel_s(self, fragment):
            return 0.0
    assert read(_obs(NoCopy())) is None
