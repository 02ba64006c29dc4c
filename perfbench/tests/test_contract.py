"""BENCHMARK.json and the result line against the benchmark's contract:
keys, names, units, and that every name finds its file."""
import json
import re

import pytest

from perfbench.harness import bench

SPEC = bench.load_json(bench.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert LINE.match(c["source"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = bench.load_json(bench.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert (bench.HERE / "drivers" / f"{cfg['driver']}.py").is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    pairs, names = set(), set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in names
        names.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert (bench.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        keys = {"name", "unit", "better", "bound", "source"}
        assert set(m) - {"workloads"} == keys
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        keys = {"name", "unit", "better", "source", "layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in _cells_of(m):           # each cell reports what it moves
            assert w in _cells_of(e2e[m["moves"]])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert (bench.HERE / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells_of(m) for m in SPEC["per_layer"])


def test_run_seconds_fit_a_full_check():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1,200 s spare fit into 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


class _Trace:
    """A traced window as the readers see it."""
    window_s, busy_s = 2.0, 1.0

    def kernel_s(self, fragment):
        return 0.5 if fragment == "tlb_sweep_kernel" else 0.0


def _outcome(checks_ok=True, trace=None):
    from perfbench.tlbref import specs as fspecs, worlds
    w = worlds.build_world("synth-small", 1 << 10, 50, 1, 2)
    s = fspecs.base_spec()
    r = type("R", (), dict(accesses=50, l1_hits=10, l2_regular_hits=10,
                           l2_coalesced_hits=0, walks=30, aligned_probes=0,
                           pred_correct=0))()
    return bench.Outcome(
        checks=[bench.check("oracle_mismatches", 0 if checks_ok else 2, 0)],
        attempted=1, failed=0, end_to_end={"sweep_accesses_per_s": 10.0},
        obs={"trace": trace, "window_s": 2.0,
             "calls": [{"batch": 0, "wall_s": 0.8, "stats": {},
                        "launches": {}}] * 2,
             "batches": [{"lanes": [(w, s)], "results": [r]}]},
        memory_peak_bytes=1, trace=trace)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    cell = bench.find_cell(SPEC, "sweep.table4", 1, 1, trace)
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    out = _outcome(trace=_Trace() if trace else None)
    out.trace = None                    # no breakdown from the stand-in
    line = bench.result_line(cell, out, 2.5, dev)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["checks"]["oracle_mismatches"]["limit"] == 0
    json.loads(json.dumps(line))
    if trace:
        assert set(line["metrics"]) == {m["name"] for m in SPEC["per_layer"]}
        assert line["metrics"]["tlb_kernel_ms.sweep"]["value"] == 250.0
        assert line["metrics"]["sweep_host_ms.sweep"]["value"] == 550.0
        assert line["metrics"]["device_idle_pct.sweep"]["value"] == 50.0
        assert 0 < line["metrics"]["tlb_sweep_roofline.sweep"]["value"] < 100
    else:
        assert set(line["metrics"]) == {"sweep_accesses_per_s", "setup_s"}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
    assert line["correct"]
    assert not bench.result_line(cell, _outcome(False), 1, dev)["correct"]


def test_readers_find_nothing_untraced():
    out = _outcome()
    for m in SPEC["per_layer"]:
        assert bench.metric_reader(m["name"]).read(out.obs) is None


def test_check_reads_none_as_failed():
    assert not bench.check("x", None, 1.0)["ok"]
    assert not bench.check("x", float("nan"), 1.0)["ok"]
    assert bench.check("x", 3, 3, below=False)["ok"]


def test_cache_dirs_inside_the_checkout(monkeypatch):
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(k, raising=False)
    bench.cache_env()
    import os
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        assert os.environ[k].startswith(str(bench.ROOT / "build"))
