"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the program and
passes).  A fresh process drives a tiny run of the driver on the CPU,
reads every per-layer metric's reader, and lists what it holds."""
import json
import subprocess
import sys

from perfbench.harness import bench

CODE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench.harness import bench
from perfbench.tests import tiny
bench.cache_env()
cell = tiny.sweep_cell()
out = tiny.driver(cell).run(cell)
dev = {{"platform": "gpu", "kind": "cpu", "count": 1,
       "memory_peak_bytes": 0}}
bench.result_line(cell, out, 1.0, dev)
cell.trace = True
bench.result_line(cell, out, 1.0, dev)
for m in tiny.SPEC["per_layer"]:
    bench.metric_reader(m["name"])
bench.load_module(bench.HERE / "controls" / "sweep_control.py")
print(json.dumps({{"bad": bench.forbidden_modules(),
                  "program": "repro_torch" in sys.modules}}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = CODE.format(root=str(bench.ROOT), src=str(bench.ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(bench.ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["program"]
    assert got["bad"] == []


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in bench.forbidden_modules()
