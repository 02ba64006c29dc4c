"""One cell of the benchmark, found by name, run once.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel count sits in a file of its own, which this module
finds by the name ``BENCHMARK.json`` gives it:

* a configuration ``<config>`` is ``configs/<config>.json``; its key
  ``driver`` names the driver, ``drivers/<driver>.py``, that sets the
  system up and runs its window;
* a traffic mix ``<traffic>`` is ``traffic/<traffic>.json``, parameters
  that the driver's general generator reads;
* a per-layer metric ``<name>`` is read by ``metrics/<name>.py``'s
  ``read(obs)`` from the observations the driver made;
* a kernel count ``<kernel>`` is ``counts/<kernel>.py``.

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

#: the benchmark's folder and the checkout's root
HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

#: top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the names and units the result line may carry
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class BenchError(RuntimeError):
    """A run that cannot give a result: no card, a missing file, a
    forbidden module."""


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import the file ``path`` as a module of its own (file names may
    hold dots, as metric names do)."""
    if not path.is_file():
        raise BenchError(f"no file {path.relative_to(ROOT)}")
    mod_name = name or "perfbench_" + re.sub(r"\W", "_", str(
        path.relative_to(HERE).with_suffix("")))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Any:
    if not path.is_file():
        raise BenchError(f"no file {path}")
    return json.loads(path.read_text())


def count(kernel: str) -> ModuleType:
    """``counts/<kernel>.py``: the operations and bytes a kernel's work
    needs, from its shapes."""
    return load_module(HERE / "counts" / f"{kernel}.py")


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names, and the
    run's arguments."""

    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    setup_done: Optional[float] = None

    @property
    def name(self) -> str:
        return self.workload["name"]

    def mark_setup_done(self) -> None:
        """Called by the driver when set-up ends, right before the
        window opens."""
        import time
        self.setup_done = time.perf_counter()


def _for_cell(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(bench: Dict[str, Any], workload: str, seed: int,
              seconds: float, trace: bool) -> Cell:
    """The cell ``workload`` of ``bench`` with its configuration and
    traffic loaded from their files."""
    wl = [w for w in bench["workloads"] if w["name"] == workload]
    if len(wl) != 1:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    wl = wl[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == wl["config"]]
    if len(cfg_entry) != 1:
        raise BenchError(f"no configuration {wl['config']!r}")
    config = load_json(ROOT / cfg_entry[0]["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, workload)]
    layer = [m for m in bench["per_layer"] if _for_cell(m, workload)]
    return Cell(workload=wl, config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer, seed=int(seed),
                seconds=float(seconds), trace=bool(trace))


def driver(cell: Cell) -> ModuleType:
    return load_module(HERE / "drivers" / f"{cell.config['driver']}.py")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name (the part
    before the first dot, compared whole) is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def check_names(line: Dict[str, Any]) -> None:
    """Every metric name and unit of a result line within the allowed
    characters; raises ``BenchError``."""
    for name, m in line["metrics"].items():
        if not NAME_RE.match(name):
            raise BenchError(f"metric name {name!r}")
        if not UNIT_RE.match(m["unit"]):
            raise BenchError(f"unit {m['unit']!r} of {name}")


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the correctness checks (each a number
    beside its limit), the counts, the end-to-end values, the
    observations the per-layer readers read, memory and the trace."""

    checks: List[Dict[str, Any]]
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    obs: Dict[str, Any]
    memory_peak_bytes: int
    trace: Any = None          # a profiling.DeviceTrace in a traced run

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks)


def check(name: str, value: float, limit: float,
          below: bool = True) -> Dict[str, Any]:
    """One compared number: ``value`` must be at most ``limit`` (or, with
    ``below=False``, at least it).  A number that could not be read
    (None, NaN) fails."""
    ok = value is not None and value == value and (
        value <= limit if below else value >= limit)
    return {"name": name, "value": value, "limit": limit,
            "side": "max" if below else "min", "ok": bool(ok)}


def result_line(cell: Cell, out: Outcome, setup_s: float,
                device: Dict[str, Any]) -> Dict[str, Any]:
    """The last line of standard output.  ``--trace 0``: the cell's
    end-to-end metrics and ``setup_s``; ``--trace 1``: its per-layer
    metrics, read by their readers (a reader that finds nothing returns
    None and the metric is left out).  The compared numbers come last."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if cell.trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(out.obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else \
                out.end_to_end.get(m["name"])
            if v is None:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line: Dict[str, Any] = {
        "correct": out.correct, "attempted": int(out.attempted),
        "failed": int(out.failed), "metrics": metrics, "device": device}
    if cell.trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                  "side": c["side"]} for c in out.checks}
    check_names(line)
    return line


def device_info(count: int, memory_peak_bytes: int, trace=None
                ) -> Dict[str, Any]:
    import torch
    info: Dict[str, Any] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": int(count), "memory_peak_bytes": int(memory_peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, for the log."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds: nvcc libraries go to ``build/``
    (the program's own choice), Triton and extension caches beside them.
    Transformers, where a library loads it, is kept from loading Flax."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
