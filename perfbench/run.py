"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration and its traffic are found by name from
``BENCHMARK.json`` (``perfbench/harness/bench.py``).  The run sets the
system up from ``--seed``, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints, as its last
lines on standard error, each compared number beside its limit and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(and ``breakdown`` when traced) and last ``checks``.

It exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), when a file it needs is missing, and when
JAX or the JAX package is loaded in this process once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import bench  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench.cache_env()
    spec = bench.load_json(bench.ROOT / "BENCHMARK.json")
    cell = bench.find_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    import torch
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available():
        raise bench.BenchError("torch.cuda.is_available() is False: the "
                               "benchmark runs on a CUDA card only")
    if torch.cuda.device_count() < chips:
        raise bench.BenchError(f"the cell asks for {chips} cards, "
                               f"{torch.cuda.device_count()} found")
    print(f"perfbench: {cell.name} seed {cell.seed} on "
          f"{bench.power_limit()}", file=sys.stderr, flush=True)
    out = bench.driver(cell).run(cell)
    bad = bench.forbidden_modules()
    if bad:
        raise bench.BenchError("modules of JAX or the JAX package are "
                               f"loaded: {', '.join(bad[:20])}")
    if cell.setup_done is None:
        raise bench.BenchError("the driver never marked set-up done")
    setup_s = cell.setup_done - T_START
    line = bench.result_line(
        cell, out, setup_s,
        bench.device_info(chips, out.memory_peak_bytes, out.trace))
    print(f"setup_s: {setup_s!r}", file=sys.stderr)
    for c in out.checks:
        side = "<=" if c["side"] == "max" else ">="
        print(f"check {c['name']}: {c['value']!r} (limit {side} "
              f"{c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except bench.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        sys.exit(2)
