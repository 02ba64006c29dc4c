#!/usr/bin/env python
"""Run the port's contract checker (repro_torch.analysis) on the tree.

    python scripts/check_port_contracts.py [--root DIR] [--pass RULE]
                                           [--list] [--show-suppressed]

Stdlib-only on purpose: the checker reads the port's Python and CUDA
sources instead of importing them, and this script loads
``src/repro_torch/analysis/`` as a package of its own, without
``repro_torch/__init__.py`` (which imports torch), so it runs on a bare
Python.  ``chip_smoke.py`` loads it the same way (:func:`load_analysis`)
and runs every pass before it builds a kernel.  Exit codes: 0 clean
(warnings allowed), 1 contract violations, 2 the checker itself could
not run.

Findings are printed one per line as ``file:line: [rule] severity:
message (hint)``; when ``$GITHUB_STEP_SUMMARY`` is set (CI), a markdown
table of the findings is appended there too.  Accepted exceptions live
in ``.port-contracts-suppressions`` — see docs/port.md for the passes
and docs/analysis.md for the format.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package name the checker is loaded under (no parent package, so
# repro_torch/__init__.py never runs)
PACKAGE = "repro_torch_contracts"


def load_analysis(root: str = ROOT):
    """``src/repro_torch/analysis`` of checkout ``root``, imported as the
    top-level package :data:`PACKAGE`."""
    if PACKAGE in sys.modules:
        return sys.modules[PACKAGE]
    pkg_dir = os.path.join(root, "src", "repro_torch", "analysis")
    spec = importlib.util.spec_from_file_location(
        PACKAGE, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    if spec is None:
        raise ImportError(f"no contract checker under {pkg_dir}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PACKAGE] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(PACKAGE, None)
        raise
    return mod


def _github_summary(active, suppressed, passes) -> str:
    lines = ["## Port contract checker", "",
             f"Passes run: {', '.join(p.RULE for p in passes)}", ""]
    if not active:
        lines.append(f"**Clean** — no findings "
                     f"({len(suppressed)} suppressed).")
    else:
        lines += ["| Location | Rule | Severity | Finding |",
                  "| --- | --- | --- | --- |"]
        for f in active:
            loc = f"{f.file}:{f.line}" if f.line else f.file
            msg = f.message.replace("|", "\\|")
            if f.hint:
                msg += f" — {f.hint}".replace("|", "\\|")
            lines.append(f"| `{loc}` | {f.rule} | {f.severity} | {msg} |")
        lines.append("")
        lines.append(f"{len(suppressed)} finding(s) suppressed via "
                     f"`.port-contracts-suppressions`.")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    try:
        analysis = load_analysis()
    except Exception as e:  # checker bug, not a contract violation
        print(f"contract checker failed to load: {e}", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="repository root to analyze (default: this "
                         "checkout)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=sorted(analysis.PASS_BY_RULE),
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list available passes and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    args = ap.parse_args(argv)

    if args.list:
        for p in analysis.ALL_PASSES:
            doc = (p.__doc__ or "").strip().splitlines()
            print(f"{p.RULE}: {doc[0] if doc else ''}")
        return 0

    passes = ([analysis.PASS_BY_RULE[r] for r in args.passes]
              if args.passes else list(analysis.ALL_PASSES))
    repo = analysis.Repo(args.root)
    try:
        active, suppressed = analysis.run_passes(repo, passes)
    except Exception as e:  # checker bug, not a contract violation
        print(f"contract checker failed to run: {e}", file=sys.stderr)
        return 2

    for f in active:
        print(f.render())
    if args.show_suppressed:
        for f in suppressed:
            print(f"[suppressed] {f.render()}")

    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        try:
            with open(summary_path, "a", encoding="utf-8") as fh:
                fh.write(_github_summary(active, suppressed, passes))
        except OSError:
            pass

    errors = [f for f in active if f.severity == "error"]
    warnings = [f for f in active if f.severity != "error"]
    print(f"{len(passes)} pass(es): {len(errors)} error(s), "
          f"{len(warnings)} warning(s), {len(suppressed)} suppressed")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
