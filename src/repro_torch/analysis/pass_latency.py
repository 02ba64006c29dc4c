"""Pass: latency model constants are single-sourced from ``LAT_*``.

The port's counterpart of the JAX checker's latency pass.  The cycle
model lives in the ``LAT_*`` constants of
``src/repro_torch/core/simulator.py``; the plain executors import them
and the CUDA kernel spells them as ``#define LAT_*`` in ``tlb_lane.cuh``.
An integer literal in executor code that happens to equal one of those
values is a magic-number duplicate waiting to go stale when the model is
retuned — this pass flags it, in the Python executors and in the
kernel's sources (``kernels/tlb_sweep/csrc/*.cu*``, comments and strings
stripped), and holds each ``#define LAT_*`` equal to the simulator's.

Only *distinctive* latency values are matched: ``LAT_*`` values below
``MIN_DISTINCTIVE`` (the 7/8-cycle probe costs) collide with way counts,
bit masks and geometry constants everywhere, so flagging them would be
pure noise.  The definition sites themselves (``LAT_X = <n>`` in
simulator.py, ``#define LAT_X <n>`` in the kernel) are exempt, as are
docstrings and comments.  Absent files are skipped, as in the JAX pass.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from . import csrc
from .framework import Finding, Repo, missing_file

RULE = "latency-constants"

SIMULATOR = "src/repro_torch/core/simulator.py"
EXECUTOR_FILES = (
    SIMULATOR,
    "src/repro_torch/core/lane_program.py",
    "src/repro_torch/core/sweep.py",
    "src/repro_torch/kernels/tlb_sweep/ops.py",
    "src/repro_torch/kernels/tlb_sweep/ref.py",
)
CSRC_DIR = "src/repro_torch/kernels/tlb_sweep/csrc"
LANE_CUH = f"{CSRC_DIR}/tlb_lane.cuh"
MIN_DISTINCTIVE = 10


def lat_constants(repo: Repo) -> Dict[int, List[str]]:
    """value -> LAT_* names defined with that value in simulator.py."""
    tree = repo.tree(SIMULATOR)
    out: Dict[int, List[str]] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("LAT_")):
            continue
        try:
            val = ast.literal_eval(node.value)
        except ValueError:
            continue
        if isinstance(val, int):
            out.setdefault(val, []).append(node.targets[0].id)
    return out


def _definition_lines(tree: ast.AST) -> set:
    lines = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("LAT_")):
            lines.update(range(node.lineno, (node.end_lineno or
                                             node.lineno) + 1))
    return lines


def _cuda_findings(repo: Repo, lats: Dict[int, List[str]],
                   values: Dict[int, List[str]]) -> List[Finding]:
    findings: List[Finding] = []
    by_name = {n: v for v, names in lats.items() for n in names}
    text = repo.text(LANE_CUH)
    if text is not None:
        defs = csrc.defines(csrc.strip(text))
        for name, d in sorted(defs.items()):
            if not name.startswith("LAT_"):
                continue
            got = csrc.int_value(d.body, defs)
            if name not in by_name:
                findings.append(Finding(
                    file=LANE_CUH, line=d.line, rule=RULE, severity="error",
                    message=f"#define {name} has no LAT_* of that name in "
                            f"simulator.py",
                    hint="the kernel's cycle model is the simulator's"))
            elif got != by_name[name]:
                findings.append(Finding(
                    file=LANE_CUH, line=d.line, rule=RULE, severity="error",
                    message=f"#define {name} is {got} but simulator.py "
                            f"has {by_name[name]}",
                    hint="retune the model in both places"))
    for name in repo.listdir(CSRC_DIR):
        if not name.endswith((".cu", ".cuh")):
            continue
        rel = f"{CSRC_DIR}/{name}"
        code = csrc.strip(repo.text(rel) or "")
        lat_lines = {line for d in csrc.defines(code).values()
                     if d.name.startswith("LAT_")
                     for line in range(d.line, d.end_line + 1)}
        for value, line in csrc.int_literals(code):
            if value in values and line not in lat_lines:
                names = " or ".join(values[value])
                findings.append(Finding(
                    file=rel, line=line, rule=RULE, severity="error",
                    message=f"magic number {value} duplicates {names}",
                    hint=f"use {names} so a retuned cycle model cannot go "
                         f"stale in the kernel"))
    return findings


def run(repo: Repo) -> List[Finding]:
    lats = lat_constants(repo)
    values = {v: names for v, names in lats.items()
              if v >= MIN_DISTINCTIVE}
    if not values:
        return [missing_file(SIMULATOR, RULE,
                             "no LAT_* constants found in simulator.py")]
    findings: List[Finding] = []
    for rel in EXECUTOR_FILES:
        tree = repo.tree(rel)
        if tree is None:
            continue
        skip = _definition_lines(tree) if rel == SIMULATOR else set()
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, int)
                    and not isinstance(node.value, bool)):
                continue
            if node.value not in values or node.lineno in skip:
                continue
            names = " or ".join(values[node.value])
            findings.append(Finding(
                file=rel, line=node.lineno, rule=RULE, severity="error",
                message=f"magic number {node.value} duplicates {names}",
                hint=f"import and use {names} so a retuned cycle model "
                     f"cannot go stale here"))
    findings.extend(_cuda_findings(repo, lats, values))
    return findings
