"""Contract-checker framework: findings, suppressions, the pass manager.

A copy of the JAX package's ``analysis/framework.py`` for the port's
checker.  The analysis package is **stdlib-only** — every pass works on
source text (Python through :mod:`ast`, the CUDA sources as text) and
never imports the code it checks — so ``scripts/check_port_contracts.py``
runs on a bare Python with no torch installed.  Keep it that way: a pass
that needs a fact about the port parses it out of its source.

A *pass* is a module with a ``RULE`` string and a ``run(repo) ->
list[Finding]`` function; the registry lives in
:mod:`repro_torch.analysis.__init__`.  Passes read files through
:class:`Repo`, which caches text and parsed trees and can be pointed at
any directory shaped like this repository, not just the live checkout
(the seeded-violation tests run the passes on mutated clones).

Suppressions: accepted exceptions live in ``.port-contracts-suppressions``
at the repo root (the JAX checker keeps its own file, so neither run sees
the other's entries as unused), one per line::

    rule | path-glob | message-substring | rationale

A finding is suppressed when its rule matches exactly, its file matches
the glob (:mod:`fnmatch` against the repo-relative posix path), and the
substring occurs in its message.  Suppressions that match nothing are
themselves reported as warnings, so the file cannot accumulate dead
entries.  Lines starting with ``#`` and blank lines are ignored.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Dict, List, Optional, Sequence, Tuple

SUPPRESSION_FILE = ".port-contracts-suppressions"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation, anchored to a source location."""

    file: str           # repo-relative posix path
    line: int           # 1-based; 0 when the finding is file-level
    rule: str           # the reporting pass's RULE id
    severity: str       # "error" fails the build; "warning" does not
    message: str        # what is wrong
    hint: str = ""      # how to fix it

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        text = f"{loc}: [{self.rule}] {self.severity}: {self.message}"
        if self.hint:
            text += f"  ({self.hint})"
        return text


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    path_glob: str
    substring: str
    rationale: str
    line: int           # line in the suppression file, for diagnostics

    def matches(self, f: Finding) -> bool:
        return (self.rule == f.rule
                and fnmatch.fnmatch(f.file, self.path_glob)
                and self.substring in f.message)


class Repo:
    """Read-only view of a repository tree with text/AST caches.

    ``root`` may be the live checkout or a fixture directory; passes must
    resolve every file through it so the seeded-violation tests can run
    them against synthetic trees.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._text: Dict[str, Optional[str]] = {}
        self._tree: Dict[str, Optional[ast.AST]] = {}

    def path(self, rel: str) -> str:
        return os.path.join(self.root, *rel.split("/"))

    def exists(self, rel: str) -> bool:
        return os.path.exists(self.path(rel))

    def text(self, rel: str) -> Optional[str]:
        """File contents, or None when the file is absent."""
        if rel not in self._text:
            try:
                with open(self.path(rel), encoding="utf-8") as f:
                    self._text[rel] = f.read()
            except OSError:
                self._text[rel] = None
        return self._text[rel]

    def tree(self, rel: str) -> Optional[ast.AST]:
        """Parsed AST, or None when the file is absent/unparseable."""
        if rel not in self._tree:
            src = self.text(rel)
            try:
                self._tree[rel] = None if src is None else ast.parse(src)
            except SyntaxError:
                self._tree[rel] = None
        return self._tree[rel]

    def listdir(self, rel: str) -> List[str]:
        try:
            return sorted(os.listdir(self.path(rel)))
        except OSError:
            return []


def missing_file(rel: str, rule: str, why: str) -> Finding:
    return Finding(file=rel, line=0, rule=rule, severity="error",
                   message=f"cannot analyze: {why}",
                   hint="the contract checker expects this file to exist "
                        "and parse")


def load_suppressions(repo: Repo,
                      rel: str = SUPPRESSION_FILE) -> List[Suppression]:
    src = repo.text(rel)
    if src is None:
        return []
    out: List[Suppression] = []
    for i, raw in enumerate(src.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split("|")]
        if len(parts) != 4:
            # malformed lines surface as findings via run_passes below
            out.append(Suppression(rule="<malformed>", path_glob="",
                                   substring=raw, rationale="", line=i))
            continue
        out.append(Suppression(rule=parts[0], path_glob=parts[1],
                               substring=parts[2], rationale=parts[3],
                               line=i))
    return out


def run_passes(repo: Repo, passes: Sequence,
               ) -> Tuple[List[Finding], List[Finding]]:
    """Run ``passes`` and apply suppressions.

    Returns ``(active, suppressed)``.  ``active`` includes warnings for
    malformed or unused suppression entries; callers fail on any active
    finding with severity ``error``.
    """
    findings: List[Finding] = []
    for mod in passes:
        findings.extend(mod.run(repo))

    sups = load_suppressions(repo)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(sups)
    for f in findings:
        hit = None
        for i, s in enumerate(sups):
            if s.rule != "<malformed>" and s.matches(f):
                hit = i
                break
        if hit is None:
            active.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    for s, u in zip(sups, used):
        if s.rule == "<malformed>":
            active.append(Finding(
                file=SUPPRESSION_FILE, line=s.line, rule="suppressions",
                severity="error",
                message=f"malformed suppression line: {s.substring!r}",
                hint="expected 'rule | path-glob | substring | rationale'"))
        elif not u:
            active.append(Finding(
                file=SUPPRESSION_FILE, line=s.line, rule="suppressions",
                severity="warning",
                message=f"suppression matches no finding: "
                        f"{s.rule} | {s.path_glob} | {s.substring}",
                hint="delete stale entries so accepted exceptions stay "
                     "auditable"))
    return active, suppressed


def has_errors(findings: Sequence[Finding]) -> bool:
    return any(f.severity == "error" for f in findings)
