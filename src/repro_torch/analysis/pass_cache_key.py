"""Pass: no cache can serve a result or a library older than its sources.

The port's counterpart of the JAX checker's cache-key pass, plus the two
keys the JAX package had no need of because its kernel was Python.

**The sweep's result cache.**  ``cell_key`` (``core/sweep.py``) must fold
every semantic input of a sweep cell; anything it misses silently serves
yesterday's counters after today's change.  Checked statically:

* **spec**: ``cell_key`` hashes ``repr(cell.spec)``, which covers every
  ``MethodSpec`` dataclass field automatically — so the pass verifies the
  ``repr(...)`` fold is still there and that no field opts out with
  ``repr=False``;
* **worlds**: each ``isinstance`` branch of ``cell_key`` must read the
  world attributes declared in ``WORLD_KEY_ATTRS``; ``_WorldPlan``'s
  fields in ``lane_program.py`` are diffed against ``WORLDPLAN_FOLDS``
  (each folded, or derived from folded data);
* **execution knobs**: ``run_sweep`` parameters must stay within
  ``EXEC_KNOB_ALLOWLIST`` — knobs proven neutral to the results;
* **code fingerprint**: ``_FINGERPRINT_SOURCES``, which ``cell_key``
  folds through ``_code_fingerprint``, names every file under
  ``kernels/tlb_sweep/csrc/`` and every port module that the lane
  program, the sweep, the simulator and the TLB op and its plain version
  reach by import, transitively — except the modules of
  ``FINGERPRINT_EXEMPT``, each with its reason — and nothing that does
  not exist (a missing file is hashed as ``?``, silently).

**The kernels' build key.**  A kernel library's file name hashes the
``nvcc`` flags and the files its ``_build.SOURCES`` names
(``kernels/_nvcc.py``), so a source left out of ``SOURCES`` never
rebuilds the library when it is edited: the card runs the old kernel.
Every file under each ``kernels/*/csrc/``, and every quoted ``#include``
of those files, must be named there, and every name there must exist.
"""
from __future__ import annotations

import ast
import posixpath
from typing import Dict, List, Optional, Set

from . import csrc
from .framework import Finding, Repo, missing_file
from .pass_kind_dispatch import str_tuple

RULE = "cache-key"

PKG = "src/repro_torch"
SWEEP = f"{PKG}/core/sweep.py"
SIMULATOR = f"{PKG}/core/simulator.py"
LANE_PROGRAM = f"{PKG}/core/lane_program.py"
KERNELS = f"{PKG}/kernels"

# Execution-only run_sweep parameters, excluded from the key by design.
EXEC_KNOB_ALLOWLIST = {
    "cells", "cache", "cache_dir",
    # picks the CUDA kernel or the plain torch version; the two are held
    # bit-exact by tests/test_torch_cuda.py (test_kernel_matches_plain and
    # the edge batches) and chip_smoke.py phase 3, so either may serve a
    # cell the other cached
    "device",
}

# Attribute reads each cell_key world branch must make.  Keyed by the
# isinstance() class name of the branch; "" is the final else (static
# mapping) branch.
WORLD_KEY_ATTRS: Dict[str, Set[str]] = {
    "ParityWorld": {"faults", "base"},
    "DynamicMapping": {"boundaries", "epochs", "ppn"},
    "MultiTenantMapping": {"boundaries", "tenant_ids", "asids",
                           "recycled", "tenants", "ppn"},
    "NestedMapping": {"boundaries", "guest_ids", "asids", "recycled",
                      "guests", "host", "epochs", "ppn"},
    "": {"ppn"},
}

# _WorldPlan fields -> how the cache key covers them.  "folded" fields
# are hashed via the world attributes above; "derived" fields are
# computed at plan time purely from folded data, so hashing them again
# would be redundant.
WORLDPLAN_FOLDS: Dict[str, str] = {
    "sources": "folded: per-source ppn digests (epochs/tenants/"
               "guests/host)",
    "bounds": "folded: world boundaries tuples",
    "src_idx": "folded: tenant_ids/guest_ids schedule identity",
    "asids": "folded: asids tuples",
    "switch": "derived: recomputed from tenant_ids/boundaries",
    "recycled": "folded: recycled tuples",
    "dirty": "derived: recomputed from consecutive epoch ppn diffs",
    "parity": "derived: spliced from the ParityWorld faults tuple, which "
              "cell_key folds verbatim",
}

# The modules whose semantics a cached cell depends on, relative to the
# package (the paths _FINGERPRINT_SOURCES uses); the fingerprint must
# name what they import, transitively, and the TLB kernel's sources.
FINGERPRINT_ROOTS = ("core/lane_program.py", "core/sweep.py",
                     "core/simulator.py", "kernels/tlb_sweep/ops.py",
                     "kernels/tlb_sweep/ref.py")
FINGERPRINT_CSRC = "kernels/tlb_sweep/csrc"
# Reached modules the fingerprint leaves out, each with why no result
# can depend on it.
FINGERPRINT_EXEMPT: Dict[str, str] = {
    "_device.py": "device resolution only: where a sweep runs, not what "
                  "it computes (see the device entry of "
                  "EXEC_KNOB_ALLOWLIST)",
    "kernels/_nvcc.py": "builds and loads a kernel library; what it "
                        "compiles is folded by content "
                        "(FINGERPRINT_CSRC), and the library name hashes "
                        "its flags",
    "kernels/tlb_sweep/_build.py": "the TLB kernel's source list and its "
                                   "ctypes signatures; the sources are "
                                   "folded by content",
    "tracing.py": "profiler spans around host work: they mark time on the "
                  "profiler's timeline and change no result",
}


def _function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _dataclass_fields(tree: ast.AST, cls: str) -> List[ast.AnnAssign]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return [n for n in node.body if isinstance(n, ast.AnnAssign)]
    return []


def _branch_attrs(fn: ast.FunctionDef) -> Dict[str, Set[str]]:
    """isinstance-class-name -> attribute names read in that cell_key
    branch (the trailing else keyed "")."""
    out: Dict[str, Set[str]] = {}

    def attrs_in(body) -> Set[str]:
        got: Set[str] = set()
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Attribute):
                    got.add(node.attr)
        return got

    def class_of(test: ast.expr) -> Optional[str]:
        if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
                and test.func.id == "isinstance" and len(test.args) == 2):
            cls = test.args[1]
            if isinstance(cls, ast.Name):
                return cls.id
            if isinstance(cls, ast.Attribute):
                return cls.attr
        return None

    def walk_chain(stmt: ast.If):
        cls = class_of(stmt.test)
        if cls is not None:
            out[cls] = attrs_in(stmt.body)
        orelse = stmt.orelse
        if len(orelse) == 1 and isinstance(orelse[0], ast.If):
            walk_chain(orelse[0])
        elif orelse:
            out[""] = attrs_in(orelse)

    for stmt in fn.body:
        if isinstance(stmt, ast.If) and class_of(stmt.test) is not None:
            walk_chain(stmt)
    return out


# -- module reachability (paths relative to the package) -----------------

def _module_file(repo: Repo, parts: List[str]) -> Optional[str]:
    rel = "/".join(parts)
    if rel and repo.exists(f"{PKG}/{rel}.py"):
        return f"{rel}.py"
    init = f"{rel}/__init__.py" if rel else "__init__.py"
    return init if repo.exists(f"{PKG}/{init}") else None


def _imports(repo: Repo, rel: str) -> Set[str]:
    """Port modules ``rel`` imports relatively, anywhere in the module,
    function bodies included."""
    tree = repo.tree(f"{PKG}/{rel}")
    if tree is None:
        return set()
    here = rel.split("/")[:-1]
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ImportFrom) and node.level
                and node.level - 1 <= len(here)):
            continue
        base = here[:len(here) - (node.level - 1)]
        base += node.module.split(".") if node.module else []
        subs = {_module_file(repo, base + [a.name]) for a in node.names}
        subs.discard(None)            # `from pkg import submodule`
        out |= subs or {_module_file(repo, base)} - {None}
    return out


def reached_modules(repo: Repo, roots=FINGERPRINT_ROOTS) -> Set[str]:
    """``roots`` and every port module they reach by import."""
    seen: Set[str] = set()
    todo = [r for r in roots if repo.exists(f"{PKG}/{r}")]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.add(rel)
        todo.extend(_imports(repo, rel) - seen)
    return seen


def _build_key_findings(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    for kernel in repo.listdir(KERNELS):
        csrc_dir = f"{KERNELS}/{kernel}/csrc"
        files = repo.listdir(csrc_dir)
        if not files:
            continue
        build = f"{KERNELS}/{kernel}/_build.py"
        tree = repo.tree(build)
        sources = str_tuple(tree, "SOURCES") if tree is not None else None
        if sources is None:
            findings.append(missing_file(build, RULE,
                                         "SOURCES tuple not found"))
            continue

        def err(rel, line, msg, hint):
            findings.append(Finding(file=rel, line=line, rule=RULE,
                                    severity="error", message=msg,
                                    hint=hint))

        for name in files:
            if name not in sources:
                err(build, 0, f"{kernel}: csrc/{name} is not in "
                              f"_build.SOURCES",
                    "the library's name hashes only SOURCES: an edit to "
                    "this file would never rebuild it")
        for name in files:
            if not name.endswith((".cu", ".cuh", ".h", ".hpp", ".inc")):
                continue
            rel = f"{csrc_dir}/{name}"
            for inc, line in csrc.includes(repo.text(rel) or ""):
                target = posixpath.normpath(
                    posixpath.join(posixpath.dirname(name), inc))
                if target not in sources:
                    err(rel, line, f"{kernel}: #include \"{inc}\" is not "
                                   f"in _build.SOURCES",
                        "every header the kernel includes must be in its "
                        "build key (and live under csrc/)")
    return findings


def _fingerprint_findings(repo: Repo, sweep_tree: ast.AST) -> List[Finding]:
    fp = str_tuple(sweep_tree, "_FINGERPRINT_SOURCES")
    if fp is None:
        return [missing_file(SWEEP, RULE,
                             "_FINGERPRINT_SOURCES tuple not found")]
    findings: List[Finding] = []
    need = {f"{FINGERPRINT_CSRC}/{n}"
            for n in repo.listdir(f"{PKG}/{FINGERPRINT_CSRC}")}
    reached = reached_modules(repo)
    need |= reached - set(FINGERPRINT_EXEMPT)
    for rel in sorted(need - set(fp)):
        findings.append(Finding(
            file=SWEEP, line=0, rule=RULE, severity="error",
            message=f"_FINGERPRINT_SOURCES does not name {rel}",
            hint="the sweep cache would serve results computed before an "
                 "edit to it; add it, or exempt it in "
                 "pass_cache_key.FINGERPRINT_EXEMPT with its reason"))
    for rel in fp:
        if not repo.exists(f"{PKG}/{rel}"):
            findings.append(Finding(
                file=SWEEP, line=0, rule=RULE, severity="error",
                message=f"_FINGERPRINT_SOURCES names {rel}, which does not "
                        f"exist",
                hint="a missing file is hashed as '?': name the file that "
                     "replaced it"))
    for rel in sorted(set(FINGERPRINT_EXEMPT) - reached):
        findings.append(Finding(
            file=SWEEP, line=0, rule=RULE, severity="warning",
            message=f"fingerprint exemption {rel} is reached by none of "
                    f"the fingerprinted modules",
            hint="remove its FINGERPRINT_EXEMPT entry"))
    return findings


def run(repo: Repo) -> List[Finding]:
    sweep_tree = repo.tree(SWEEP)
    sim_tree = repo.tree(SIMULATOR)
    lane_tree = repo.tree(LANE_PROGRAM)
    findings: List[Finding] = _build_key_findings(repo)
    if sweep_tree is None:
        return findings + [missing_file(SWEEP, RULE,
                                        "file absent or unparseable")]

    key_fn = _function(sweep_tree, "cell_key")
    if key_fn is None:
        return findings + [missing_file(SWEEP, RULE, "cell_key() not found")]

    # -- spec fold: repr(cell.spec) ------------------------------------
    has_spec_repr = any(
        isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id == "repr" and node.args
        and isinstance(node.args[0], ast.Attribute)
        and node.args[0].attr == "spec"
        for node in ast.walk(key_fn))
    if not has_spec_repr:
        findings.append(Finding(
            file=SWEEP, line=key_fn.lineno, rule=RULE, severity="error",
            message="cell_key no longer folds repr(cell.spec)",
            hint="the dataclass repr is what makes every MethodSpec "
                 "field cache-relevant automatically"))

    if sim_tree is not None:
        for field in _dataclass_fields(sim_tree, "MethodSpec"):
            val = field.value
            if not isinstance(val, ast.Call):
                continue
            fname = val.func.attr if isinstance(val.func, ast.Attribute) \
                else getattr(val.func, "id", "")
            if fname != "field":
                continue
            for kw in val.keywords:
                if (kw.arg == "repr"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False):
                    name = getattr(field.target, "id", "?")
                    findings.append(Finding(
                        file=SIMULATOR, line=field.lineno, rule=RULE,
                        severity="error",
                        message=f"MethodSpec.{name} sets repr=False and "
                                f"escapes the cache key",
                        hint="cell_key folds repr(spec); an unrepresented "
                             "field can serve stale results"))
    else:
        findings.append(missing_file(SIMULATOR, RULE,
                                     "file absent or unparseable"))

    # -- world folds per isinstance branch -----------------------------
    branches = _branch_attrs(key_fn)
    for cls, want in WORLD_KEY_ATTRS.items():
        got = branches.get(cls)
        label = cls or "<static else>"
        if got is None:
            findings.append(Finding(
                file=SWEEP, line=key_fn.lineno, rule=RULE,
                severity="error",
                message=f"cell_key has no {label} world branch",
                hint="every mapping type needs an explicit content "
                     "fold"))
            continue
        missing = want - got
        if missing:
            findings.append(Finding(
                file=SWEEP, line=key_fn.lineno, rule=RULE,
                severity="error",
                message=f"cell_key {label} branch no longer reads "
                        f"{sorted(missing)}",
                hint="these world attributes are semantic inputs; "
                     "dropping them from the key serves stale results"))
    for cls in branches:
        if cls not in WORLD_KEY_ATTRS:
            findings.append(Finding(
                file=SWEEP, line=key_fn.lineno, rule=RULE,
                severity="error",
                message=f"cell_key folds unknown world type {cls}",
                hint="declare its required attributes in "
                     "pass_cache_key.WORLD_KEY_ATTRS"))

    # -- _WorldPlan fields all classified ------------------------------
    if lane_tree is not None:
        plan_fields = [getattr(f.target, "id", "?")
                       for f in _dataclass_fields(lane_tree, "_WorldPlan")]
        if not plan_fields:
            findings.append(missing_file(LANE_PROGRAM, RULE,
                                         "_WorldPlan dataclass not found"))
        for name in plan_fields:
            if name not in WORLDPLAN_FOLDS:
                findings.append(Finding(
                    file=LANE_PROGRAM, line=0, rule=RULE,
                    severity="error",
                    message=f"_WorldPlan.{name} is not classified in the "
                            f"cache-key contract",
                    hint="declare it folded (and fold it in cell_key) or "
                         "derived in pass_cache_key.WORLDPLAN_FOLDS"))
        for name in WORLDPLAN_FOLDS:
            if name not in plan_fields:
                findings.append(Finding(
                    file=LANE_PROGRAM, line=0, rule=RULE,
                    severity="warning",
                    message=f"cache-key contract lists unknown "
                            f"_WorldPlan field {name!r}",
                    hint="remove its WORLDPLAN_FOLDS entry"))
    else:
        findings.append(missing_file(LANE_PROGRAM, RULE,
                                     "file absent or unparseable"))

    # -- run_sweep knobs stay allowlisted ------------------------------
    rs = _function(sweep_tree, "run_sweep")
    if rs is None:
        findings.append(missing_file(SWEEP, RULE, "run_sweep() not found"))
    else:
        params = [a.arg for a in rs.args.args + rs.args.kwonlyargs]
        for p in params:
            if p not in EXEC_KNOB_ALLOWLIST:
                findings.append(Finding(
                    file=SWEEP, line=rs.lineno, rule=RULE,
                    severity="error",
                    message=f"run_sweep parameter {p!r} is neither "
                            f"folded into cell_key nor allowlisted",
                    hint="if it can change results, fold it into the "
                         "key; if provably execution-only, add it to "
                         "EXEC_KNOB_ALLOWLIST with that proof"))

    findings.extend(_fingerprint_findings(repo, sweep_tree))
    return findings
