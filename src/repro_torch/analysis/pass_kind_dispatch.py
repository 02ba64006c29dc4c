"""Pass: every registered method kind is dispatched everywhere it must be.

The port's counterpart of the JAX checker's kind-dispatch pass.  The port
runs one semantics three ways — the pure-python segment oracle, the plain
torch lane program and the CUDA kernel — and the parity tests prove them
bit-exact *dynamically*, but only for the kinds they were told about.
This pass closes the registration loop statically: for every kind in the
port's ``simulator.KINDS`` it demands

* **dispatch evidence** in the oracle (``simulator.py``) and in the lane
  program (``lane_program.py``) — the kind's selector literal inside the
  named function, per the contract table below (the port has no
  ``_simulate``: its oracle is ``_run_segments`` and the segment
  builders);
* **flag plumbing** — a kind selected per lane by a boolean carries it
  through ``STEP_KEYS``, the ``lanes`` dict ``pack_lanes`` builds, the
  step, and ``PARAM_KEYS`` (``kernels/tlb_sweep/ops.py``), and on into
  the CUDA kernel: ``tlb_lane.cuh`` defines ``F_<FLAG>`` at the entry's
  index, ``load_params`` loads the ``LaneParams`` field from it and
  ``kind_of`` reads that field, so the lane picks its compiled instance
  by it (a flag the kernel never reads runs the generic datapath
  silently);
* **the kernel's params row** — every ``PARAM_KEYS`` entry has its
  ``F_*`` index and is read from the row somewhere in the kernel's
  sources (``load_params``, or the lane's start in ``tlb_sweep.cu``);
* **the kernel's lane kinds** — every ``FT_*`` bit is set by
  ``lane_feat``, ``FT_ALL`` is their OR, and every ``TLB_FEAT_CASES``
  entry is built from defined bits;
* **a golden** under ``tests/goldens/`` whose ``spec.kind`` matches;
* **test registration** — a spec factory for the kind in the port's
  ``baselines.py`` that is called in both ``tests/_torch_helpers.py::
  all_kinds`` (the CPU parity tests) and ``chip_smoke.py::_eleven_specs``
  (the kernel against its plain version on the card);
* **documentation** in ``docs/methods.md``.

The ``*_policy`` fields of ``MethodSpec`` get the same dispatch evidence,
and ``coh_policy``'s per-lane flag ``coh_hw`` the same load-and-use check
in the kernel.  A kind with no entry in ``KIND_CONTRACTS`` fails too:
adding a kind means declaring how it is dispatched, in this one table.
"""
from __future__ import annotations

import ast
import json
import re
from typing import Dict, List, Optional, Set

from . import csrc
from .framework import Finding, Repo, missing_file
from .kinds import (BASELINES, METHODS_DOC, SIMULATOR, registered_kinds,
                    spec_factories, undocumented_kinds)

RULE = "kind-dispatch"

LANE_PROGRAM = "src/repro_torch/core/lane_program.py"
TLB_OPS = "src/repro_torch/kernels/tlb_sweep/ops.py"
CSRC_DIR = "src/repro_torch/kernels/tlb_sweep/csrc"
LANE_CUH = f"{CSRC_DIR}/tlb_lane.cuh"
GOLDEN_DIR = "tests/goldens"
# (file, function): the rosters whose calls register a spec factory
ROSTERS = (("tests/_torch_helpers.py", "all_kinds"),
           ("chip_smoke.py", "_eleven_specs"))

# Per-kind dispatch contract.  ``oracle``/``lane``: (function, literal)
# pairs — the selector literal must occur inside that function of
# simulator.py / lane_program.py.  ``None`` means the kind rides the
# generic datapath there (no kind-specific selector to check).  ``flag``:
# the per-lane boolean that selects the kind's datapath in step_access
# and the kernel, or None for kinds driven by generic lane data (K
# classes, predictor).
KIND_CONTRACTS: Dict[str, Dict] = {
    "base": dict(oracle=None, lane=None, flag=None),
    "thp": dict(oracle=[("_run_segments", "thp")],
                lane=[("pack_lanes", "thp"), ("_fill_profile_key", "thp")],
                flag="is_thp"),
    "colt": dict(oracle=[("_run_segments", "colt")],
                 lane=[("pack_lanes", "colt"),
                       ("_fill_profile_key", "colt")],
                 flag="is_colt"),
    "cluster": dict(oracle=[("_run_segments", "cluster")],
                    lane=[("pack_lanes", "cluster")],
                    flag="has_cluster"),
    "rmm": dict(oracle=[("_run_segments", "rmm")],
                lane=[("pack_lanes", "rmm")],
                flag="has_rmm"),
    "anchor": dict(oracle=[("miss_chain_cycles", "anchor")],
                   lane=[("_fill_profile_key", "anchor")],
                   flag=None),
    "kaligned": dict(oracle=[("miss_chain_cycles", "kaligned")],
                     lane=[("_fill_profile_key", "kaligned")],
                     flag=None),
    "subregion": dict(oracle=[("_run_segments", "subregion")],
                      lane=[("pack_lanes", "subregion"),
                            ("_fill_profile_key", "subregion")],
                      flag="is_subr"),
    "cache-tlb": dict(oracle=[("_run_segments", "cache-tlb")],
                      lane=[("pack_lanes", "cache-tlb")],
                      flag="has_ctlb"),
    "dead-protect": dict(oracle=[("_run_segments", "dead-protect")],
                         lane=[("pack_lanes", "dead-protect")],
                         flag="use_dead"),
}

# Per-policy dispatch contract, the ``*_policy`` analogue of the kind
# table: every ``MethodSpec`` field named ``*_policy`` is an orthogonal
# per-lane knob that both executors must branch on.  ``oracle``/``lane``
# as in KIND_CONTRACTS; ``flag``: the per-lane boolean that carries the
# policy into the step and the kernel (None where the policy is packed
# into the per-segment planes instead).
POLICY_CONTRACTS: Dict[str, Dict] = {
    "ctx_policy": dict(
        oracle=[("_segs_multitenant", "flush"), ("_segs_multitenant", "tag"),
                ("_segs_nested", "flush"), ("_segs_nested", "tag")],
        lane=[("pack_lanes", "flush"), ("pack_lanes", "tag")],
        flag=None),
    "coh_policy": dict(
        oracle=[("_run_segments", "hw-coherence")],
        lane=[("pack_lanes", "hw-coherence")],
        flag="coh_hw"),
    "par_policy": dict(
        oracle=[("run_method_parity", "parity")],
        lane=[("pack_lanes", "ecc")],
        flag=None),
}


def _function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _literals_in(fn: ast.FunctionDef) -> Set[str]:
    return {n.value for n in ast.walk(fn)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def str_tuple(tree: ast.AST, name: str) -> Optional[List[str]]:
    """The literal tuple of strings assigned to ``name``, or None."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            try:
                val = ast.literal_eval(node.value)
            except ValueError:
                return None
            if isinstance(val, tuple) and all(isinstance(v, str)
                                              for v in val):
                return list(val)
    return None


def _dict_keys_built(fn: ast.FunctionDef, var: str) -> Set[str]:
    """Keys of the ``var = dict(...)`` literal plus ``var["k"] = ...`` and
    ``var["k"][i] = ...`` writes inside ``fn``."""
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == var
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id == "dict"):
            keys.update(kw.arg for kw in node.value.keywords if kw.arg)
        if isinstance(node, ast.Subscript):
            tgt = node.value
            while isinstance(tgt, ast.Subscript):
                tgt = tgt.value
            if (isinstance(tgt, ast.Name) and tgt.id == var
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                keys.add(node.slice.value)
    return keys


def _names_in(fn: ast.FunctionDef) -> Set[str]:
    return {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}


def _golden_kinds(repo: Repo) -> Set[str]:
    out: Set[str] = set()
    for name in repo.listdir(GOLDEN_DIR):
        if not name.endswith(".json"):
            continue
        text = repo.text(f"{GOLDEN_DIR}/{name}")
        try:
            data = json.loads(text or "")
        except json.JSONDecodeError:
            continue
        kind = (data.get("spec") or {}).get("kind")
        if kind:
            out.add(kind)
    return out


def _roster_calls(repo: Repo, rel: str, fname: str) -> Optional[Set[str]]:
    """Names called inside function ``fname`` of ``rel`` (``f()`` and
    ``b.f()`` alike), or None when the function is absent."""
    tree = repo.tree(rel)
    fn = _function(tree, fname) if tree is not None else None
    if fn is None:
        return None
    out: Set[str] = set()
    for c in ast.walk(fn):
        if isinstance(c, ast.Call):
            if isinstance(c.func, ast.Name):
                out.add(c.func.id)
            elif isinstance(c.func, ast.Attribute):
                out.add(c.func.attr)
    return out


def _kernel_codes(repo: Repo) -> Dict[str, str]:
    """The TLB kernel's sources (``csrc/*.cu`` / ``*.cuh``), stripped of
    comments and strings, by repo-relative path."""
    out = {}
    for name in repo.listdir(CSRC_DIR):
        if name.endswith((".cu", ".cuh")):
            rel = f"{CSRC_DIR}/{name}"
            out[rel] = csrc.strip(repo.text(rel) or "")
    return out


def _cuda_findings(repo: Repo, param_keys: List[str],
                   flags: Dict[str, str]) -> List[Finding]:
    """The kernel's side of the flag plumbing.  ``flags``: lane flag ->
    what it selects (``kind 'colt'`` or ``policy coh_policy``)."""
    text = repo.text(LANE_CUH)
    if text is None:
        return [missing_file(LANE_CUH, RULE, "file absent")]
    findings: List[Finding] = []

    def err(msg, hint, line=0, rel=LANE_CUH):
        findings.append(Finding(file=rel, line=line, rule=RULE,
                                severity="error", message=msg, hint=hint))

    code = csrc.strip(text)
    defs = csrc.defines(code)
    codes = _kernel_codes(repo)

    # -- the params row: one F_* index per PARAM_KEYS entry, each read ----
    want = {f"F_{k.upper()}": (i, k) for i, k in enumerate(param_keys)}
    for name, (i, k) in want.items():
        d = defs.get(name)
        if d is None:
            err(f"PARAM_KEYS entry {k!r} has no #define {name}",
                "the kernel reads the params row through F_* indices in "
                "PARAM_KEYS order")
            continue
        v = csrc.int_value(d.body, defs)
        if v != i:
            err(f"#define {name} is {v} but {k!r} is PARAM_KEYS[{i}]",
                "keep the F_* indices in PARAM_KEYS order", d.line)
        read = re.compile(r"\w\s*\+\s*%s\b|\[\s*%s\s*\]" % (name, name))
        if not any(read.search(c) for c in codes.values()):
            err(f"the kernel never reads the params row at {name} "
                f"({k!r})",
                "load it in load_params (or where the lane starts); a "
                "packed scalar the kernel ignores changes nothing on the "
                "card", d.line)
    for name, d in defs.items():
        if name.startswith("F_") and name not in want:
            err(f"#define {name} names no PARAM_KEYS entry",
                "remove it or add its key to PARAM_KEYS", d.line)
    d = defs.get("N_PARAM_FIELDS")
    if d is None or csrc.int_value(d.body, defs) != len(param_keys):
        err(f"N_PARAM_FIELDS is not len(PARAM_KEYS) = {len(param_keys)}",
            "the kernel strides the params row by it",
            d.line if d else 0)

    # -- per-lane flags: loaded in load_params, used where they select -----
    load = csrc.function_body(code, "load_params")
    kind_of = csrc.function_body(code, "kind_of")
    if load is None or kind_of is None:
        err("load_params() / kind_of() not found in the kernel",
            "the flag checks read both; update pass_kind_dispatch if they "
            "were renamed")
    else:
        for flag, what in flags.items():
            fname = f"F_{flag.upper()}"
            if not re.search(r"\.\s*%s\s*=[^=;][^;]*\b%s\b" % (flag, fname),
                             load[0]):
                err(f"{what}: load_params does not load LaneParams."
                    f"{flag} from {fname}",
                    "the lane's flag must reach the kernel's step",
                    load[1])
            if what.startswith("kind"):
                if not re.search(r"\.\s*%s\b" % flag, kind_of[0]):
                    err(f"{what}: kind_of never reads LaneParams.{flag}",
                        "the lane would pick the generic instance and run "
                        "the generic datapath", kind_of[1])
            elif not any(re.search(r"\.\s*%s\b(?!\s*=[^=])" % flag, c)
                         for c in codes.values()):
                err(f"{what}: the kernel never uses LaneParams.{flag}",
                    "a policy flag the kernel loads but never reads "
                    "dispatches nothing")

    # -- lane kinds: FT_* bits, lane_feat, FT_ALL, TLB_FEAT_CASES ----------
    bits = {n: csrc.int_value(d.body, defs) for n, d in defs.items()
            if n.startswith("FT_") and n != "FT_ALL"}
    if not bits:
        err("no FT_* lane-kind bits defined",
            "the kernel compiles one instance per FT_* combination")
    feat = csrc.function_body(code, "lane_feat")
    if feat is None:
        err("lane_feat() not found in the kernel",
            "the lane-kind checks read it")
    else:
        for n in sorted(bits):
            if not re.search(r"\b%s\b" % n, feat[0]):
                err(f"lane_feat never sets {n}",
                    "no lane would take the instance that bit selects, "
                    "and lanes of that kind would lose it", feat[1])
    d = defs.get("FT_ALL")
    union = 0
    for v in bits.values():
        union |= v or 0
    if d is None or csrc.int_value(d.body, defs) != union:
        err(f"FT_ALL is not the OR of the FT_* bits ({union})",
            "the FT_ALL instance reads every flag at run time",
            d.line if d else 0)
    d = defs.get("TLB_FEAT_CASES")
    if d is None or not d.params:
        err("TLB_FEAT_CASES(X) not defined",
            "the lane kinds with an instance of their own")
    else:
        for m in re.finditer(r"\b%s\s*\(([^()]*)\)" % re.escape(d.params),
                             d.body):
            expr = m.group(1)
            bad = [t for t in re.findall(r"[A-Za-z_]\w*", expr)
                   if t not in bits]
            if bad or csrc.int_value(expr, defs) is None:
                err(f"TLB_FEAT_CASES entry {expr.strip()!r} is not built "
                    f"from defined FT_* bits",
                    "each case is an OR of FT_* bits", d.line)
    return findings


def run(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    sim_tree = repo.tree(SIMULATOR)
    lane_tree = repo.tree(LANE_PROGRAM)
    if sim_tree is None or lane_tree is None:
        bad = SIMULATOR if sim_tree is None else LANE_PROGRAM
        return [missing_file(bad, RULE, "file absent or unparseable")]
    try:
        kinds = registered_kinds(repo)
    except ValueError as e:
        return [missing_file(SIMULATOR, RULE, str(e))]

    def fn_literals(tree, rel, name) -> Optional[Set[str]]:
        fn = _function(tree, name)
        if fn is None:
            findings.append(Finding(
                file=rel, line=0, rule=RULE, severity="error",
                message=f"expected function {name}() not found",
                hint="the kind-dispatch contract table names it; update "
                     "KIND_CONTRACTS if it was renamed"))
            return None
        return _literals_in(fn)

    lit_cache: Dict = {}

    def check_evidence(kind, where, tree, rel):
        for fname, literal in where or []:
            key = (rel, fname)
            if key not in lit_cache:
                lit_cache[key] = fn_literals(tree, rel, fname)
            lits = lit_cache[key]
            if lits is not None and literal not in lits:
                findings.append(Finding(
                    file=rel, line=0, rule=RULE, severity="error",
                    message=f"kind {kind!r}: selector literal {literal!r} "
                            f"missing from {fname}()",
                    hint="the executor no longer dispatches this kind "
                         "here; restore the dispatch or update "
                         "KIND_CONTRACTS"))

    step_keys = str_tuple(lane_tree, "STEP_KEYS")
    ops_tree = repo.tree(TLB_OPS)
    param_keys = (str_tuple(ops_tree, "PARAM_KEYS")
                  if ops_tree is not None else None)
    if step_keys is None:
        findings.append(missing_file(LANE_PROGRAM, RULE,
                                     "STEP_KEYS tuple not found"))
    if param_keys is None:
        findings.append(missing_file(TLB_OPS, RULE,
                                     "PARAM_KEYS tuple not found"))

    pack_fn = _function(lane_tree, "pack_lanes")
    step_fn = _function(lane_tree, "step_access")
    lanes_keys = (_dict_keys_built(pack_fn, "lanes")
                  if pack_fn is not None else set())
    step_names = _names_in(step_fn) if step_fn is not None else set()
    step_strings = _literals_in(step_fn) if step_fn is not None else set()

    golden_kinds = _golden_kinds(repo)
    factories = spec_factories(repo)
    rosters = []
    for rel, fname in ROSTERS:
        calls = _roster_calls(repo, rel, fname)
        if calls is None:
            findings.append(missing_file(rel, RULE,
                                         f"{fname}() not found"))
        else:
            rosters.append((rel, fname, calls))

    def check_flag(flag, what, python_step=True):
        for keys, rel, where in ((step_keys, LANE_PROGRAM, "STEP_KEYS"),
                                 (param_keys, TLB_OPS, "PARAM_KEYS")):
            if keys is not None and flag not in keys:
                findings.append(Finding(
                    file=rel, line=0, rule=RULE, severity="error",
                    message=f"{what}: lane flag {flag!r} missing from "
                            f"{where}",
                    hint="the flag must flow through the plain step's "
                         "lane dict and the kernel's params row"))
        if pack_fn is not None and flag not in lanes_keys:
            findings.append(Finding(
                file=LANE_PROGRAM, line=0, rule=RULE, severity="error",
                message=f"{what}: pack_lanes never sets lanes[{flag!r}]",
                hint="every STEP_KEYS flag must be packed per lane"))
        if (python_step and step_fn is not None and flag not in step_names
                and flag not in step_strings):
            findings.append(Finding(
                file=LANE_PROGRAM, line=0, rule=RULE, severity="error",
                message=f"{what}: step_access never reads lane flag "
                        f"{flag!r}",
                hint="the shared step is the plain datapath; a flag it "
                     "ignores dispatches nothing"))

    cuda_flags: Dict[str, str] = {}
    for kind in kinds:
        contract = KIND_CONTRACTS.get(kind)
        if contract is None:
            findings.append(Finding(
                file=SIMULATOR, line=0, rule=RULE, severity="error",
                message=f"kind {kind!r} has no entry in the dispatch "
                        f"contract table",
                hint="declare its oracle/lane selectors and flag in "
                     "repro_torch.analysis.pass_kind_dispatch."
                     "KIND_CONTRACTS"))
            continue
        check_evidence(kind, contract["oracle"], sim_tree, SIMULATOR)
        check_evidence(kind, contract["lane"], lane_tree, LANE_PROGRAM)
        if contract["flag"] is not None:
            check_flag(contract["flag"], f"kind {kind!r}")
            cuda_flags[contract["flag"]] = f"kind {kind!r}"

        if kind not in golden_kinds:
            findings.append(Finding(
                file=GOLDEN_DIR, line=0, rule=RULE, severity="error",
                message=f"kind {kind!r} has no golden trace",
                hint="add one via scripts/make_goldens.py"))
        fnames = factories.get(kind, [])
        if not fnames:
            findings.append(Finding(
                file=BASELINES, line=0, rule=RULE, severity="error",
                message=f"kind {kind!r} has no spec factory",
                hint="add a *_spec() factory so tests can register it"))
            continue
        for rel, fname, calls in rosters:
            if not set(fnames) & calls:
                findings.append(Finding(
                    file=rel, line=0, rule=RULE, severity="error",
                    message=f"kind {kind!r}: no factory of {fnames} is "
                            f"called in {fname}()",
                    hint="register the kind so the CPU parity tests and "
                         "the card's kernel-vs-plain check exercise it"))

    # -- MethodSpec *_policy knobs: declared and dispatched -------------
    policy_fields: Set[str] = set()
    for node in ast.walk(sim_tree):
        if isinstance(node, ast.ClassDef) and node.name == "MethodSpec":
            policy_fields = {
                n.target.id for n in node.body
                if isinstance(n, ast.AnnAssign)
                and isinstance(n.target, ast.Name)
                and n.target.id.endswith("_policy")}
    for field in sorted(policy_fields):
        contract = POLICY_CONTRACTS.get(field)
        if contract is None:
            findings.append(Finding(
                file=SIMULATOR, line=0, rule=RULE, severity="error",
                message=f"MethodSpec.{field} has no entry in the policy "
                        f"dispatch contract table",
                hint="declare its oracle/lane selector literals in "
                     "repro_torch.analysis.pass_kind_dispatch."
                     "POLICY_CONTRACTS"))
            continue
        check_evidence(field, contract["oracle"], sim_tree, SIMULATOR)
        check_evidence(field, contract["lane"], lane_tree, LANE_PROGRAM)
        if contract["flag"] is not None:
            # the plain version reads coh_hw in shoot_lane, not the step
            check_flag(contract["flag"], f"policy {field}",
                       python_step=False)
            cuda_flags[contract["flag"]] = f"policy {field}"
    for field in POLICY_CONTRACTS:
        if field not in policy_fields:
            findings.append(Finding(
                file=SIMULATOR, line=0, rule=RULE, severity="warning",
                message=f"policy contract table lists unknown MethodSpec "
                        f"field {field!r}",
                hint="remove its POLICY_CONTRACTS entry"))

    for kind in undocumented_kinds(repo):
        findings.append(Finding(
            file=METHODS_DOC, line=0, rule=RULE, severity="error",
            message=f"kind {kind!r} is not documented",
            hint="add a `kind`-quoted section to docs/methods.md"))

    # Stale contract entries (kind removed from KINDS but not from the
    # table) — keep the table honest in both directions.
    for kind in KIND_CONTRACTS:
        if kind not in kinds:
            findings.append(Finding(
                file=SIMULATOR, line=0, rule=RULE, severity="warning",
                message=f"contract table lists unregistered kind "
                        f"{kind!r}",
                hint="remove its KIND_CONTRACTS entry"))

    # Scalar plumbing stays in sync: every step key except the kvals
    # vector (the kernel takes it as an array of its own) has a params-row
    # slot, and pack_lanes packs every step key.
    if step_keys is not None and param_keys is not None:
        for key in step_keys:
            if key != "kvals" and key not in param_keys:
                findings.append(Finding(
                    file=TLB_OPS, line=0, rule=RULE, severity="error",
                    message=f"STEP_KEYS entry {key!r} missing from "
                            f"PARAM_KEYS",
                    hint="the kernel's params row must carry every lane "
                         "scalar"))
    if step_keys is not None and pack_fn is not None:
        for key in step_keys:
            if key not in lanes_keys:
                findings.append(Finding(
                    file=LANE_PROGRAM, line=0, rule=RULE, severity="error",
                    message=f"STEP_KEYS entry {key!r} is never packed by "
                            f"pack_lanes",
                    hint="add it to the lanes dict"))
    if param_keys is not None:
        findings.extend(_cuda_findings(repo, param_keys, cuda_flags))
    return findings
