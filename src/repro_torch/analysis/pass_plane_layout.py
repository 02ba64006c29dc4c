"""Pass: packed-plane layouts come from the one table, nowhere else.

The port's counterpart of the JAX checker's plane-layout pass.
``src/repro_torch/core/plane_layout.py`` is the single source of truth
for the trailing-axis field tuples of every packed TLB plane and per-vpn
record.  This pass

* literal-evals the table and re-checks its own invariant — every plane
  carries ``asid``, and nothing but declared sidecar fields may follow
  it (probes match on ASID; the context-switch pass clears by it);
* flags any integer literal equal to a known plane/record width as the
  last entry of a shape tuple passed to an allocation call
  (``np.zeros``/``np.full``/``np.empty``, ``torch.zeros``/``torch.full``/
  ``torch.empty``, the local ``packed`` helper) in the Python executor
  sources — widths must be spelled ``PLANE_WIDTH[...]`` /
  ``*_REC_WIDTH`` so a table change propagates everywhere;
* checks the derived field-index unpacking in ``lane_program.py``
  (``TAG, ... = range(PLANE_WIDTH["l2"])``) binds exactly one name per
  L2 field, and the arity of every packed row ``torch.stack([...])``
  built in ``step_access`` against its plane's width;
* holds the CUDA kernel's spelling of the table, ``tlb_lane.cuh``, to
  it: every ``*_W`` width, every ``L2_<FIELD>`` / ``M_<FIELD>`` field
  index, and every ``S_*`` segment-plane index (``ops.SEG_KEYS``) is
  defined and equal to the table's.  Small integers in the C++ are not
  flagged by value: they collide with loop bounds and way counts.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from . import csrc
from .framework import Finding, Repo, missing_file
from .pass_kind_dispatch import str_tuple

RULE = "plane-layout"

LAYOUT = "src/repro_torch/core/plane_layout.py"
LANE_PROGRAM = "src/repro_torch/core/lane_program.py"
TLB_OPS = "src/repro_torch/kernels/tlb_sweep/ops.py"
LANE_CUH = "src/repro_torch/kernels/tlb_sweep/csrc/tlb_lane.cuh"
USE_SITES = (
    LANE_PROGRAM,
    TLB_OPS,
    "src/repro_torch/kernels/tlb_sweep/ref.py",
)
ALLOC_FUNCS = {"zeros", "full", "ones", "empty", "packed"}
# step_access row vectors -> the plane each must match
ROW_VECTORS = {"fill_vec": "l2", "l1_vec": "l1", "l1h_vec": "l1h",
               "rmm_vec": "rmm", "cl_vec": "clus", "ctlb_vec": "ctlb"}
# tlb_lane.cuh width -> the table entries it spells: a plane of
# PLANE_FIELDS or a *_FIELDS record (L1_W also strides the 2MB L1)
CUDA_WIDTHS = {"L1_W": ("l1", "l1h"), "L2_W": ("l2",), "RMM_W": ("rmm",),
               "CLUS_W": ("clus",), "CTLB_W": ("ctlb",),
               "MAP_W": ("MAP_REC_FIELDS",), "FILL_W": ("FILL_REC_FIELDS",),
               "MISC_W": ("MISC_FIELDS",)}
# tlb_lane.cuh field-index prefix -> the field tuple it indexes
CUDA_FIELD_INDICES = {"L2_": ("PLANE_FIELDS", "l2"),
                      "M_": ("MISC_FIELDS", None)}


def load_layout(repo: Repo) -> Optional[Dict[str, tuple]]:
    """The ``*_FIELDS`` literals of the layout module, by name."""
    tree = repo.tree(LAYOUT)
    if tree is None:
        return None
    out: Dict[str, tuple] = {}
    for node in getattr(tree, "body", []):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if not name.endswith("_FIELDS"):
            continue
        try:
            out[name] = ast.literal_eval(node.value)
        except ValueError:
            continue
    return out


def _callee_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _cuda_findings(repo: Repo, layout: Dict[str, tuple]) -> List[Finding]:
    text = repo.text(LANE_CUH)
    if text is None:
        return [missing_file(LANE_CUH, RULE, "file absent")]
    findings: List[Finding] = []
    defs = csrc.defines(csrc.strip(text))
    planes = layout["PLANE_FIELDS"]

    def fields_of(src: str) -> tuple:
        return planes.get(src, layout.get(src, ()))

    def expect(name: str, want: int, what: str):
        d = defs.get(name)
        got = None if d is None else csrc.int_value(d.body, defs)
        if got != want:
            findings.append(Finding(
                file=LANE_CUH, line=d.line if d else 0, rule=RULE,
                severity="error",
                message=(f"#define {name} is {got} but {what} is {want}"
                         if d is not None else
                         f"#define {name} missing ({what} is {want})"),
                hint="the kernel must spell the layout table of "
                     "core/plane_layout.py (and ops.SEG_KEYS) exactly"))

    for name, srcs in CUDA_WIDTHS.items():
        for src in srcs:
            expect(name, len(fields_of(src)), f"the width of {src}")
    for prefix, (table, key) in CUDA_FIELD_INDICES.items():
        fields = layout.get(table, {})
        fields = fields.get(key, ()) if key else fields
        names = {f"{prefix}{f.upper()}": i for i, f in enumerate(fields)}
        for name, i in names.items():
            expect(name, i, f"the index of {name[len(prefix):].lower()!r} "
                             f"in {key or table}")
        for name, d in defs.items():
            if (name.startswith(prefix) and name not in names
                    and name not in CUDA_WIDTHS):
                findings.append(Finding(
                    file=LANE_CUH, line=d.line, rule=RULE, severity="error",
                    message=f"#define {name} names no field of "
                            f"{key or table}",
                    hint="field indices follow the layout table; remove "
                         "it or add the field there"))

    ops_tree = repo.tree(TLB_OPS)
    seg_keys = str_tuple(ops_tree, "SEG_KEYS") if ops_tree else None
    if seg_keys is None:
        findings.append(missing_file(TLB_OPS, RULE,
                                     "SEG_KEYS tuple not found"))
        return findings
    names = {"S_" + k[len("seg_"):].upper(): i
             for i, k in enumerate(seg_keys)}
    for name, i in names.items():
        expect(name, i, f"the index of {seg_keys[i]!r} in SEG_KEYS")
    for name, d in defs.items():
        if name.startswith("S_") and name not in names:
            findings.append(Finding(
                file=LANE_CUH, line=d.line, rule=RULE, severity="error",
                message=f"#define {name} names no SEG_KEYS entry",
                hint="remove it or add the plane to ops.SEG_KEYS"))
    expect("N_SEG_PLANES", len(seg_keys), "len(SEG_KEYS)")
    return findings


def run(repo: Repo) -> List[Finding]:
    layout = load_layout(repo)
    if layout is None or "PLANE_FIELDS" not in layout:
        return [missing_file(LAYOUT, RULE,
                             "layout table absent or not literal-evalable")]
    findings: List[Finding] = []
    planes: Dict[str, tuple] = layout["PLANE_FIELDS"]
    sidecar = set(layout.get("SIDECAR_FIELDS", ("aux",)))

    # -- table invariants ------------------------------------------------
    for plane, fields in planes.items():
        if "asid" not in fields:
            findings.append(Finding(
                file=LAYOUT, line=0, rule=RULE, severity="error",
                message=f"plane {plane!r} has no 'asid' field",
                hint="every plane must be ASID-tagged for multi-tenant "
                     "worlds"))
            continue
        trailing = fields[fields.index("asid") + 1:]
        bad = [f for f in trailing if f not in sidecar]
        if bad:
            findings.append(Finding(
                file=LAYOUT, line=0, rule=RULE, severity="error",
                message=f"plane {plane!r}: non-sidecar fields {bad} "
                        f"follow 'asid'",
                hint="asid must be the last field except declared "
                     "SIDECAR_FIELDS"))

    widths: Set[int] = {len(f) for f in planes.values()}
    for rec in ("MAP_REC_FIELDS", "FILL_REC_FIELDS", "MISC_FIELDS"):
        if rec in layout:
            widths.add(len(layout[rec]))

    # -- no hardcoded widths at allocation sites -------------------------
    for rel in USE_SITES:
        tree = repo.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee_name(node.func) not in ALLOC_FUNCS:
                continue
            for arg in node.args:
                if not isinstance(arg, (ast.Tuple, ast.List)) or \
                        len(arg.elts) < 2:
                    continue
                e = arg.elts[-1]
                if (isinstance(e, ast.Constant)
                        and isinstance(e.value, int)
                        and not isinstance(e.value, bool)
                        and e.value in widths):
                    findings.append(Finding(
                        file=rel, line=e.lineno, rule=RULE,
                        severity="error",
                        message=f"hardcoded plane/record width "
                                f"{e.value} in "
                                f"{_callee_name(node.func)}() shape",
                        hint="spell it PLANE_WIDTH[...] / *_REC_WIDTH "
                             "from repro_torch.core.plane_layout"))

    # -- derived index unpacking matches the table -----------------------
    lane_tree = repo.tree(LANE_PROGRAM)
    if lane_tree is not None:
        l2_fields = planes.get("l2", ())
        unpack = None
        for node in ast.walk(lane_tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and any(isinstance(t, ast.Name) and t.id == "TAG"
                            for t in node.targets[0].elts)):
                unpack = node
                break
        if unpack is None:
            findings.append(Finding(
                file=LANE_PROGRAM, line=0, rule=RULE, severity="error",
                message="L2 field-index unpacking (TAG, ... = ...) not "
                        "found",
                hint="derive the indices from "
                     "range(PLANE_WIDTH['l2'])"))
        elif len(unpack.targets[0].elts) != len(l2_fields):
            findings.append(Finding(
                file=LANE_PROGRAM, line=unpack.lineno, rule=RULE,
                severity="error",
                message=f"L2 index unpacking binds "
                        f"{len(unpack.targets[0].elts)} names but the "
                        f"table declares {len(l2_fields)} fields",
                hint="one name per PLANE_FIELDS['l2'] entry"))

        # -- packed-row stack arity ------------------------------------
        step_fn = None
        for node in ast.walk(lane_tree):
            if (isinstance(node, ast.FunctionDef)
                    and node.name == "step_access"):
                step_fn = node
                break
        seen_vecs: Set[str] = set()
        if step_fn is not None:
            for node in ast.walk(step_fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id in ROW_VECTORS):
                    continue
                name = node.targets[0].id
                seen_vecs.add(name)
                call = node.value
                if not (isinstance(call, ast.Call)
                        and _callee_name(call.func) == "stack"
                        and call.args
                        and isinstance(call.args[0],
                                       (ast.List, ast.Tuple))):
                    continue
                plane = ROW_VECTORS[name]
                want = len(planes.get(plane, ()))
                got = len(call.args[0].elts)
                if got != want:
                    findings.append(Finding(
                        file=LANE_PROGRAM, line=node.lineno, rule=RULE,
                        severity="error",
                        message=f"{name} stacks {got} fields but plane "
                                f"{plane!r} is {want} wide",
                        hint="keep the packed row in lockstep with "
                             "PLANE_FIELDS"))
            for name in sorted(set(ROW_VECTORS) - seen_vecs):
                findings.append(Finding(
                    file=LANE_PROGRAM, line=0, rule=RULE,
                    severity="error",
                    message=f"step_access no longer builds {name}",
                    hint="renamed row vectors must be re-declared in "
                         "pass_plane_layout.ROW_VECTORS"))

    findings.extend(_cuda_findings(repo, layout))
    return findings
