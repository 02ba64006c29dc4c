"""Static parsers for the port's method-kind registry.

A copy of the JAX package's ``analysis/kinds.py`` pointed at the port:
the kinds are ``KINDS`` / ``ACCEL_KINDS`` of
``src/repro_torch/core/simulator.py`` and the spec factories those of
``src/repro_torch/core/baselines.py``.  The kinds are the JAX package's,
so one document, ``docs/methods.md``, serves both checkers.

Everything here reads source via :mod:`ast` — importing
``repro_torch.core.simulator`` would drag in torch, which the checker
must not require.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

SIMULATOR = "src/repro_torch/core/simulator.py"
BASELINES = "src/repro_torch/core/baselines.py"
METHODS_DOC = "docs/methods.md"


def _tuple_assignments(tree: ast.AST) -> Dict[str, ast.expr]:
    out: Dict[str, ast.expr] = {}
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                out.setdefault(t.id, node.value)
    return out


def _eval_str_tuple(expr: ast.expr,
                    env: Dict[str, ast.expr]) -> Optional[List[str]]:
    """Evaluate a tuple-of-strings expression: literals, names bound to
    such tuples, and ``+`` concatenation (the shapes ``KINDS`` uses)."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        vals: List[str] = []
        for e in expr.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            vals.append(e.value)
        return vals
    if isinstance(expr, ast.Name):
        if expr.id not in env:
            return None
        return _eval_str_tuple(env[expr.id], env)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _eval_str_tuple(expr.left, env)
        right = _eval_str_tuple(expr.right, env)
        if left is None or right is None:
            return None
        return left + right
    return None


def _kinds_from_tree(tree: ast.AST, name: str) -> List[str]:
    env = _tuple_assignments(tree)
    if name not in env:
        raise ValueError(f"no assignment to {name} found in simulator")
    vals = _eval_str_tuple(env[name], env)
    if vals is None:
        raise ValueError(f"{name} is not a static tuple of strings")
    seen, out = set(), []
    for v in vals:
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def registered_kinds(repo) -> List[str]:
    """All method kinds (``simulator.KINDS``), parsed statically.

    ``repo`` is a :class:`repro_torch.analysis.framework.Repo` (or anything
    with a compatible ``tree``/``text`` API) rooted at the repository.
    """
    tree = repo.tree(SIMULATOR)
    if tree is None:
        raise ValueError(f"cannot parse {SIMULATOR}")
    return _kinds_from_tree(tree, "KINDS")


def accel_kinds(repo) -> List[str]:
    """The accelerator-lineage subset (``simulator.ACCEL_KINDS``)."""
    tree = repo.tree(SIMULATOR)
    if tree is None:
        raise ValueError(f"cannot parse {SIMULATOR}")
    return _kinds_from_tree(tree, "ACCEL_KINDS")


def spec_factories(repo) -> Dict[str, List[str]]:
    """kind -> spec-factory function names, parsed from baselines.py.

    A factory is a module-level function whose body constructs a
    ``MethodSpec(kind="...")`` (directly or in a return expression).
    """
    tree = repo.tree(BASELINES)
    out: Dict[str, List[str]] = {}
    if tree is None:
        return out
    for node in getattr(tree, "body", []):
        if not isinstance(node, ast.FunctionDef):
            continue
        for call in ast.walk(node):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Name)
                    and call.func.id == "MethodSpec"):
                continue
            for kw in call.keywords:
                if (kw.arg == "kind" and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)):
                    out.setdefault(kw.value.value, []).append(node.name)
    return out


def undocumented_kinds(repo) -> List[str]:
    """Kinds missing a `` `kind` `` mention in docs/methods.md."""
    doc = repo.text(METHODS_DOC)
    if doc is None:
        return list(registered_kinds(repo))
    return [k for k in registered_kinds(repo) if f"`{k}`" not in doc]
