"""Reading the port's CUDA sources as text, for the contract passes.

The JAX checker never needed this: its kernel was Python.  The port's
kernels are CUDA C++ (``kernels/*/csrc/*.cu`` / ``*.cuh``), and the
passes read them without a compiler.  Comments and string literals are
blanked out before any name or integer is matched, with every character
kept in place, so offsets and line numbers stay those of the file: a
``150,000`` in a comment or a ``"200"`` in a message never counts as code.

Only what the passes need is understood: ``#define`` lines (with
continuation lines and function-like macros), quoted ``#include``s,
integer literals, the body of a function definition, and constant
integer expressions over literals and other defines.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Tuple


def strip(text: str, strings: bool = True) -> str:
    """``text`` with comments (and, when ``strings``, string and character
    literals) replaced by spaces; newlines and every offset are kept."""
    out = list(text)
    i, n = 0, len(text)

    def blank(a: int, b: int) -> None:
        for j in range(a, b):
            if out[j] != "\n":
                out[j] = " "

    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            blank(i, j)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            blank(i, j)
            i = j
        elif c == '"' or (c == "'" and not (i and (text[i - 1].isalnum()
                                                   or text[i - 1] == "_"))):
            # a quote after a digit or a name is a digit separator (1'000)
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
            if strings:
                blank(i, j)
            i = j
        else:
            i += 1
    return "".join(out)


def line_of(text: str, pos: int) -> int:
    """1-based line of offset ``pos``."""
    return text.count("\n", 0, pos) + 1


@dataclasses.dataclass(frozen=True)
class Define:
    name: str
    params: Optional[str]   # "X" for TLB_FEAT_CASES(X); None: object-like
    body: str               # continuation lines joined, stripped
    line: int               # line of the #define
    end_line: int           # last line of its continuation


_DEFINE = re.compile(r"^[ \t]*#[ \t]*define[ \t]+([A-Za-z_]\w*)(\([^)]*\))?"
                     r"(.*)$")


def defines(code: str) -> Dict[str, Define]:
    """Every ``#define`` of ``code`` (stripped text), by name; the last
    definition of a name wins, as after ``#undef`` and a redefinition."""
    out: Dict[str, Define] = {}
    lines = code.split("\n")
    i = 0
    while i < len(lines):
        m = _DEFINE.match(lines[i])
        start = i
        if m is None:
            i += 1
            continue
        body = [m.group(3)]
        while body[-1].rstrip().endswith("\\") and i + 1 < len(lines):
            body[-1] = body[-1].rstrip()[:-1]
            i += 1
            body.append(lines[i])
        params = m.group(2)[1:-1].strip() if m.group(2) else None
        out[m.group(1)] = Define(m.group(1), params,
                                 " ".join(b.strip() for b in body).strip(),
                                 start + 1, i + 1)
        i += 1
    return out


_INT = re.compile(r"(?<![\w.])(0[xX][0-9a-fA-F']+|\d[\d']*)[uUlL]*(?![\w.])")


def int_literals(code: str) -> List[Tuple[int, int]]:
    """``(value, line)`` of every integer literal of ``code`` (stripped
    text); floating-point literals are not integers and are skipped."""
    out = []
    for m in _INT.finditer(code):
        digits = m.group(1).replace("'", "")
        if digits[:2] in ("0x", "0X"):
            value = int(digits, 16)
        elif digits[0] == "0" and set(digits) <= set("01234567"):
            value = int(digits, 8)
        else:
            value = int(digits)
        out.append((value, line_of(code, m.start())))
    return out


def includes(text: str) -> List[Tuple[str, int]]:
    """``(path, line)`` of every quoted ``#include`` of ``text``, read
    with its comments stripped (angle-bracket includes are the
    toolkit's)."""
    code = strip(text, strings=False)
    return [(m.group(1), line_of(code, m.start())) for m in re.finditer(
        r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', code, re.M)]


def function_body(code: str, name: str) -> Optional[Tuple[str, int]]:
    """``(body, line)`` of the definition of function ``name`` in
    ``code`` (stripped text): the first ``name(...)`` whose closing
    parenthesis is followed, after qualifiers, by ``{``; the body runs to
    the matching ``}``.  None when ``name`` is never defined."""
    for m in re.finditer(r"\b%s\s*\(" % re.escape(name), code):
        depth, j = 0, m.end() - 1
        while j < len(code):
            if code[j] == "(":
                depth += 1
            elif code[j] == ")":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        rest = re.match(r"\s*(?:const\s*)?(?:noexcept\s*)?\{", code[j + 1:])
        if rest is None:
            continue
        open_at = j + 1 + rest.end() - 1
        depth, k = 0, open_at
        while k < len(code):
            if code[k] == "{":
                depth += 1
            elif code[k] == "}":
                depth -= 1
                if depth == 0:
                    return code[open_at:k + 1], line_of(code, m.start())
            k += 1
    return None


_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.LShift: lambda a, b: a << b,
           ast.RShift: lambda a, b: a >> b, ast.BitOr: lambda a, b: a | b,
           ast.BitAnd: lambda a, b: a & b, ast.BitXor: lambda a, b: a ^ b}


def int_value(expr: str, env: Dict[str, Define],
              _seen: Tuple[str, ...] = ()) -> Optional[int]:
    """The value of a constant integer expression over literals, ``+ - *
    << >> | & ^``, unary ``- ~``, parentheses and object-like defines of
    ``env``; None for anything else."""
    expr = re.sub(r"(?<![\w.])(0[xX][0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1",
                  expr.replace("'", "")).strip()
    if not expr:
        return None
    try:
        tree = ast.parse(expr, mode="eval").body
    except SyntaxError:
        return None

    def ev(node) -> Optional[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            if v is None:
                return None
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return v
            if isinstance(node.op, ast.Invert):
                return ~v
            return None
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            a, b = ev(node.left), ev(node.right)
            return None if a is None or b is None else \
                _BINOPS[type(node.op)](a, b)
        if isinstance(node, ast.Name):
            d = env.get(node.id)
            if d is None or d.params is not None or node.id in _seen:
                return None
            return int_value(d.body, env, _seen + (node.id,))
        return None

    return ev(tree)
