"""Behavioral-source expression compiler (B elements, extended dialect).

Compiles ngspice-style behavioral expressions — arithmetic over ``v(a)`` /
``v(a,b)`` node voltages, ``i(vname)`` branch currents, and ``time`` — into
pure NumPy callables:

    refs, fn = compile_bexpr("5*tanh(2*v(in)) + 1m*i(vs)*time")
    # refs: [("v", "in", None), ("i", "vs", None)]
    # fn(vals, t) -> value, with vals[..., j] the j-th reference's value

The reference set is discovered at compile time, so the engines gather
``vals[..., j] = x_pad[a_j] - x_pad[b_j]`` with system-appropriate index
remapping and compute the Newton linearization as per-reference partial
derivatives — each partial stamps as a VCCS row, the zeroth-order term as
a current injection. No new stamp machinery is needed.

This copy keeps only the NumPy function table: the AC path never
evaluates a behavioral expression (V-kind sources stamp as 0 V shorts,
I-kind sources are not stamped), and the transient refuses B sources, so
a torch table comes with them (ROADMAP §1 item 2).

Like parsing/params.py, evaluation is a whitelisted AST walk: numeric
literals (engineering suffixes allowed), + - * / **, parens, unary +/-,
and sqrt/exp/log/log10/sin/cos/tan/tanh/sinh/cosh/atan/abs/min/max.
No eval(), no attribute access.
"""

from __future__ import annotations

import ast
import re
from typing import Callable

import numpy as _np

from .numbers import parse_number_with_units
from .params import _ENG_NUM_RE

_FUNCS_NP = {
    "sqrt": _np.sqrt, "exp": _np.exp, "log": _np.log, "log10": _np.log10,
    "sin": _np.sin, "cos": _np.cos, "tan": _np.tan, "tanh": _np.tanh,
    "sinh": _np.sinh, "cosh": _np.cosh, "atan": _np.arctan,
    "abs": _np.abs, "min": _np.minimum, "max": _np.maximum,
}
_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a ** b,
}
_UNARYOPS = {ast.USub: lambda a: -a, ast.UAdd: lambda a: a}


_REF_RE = re.compile(r"\b([vViI])\s*\(([^()]*)\)")
_REF_PLACEHOLDER = re.compile(r"^__ref(\d+)__$")


def compile_bexpr(expr: str) -> tuple[list[tuple], Callable]:
    """Compile one behavioral expression.

    Returns (refs, fn): ``refs`` is the ordered list of distinct
    ("v"|"i", name, name2|None) references; ``fn(vals, t)`` evaluates the
    expression with ``vals[..., j]`` as reference j's value and ``t`` the
    absolute time (broadcast against vals' batch dims). The closure is
    built over NumPy ufuncs.
    """
    funcs = _FUNCS_NP
    refs: list[tuple] = []

    # extract v()/i() references FIRST and replace them with placeholder
    # names: node/source names are arbitrary SPICE tokens (including Python
    # keywords like "in" or pure numbers like "2") that ast.parse rejects
    def _take_ref(m: re.Match) -> str:
        kind = m.group(1).lower()
        names = [a.strip() for a in m.group(2).split(",") if a.strip()]
        if kind == "v" and len(names) in (1, 2):
            ref = ("v", names[0], names[1] if len(names) == 2 else None)
        elif kind == "i" and len(names) == 1:
            ref = ("i", names[0], None)
        else:
            raise ValueError(f"malformed {kind}() reference in {expr!r}")
        if ref not in refs:
            refs.append(ref)
        return f"__ref{refs.index(ref)}__"

    substituted = _REF_RE.sub(_take_ref, expr)
    normalized = _ENG_NUM_RE.sub(
        lambda m: (m.group(0) if m.group(1) is None
                   else repr(parse_number_with_units(m.group(1)))),
        substituted)
    try:
        tree = ast.parse(normalized, mode="eval").body
    except SyntaxError as err:
        raise ValueError(f"malformed behavioral expression {expr!r}") from err

    def build(node: ast.AST) -> Callable:
        """AST -> closure(vals, t); reference discovery happens up front."""
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (int, float)):
            c = float(node.value)
            return lambda vals, t: c
        if isinstance(node, ast.Name):
            ph = _REF_PLACEHOLDER.match(node.id)
            if ph:
                j = int(ph.group(1))
                return lambda vals, t: vals[..., j]
            if node.id.lower() == "time":
                return lambda vals, t: t
            raise ValueError(
                f"unknown name {node.id!r} in behavioral expression "
                f"{expr!r} (only time, v(...), i(...) and functions)")
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            op = _BINOPS[type(node.op)]
            left = build(node.left)
            right = build(node.right)
            return lambda vals, t: op(left(vals, t), right(vals, t))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            op = _UNARYOPS[type(node.op)]
            sub = build(node.operand)
            return lambda vals, t: op(sub(vals, t))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            fname = node.func.id.lower()
            if fname in funcs and not node.keywords:
                fn = funcs[fname]
                args = [build(a) for a in node.args]
                return lambda vals, t: fn(*[a(vals, t) for a in args])
        raise ValueError(
            f"unsupported construct in behavioral expression {expr!r}")

    body = build(tree)
    return refs, body
