"""Global netlist parameters: ``.param`` + ``{expression}`` substitution.

An extended-dialect preprocessing pass (no reference analog — ngspice
semantics): ``.param name=expr ...`` lines define named constants, evaluated
in file order (later definitions may reference earlier ones), and any
``{expr}`` token elsewhere in the netlist is replaced by its evaluated
value before element parsing. Runs BEFORE subcircuit flattening so braces
inside ``.subckt`` bodies see the global parameter scope.

Expression language: numeric literals (with engineering suffixes: ``10k``,
``3meg``, ``100n``...), parameter names (case-insensitive), ``+ - * / **``,
parentheses, and the functions sqrt/exp/log/log10/sin/cos/tan/abs/min/max.
Evaluation is a whitelisted AST walk — no eval(), no attribute access, no
arbitrary calls.
"""

from __future__ import annotations

import ast
import math
import re

from .numbers import parse_number_with_units

_PARAM_LINE_RE = re.compile(r"^\s*\.param\s+(.*)$", re.IGNORECASE)
# .func name(a, b) expr   |   .func name(a, b) = expr   (ngspice-style
# user function definitions, usable in any {expression})
_FUNC_LINE_RE = re.compile(
    r"^\s*\.func\s+([A-Za-z_]\w*)\s*\(([^)]*)\)\s*=?\s*(.+?)\s*$",
    re.IGNORECASE)
_FUNC_MARK = "__func__"
_MAX_FUNC_DEPTH = 20
_ASSIGN_RE = re.compile(r"([A-Za-z_]\w*)\s*=\s*(\{[^}]*\}|\S+)")
_BRACE_RE = re.compile(r"\{([^{}]*)\}")
# engineering-suffixed literal inside an expression: digits followed by
# letters (e.g. 10k, 3meg, 2.2u) — invalid Python syntax, so normalize
# first. The FIRST alternative greedily consumes plain scientific notation
# ("1e-3", "9.99e-06") so the suffix matcher cannot backtrack into
# treating the bare "e" as a unit and orphaning the "-06"; the replacer
# leaves those untouched (group 1 is None).
_ENG_NUM_RE = re.compile(
    r"(?<![\w.])(?:\d+(?:\.\d*)?[eE][+-]?\d+(?![\w.])"
    r"|(\d+(?:\.\d*)?(?:[eE][+-]?\d+)?[A-Za-z]+))")

_FUNCS = {
    "sqrt": math.sqrt, "exp": math.exp, "log": math.log,
    "log10": math.log10, "sin": math.sin, "cos": math.cos,
    "tan": math.tan, "abs": abs, "min": min, "max": max,
}
_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a ** b,
}
_UNARYOPS = {ast.USub: lambda a: -a, ast.UAdd: lambda a: a}


def eval_expr(expr: str, params: dict[str, float],
              _depth: int = 0) -> float:
    """Evaluate one parameter expression against the current scope.

    ``params`` may also carry ``.func`` definitions (stored as
    ("__func__", argnames, body) tuples under the function name) — a call
    binds its evaluated arguments into a child scope and evaluates the
    body, recursion capped at _MAX_FUNC_DEPTH."""
    if _depth > _MAX_FUNC_DEPTH:
        raise ValueError(
            f".func recursion deeper than {_MAX_FUNC_DEPTH} evaluating "
            f"{expr!r}")
    normalized = _ENG_NUM_RE.sub(
        lambda m: (m.group(0) if m.group(1) is None
                   else repr(parse_number_with_units(m.group(1)))), expr)
    try:
        tree = ast.parse(normalized, mode="eval").body
    except SyntaxError as err:
        raise ValueError(f"malformed parameter expression {expr!r}") from err

    def ev(node: ast.AST) -> float:
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (int, float)):
            return float(node.value)
        if isinstance(node, ast.Name):
            key = node.id.lower()
            val = params.get(key)
            if isinstance(val, (int, float)):
                return float(val)
            raise ValueError(
                f"unknown parameter {node.id!r} in expression {expr!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](ev(node.operand))
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and not node.keywords):
            fname = node.func.id.lower()
            udef = params.get(fname)
            if (isinstance(udef, tuple) and udef
                    and udef[0] == _FUNC_MARK):
                _, argnames, body = udef
                if len(node.args) != len(argnames):
                    raise ValueError(
                        f".func {fname} takes {len(argnames)} argument(s),"
                        f" got {len(node.args)} in {expr!r}")
                child = dict(params)
                for an, av in zip(argnames, node.args):
                    child[an] = ev(av)
                return eval_expr(body, child, _depth=_depth + 1)
            if fname in _FUNCS:
                return float(_FUNCS[fname](*[ev(a) for a in node.args]))
        raise ValueError(
            f"unsupported construct in parameter expression {expr!r}")

    return float(ev(tree))


def substitute_braces(line: str, params: dict[str, float],
                      strict: bool = True) -> str:
    """Replace every {expr} in one line. With strict=False, expressions
    referencing unknown parameters are left intact (deferred to a later
    scope — parameterized .subckt bodies are substituted at expansion
    time with their instance-local scope layered over the globals)."""
    if line.lstrip().startswith("*"):
        return line

    def repl(m: re.Match) -> str:
        try:
            return repr(eval_expr(m.group(1), params))
        except ValueError:
            if strict:
                raise
            return m.group(0)

    return _BRACE_RE.sub(repl, line)


def apply_params(text: str,
                 strict: bool = True) -> tuple[str, dict[str, float]]:
    """Collect .param definitions (in order) and substitute every {expr}.

    Returns (text, params). .param lines are stripped from the output;
    parsing stops honoring new definitions after .end like the main parser
    does. With strict=False, braces whose expressions reference unknown
    names survive for a later scoped pass (see substitute_braces).
    """
    params: dict[str, float] = {}
    out_lines: list[str] = []
    ended = False
    for raw in re.split(r"\r?\n", text):
        if not ended and re.match(r"^\s*\.end\b(?!s)", raw, re.IGNORECASE):
            ended = True
        fm = None if ended else _FUNC_LINE_RE.match(raw)
        if fm:
            name = fm.group(1).lower()
            argnames = [a.strip().lower() for a in fm.group(2).split(",")
                        if a.strip()]
            body = fm.group(3).strip()
            if body.startswith("{") and body.endswith("}"):
                body = body[1:-1]  # ngspice allows a braced body
            params[name] = (_FUNC_MARK, argnames, body)
            continue
        m = None if ended else _PARAM_LINE_RE.match(raw)
        if m:
            body = m.group(1)
            rest = _ASSIGN_RE.sub("", body).strip()
            if rest and not rest.startswith(("*", ";", "//")):
                raise ValueError(f"malformed .param directive: {raw!r}")
            for name, val in _ASSIGN_RE.findall(body):
                expr = val[1:-1] if val.startswith("{") else val
                params[name.lower()] = eval_expr(expr, params)
            continue
        out_lines.append(raw)

    return ("\n".join(substitute_braces(line, params, strict=strict)
                      for line in out_lines), params)
