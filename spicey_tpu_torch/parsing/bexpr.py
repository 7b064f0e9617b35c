"""Behavioral-source expression compiler (B elements, extended dialect).

Compiles ngspice-style behavioral expressions — arithmetic over ``v(a)`` /
``v(a,b)`` node voltages, ``i(vname)`` branch currents, and ``time`` — into
NumPy or torch callables:

    refs, fn = compile_bexpr("5*tanh(2*v(in)) + 1m*i(vs)*time")
    # refs: [("v", "in", None), ("i", "vs", None)]
    # fn(vals, t) -> value, with vals[..., j] the j-th reference's value

The reference set is discovered at compile time, so the engines gather
``vals[..., j] = x_pad[a_j] - x_pad[b_j]`` with system-appropriate index
remapping and compute the Newton linearization as per-reference partial
derivatives (``bexpr_partials``: forward-mode AD against one unit tangent
per reference, where the JAX package uses ``jax.jvp``) — each partial
stamps as a VCCS row, the zeroth-order term as a current injection. No
new stamp machinery is needed.

Two function tables: NumPy (``backend="np"``, the parser's closure, which
the host epilogues evaluate over a whole trajectory) and torch
(``backend="torch"``, what the engines evaluate on the device). A torch
function given a Python number (a literal argument, as in
``max(v(a), 0)``, or ``time`` passed as a float) gets it as a 0-d tensor
of the references' dtype and device, made by a fill on that device.
``exp`` is plain ``torch.exp`` in float64 (the JAX package's
``accurate_exp`` is TPU machinery, not carried).

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
import torch

from .numbers import parse_number_with_units
from .params import _ENG_NUM_RE

_FUNCS_NP = {
    "sqrt": _np.sqrt, "exp": _np.exp, "log": _np.log, "log10": _np.log10,
    "sin": _np.sin, "cos": _np.cos, "tan": _np.tan, "tanh": _np.tanh,
    "sinh": _np.sinh, "cosh": _np.cosh, "atan": _np.arctan,
    "abs": _np.abs, "min": _np.minimum, "max": _np.maximum,
}
def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is +1, as ``jnp.abs``'s JVP gives it
    (``torch.abs``'s is sgn(0) = 0; a B source's Newton partial at a kink
    then differs from the JAX package's)."""
    return torch.where(x >= 0, x, -x)


_FUNCS_TORCH = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "tanh": torch.tanh, "sinh": torch.sinh,
    "cosh": torch.cosh, "atan": torch.atan, "abs": _abs,
    "min": torch.minimum, "max": torch.maximum,
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


def _torch_args(args: list, vals: torch.Tensor) -> list:
    """Python numbers among a torch function's arguments as 0-d tensors
    of ``vals``' dtype on its device (``torch.minimum(t, 0.0)`` refuses
    a float)."""
    return [a if isinstance(a, torch.Tensor)
            else torch.full((), a, dtype=vals.dtype, device=vals.device)
            for a in args]


def compile_bexpr(expr: str, backend: str = "np",
                  ) -> tuple[list[tuple], Callable]:
    """Compile one behavioral expression.

    Returns (refs, fn): ``refs`` is the ordered list of distinct
    ("v"|"i", name, name2|None) references; ``fn(vals, t)`` evaluates the
    expression with ``vals[..., j]`` as reference j's value and ``t`` the
    absolute time (broadcast against vals' batch dims). ``backend="np"``
    builds the closure over NumPy ufuncs, ``"torch"`` over torch
    functions (``vals`` a tensor; a subexpression of literals alone stays
    a Python float, as in the JAX package).
    """
    if backend not in ("np", "torch"):
        raise ValueError("backend must be 'np' or 'torch'")
    use_torch = backend == "torch"
    funcs = _FUNCS_TORCH if use_torch else _FUNCS_NP
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
                if use_torch:
                    return lambda vals, t: fn(*_torch_args(
                        [a(vals, t) for a in args], vals))
                return lambda vals, t: fn(*[a(vals, t) for a in args])
        raise ValueError(
            f"unsupported construct in behavioral expression {expr!r}")

    body = build(tree)
    return refs, body


def bexpr_partials(fn: Callable, vals: torch.Tensor, t: object
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The value and the per-reference partials of a torch-compiled
    expression at ``vals`` (..., nRef): (f0 (...), [df/dvals_j (...) for
    each reference j]). One forward-mode pass per reference with the unit
    tangent e_j, as the JAX package's ``jax.jvp`` against unit tangents
    (spicey_tpu/analysis/tran.py:_stamp_bsources); a reference the value
    does not depend on has a zero partial, and a value that depends on no
    reference (a constant, or ``time`` alone) is broadcast to the batch."""
    import torch.autograd.forward_ad as fwad

    lead = vals.shape[:-1]

    def batch(v: object) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.expand(lead) if v.shape != lead else v
        return torch.full(lead, v, dtype=vals.dtype, device=vals.device)

    n_ref = vals.shape[-1]
    if n_ref == 0:
        return batch(fn(vals, t)), []
    if fwad._current_level >= 0:
        # inside an outer forward-mode level (the sensitivity analyses,
        # fit_tran) torch nests none: the partials come by reverse mode,
        # whose graph carries the outer tangent into them (forward over
        # reverse), as the JAX package's jvp inside jacfwd does; the
        # graph is cut at both ends, so no step's graph outlives its pass
        def cut(x: object) -> object:
            if not isinstance(x, torch.Tensor):
                return x
            primal, tangent = fwad.unpack_dual(x)
            return (primal.detach() if tangent is None
                    else fwad.make_dual(primal.detach(), tangent.detach()))

        with torch.enable_grad():
            v = cut(vals).requires_grad_()
            out = fn(v, t)
            if not (isinstance(out, torch.Tensor) and out.requires_grad):
                zero = torch.zeros(lead, dtype=vals.dtype, device=vals.device)
                return batch(cut(out)), [zero] * n_ref
            (g,) = torch.autograd.grad(batch(out).sum(), v, create_graph=True)
        return batch(cut(out)), [cut(g[..., j]) for j in range(n_ref)]
    eye = torch.eye(n_ref, dtype=vals.dtype, device=vals.device)
    f0, gs = None, []
    with fwad.dual_level():
        for j in range(n_ref):
            out = fn(fwad.make_dual(vals, eye[j].expand(vals.shape)), t)
            primal, tangent = (fwad.unpack_dual(out)
                               if isinstance(out, torch.Tensor)
                               else (out, None))
            if f0 is None:
                f0 = batch(primal).clone()
            gs.append(torch.zeros(lead, dtype=vals.dtype, device=vals.device)
                      if tangent is None else batch(tangent).clone())
    return f0, gs
