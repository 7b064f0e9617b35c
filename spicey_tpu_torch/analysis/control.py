"""ngspice-style ``.control`` script execution (batch mode).

The parser folds analysis commands into the circuit's analysis fields
(``parsing/netlist.py:_absorb_control``); what remains in
``circuit.control`` is the post-processing tail — ``print`` / ``echo`` /
``write`` / ``wrdata`` / ``set`` — which this module executes against the
finished :class:`SimulationResult`. It is deliberately host-side
string/file work: by the time control runs, every vector is a small NumPy
array the engines already pulled back from the device, so there is
nothing here for the card to accelerate. A copy of
spicey_tpu/analysis/control.py.

The reference has no scripting surface at all (its public API is
``simulate() -> records``, spicey/lib/index.ts:1-12); this
exists for ngspice deck compatibility, the same motive as the extended
dialect. Semantics are the useful batch subset, not the full interactive
interpreter:

- ``echo [text]``       — append a line to the control output (quotes
  stripped, ngspice-style).
- ``set key[=value]``   — script settings. Consumed: ``filetype=ascii``
  (``write`` emits ASCII ``Values:`` blocks instead of the binary
  default). Everything else is carried but inert.
- ``let name = expr``   — named vector expressions over result vectors
  (``let gain = v(out)/v(in)``): whitelisted-AST arithmetic with NumPy
  broadcasting (same no-eval posture as ``.param``), engineering
  suffixes, and ngspice's vector functions (mag/ph/db/real/imag,
  mean/rms/vecmin/vecmax reductions). Lets shadow plot vectors in
  ``print``/``wrdata`` and compose with each other.
- ``print vec ...``     — tabulate vectors from the "current plot": the
  deck's last-run analysis (tran, else ac, else dc, else op —
  ngspice's plot stack ends on the last analysis executed). ``print
  all`` prints every node voltage. Vector specs: ``v(node)``,
  AC accessors ``vm/vdb/vp/vr/vi(node)``, ``i(elem)``, and ngspice's
  ``name#branch`` spelling for source branch currents.
- ``write file [vecs]`` — serialize to an ngspice rawfile via
  ``formatting/rawfile.py`` (all plots; a vector subset is accepted but
  the whole plot is written — rawfile viewers select client-side).
- ``wrdata file vecs``  — whitespace-separated ASCII columns, x-axis
  first, complex vectors as re/im pairs (ngspice wrdata layout).

Relative output paths resolve against ``base_dir`` (the deck's directory
when the CLI drives this) so decks behave the same from any cwd.
"""

from __future__ import annotations

import ast
import os
import re

import numpy as np

from .meas import _apply_acc

_VEC_RE = re.compile(r"^(v|vm|vdb|vp|vr|vi|i)\(([^)]+)\)$", re.IGNORECASE)

# vector references inside `let` expressions — substituted with placeholder
# names BEFORE ast.parse so node names that are not Python identifiers
# (`v(2)`, `v(n+)`, `i(v1)`, `vout#branch`) can never break the parse
_REF_RE = re.compile(r"(?:v|vm|vdb|vp|vr|vi|i)\([^()]*\)|[\w.]+#branch",
                     re.IGNORECASE)

# ngspice-style vector functions for `let` (element-wise unless noted;
# mean/rms/vecmin/vecmax reduce to a length-1 vector like ngspice's)
_LET_FUNCS = {
    "abs": np.abs, "mag": np.abs,
    "db": lambda x: 20.0 * np.log10(np.maximum(np.abs(x), 1e-300)),
    "ph": lambda x: np.degrees(np.angle(x)),
    "real": np.real, "imag": np.imag,
    "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log": np.log,
    "log10": np.log10, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "mean": lambda x: np.atleast_1d(np.mean(x)),
    "rms": lambda x: np.atleast_1d(np.sqrt(np.mean(np.abs(x) ** 2))),
    "vecmin": lambda x: np.atleast_1d(np.min(x.real)),
    "vecmax": lambda x: np.atleast_1d(np.max(x.real)),
}
_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.Pow: lambda a, b: a ** b,
}
_UNARYOPS = {ast.USub: lambda a: -a, ast.UAdd: lambda a: a}


def _let_eval(result, lets: dict, expr: str):
    """Evaluate a `let` right-hand side to (kind, vector).

    Vector refs are regex-substituted with placeholders, engineering
    suffixes normalized (same rule as parameter expressions,
    parsing/params.py), then a whitelisted-AST walk runs the arithmetic
    with NumPy broadcasting — no eval(), same posture as `.param`.
    ``kind`` is the plot of the first vector referenced (axis alignment
    for print/wrdata); a pure-scalar expression gets kind None."""
    binds: dict[str, np.ndarray] = {}
    kinds: list[str] = []

    def sub(m: re.Match) -> str:
        got = _resolve(result, m.group(0), lets)
        if got is None:
            raise ValueError(f"no such vector {m.group(0)}")
        key = f"__v{len(binds)}__"
        _, kind, vals = got
        binds[key] = vals
        if kind is not None:
            kinds.append(kind)
        return key

    from ..parsing.numbers import parse_number_with_units
    from ..parsing.params import _ENG_NUM_RE

    pyexpr = _REF_RE.sub(sub, expr)
    pyexpr = _ENG_NUM_RE.sub(
        lambda m: (m.group(0) if m.group(1) is None
                   else repr(parse_number_with_units(m.group(1)))), pyexpr)
    try:
        tree = ast.parse(pyexpr, mode="eval").body
    except SyntaxError as err:
        raise ValueError(f"malformed let expression {expr!r}") from err

    def ev(node: ast.AST):
        if isinstance(node, ast.Constant) and isinstance(
                node.value, (int, float)):
            return float(node.value)
        if isinstance(node, ast.Name):
            key = node.id.lower()
            if key in binds:
                return binds[key]
            if key in lets:
                kind, vals = lets[key]
                if kind is not None:
                    kinds.append(kind)
                return vals
            raise ValueError(f"no such vector {node.id} in {expr!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](ev(node.operand))
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and not node.keywords and len(node.args) == 1
                and node.func.id.lower() in _LET_FUNCS):
            return _LET_FUNCS[node.func.id.lower()](
                np.asarray(ev(node.args[0])))
        raise ValueError(f"unsupported construct in let expression {expr!r}")

    vals = np.atleast_1d(np.asarray(ev(tree)))
    return (kinds[0] if kinds else None), vals


def _current_plots(result) -> list[tuple[str, object]]:
    """Plots in lookup order: ngspice's current plot is the last analysis
    run, and the deck engines run tran last (analysis/simulate.py)."""
    plots = []
    for kind in ("tran", "ac", "dc", "op"):
        r = getattr(result, kind, None)
        if r is not None:
            plots.append((kind, r))
    return plots


def _axis(kind: str, plot) -> tuple[str, np.ndarray]:
    if kind == "tran":
        return "time", np.asarray(plot.times, np.float64)
    if kind == "ac":
        return "frequency", np.asarray(plot.freqs, np.float64)
    if kind == "dc":
        return "v-sweep", np.asarray(plot.sweep, np.float64)
    return "", np.zeros((1,), np.float64)  # op: single point


def _ci_get(d: dict, name: str):
    by_upper = {k.upper(): k for k in d}
    key = by_upper.get(name.upper())
    return None if key is None else d[key]


def _resolve(result, spec: str, lets: dict | None = None):
    """Vector spec -> (label, kind, values) or None. `let` definitions
    shadow everything (ngspice: lets live on the current plot); then the
    current plot, then the other plots (lenient — a deck that ran .ac
    and .tran can print both without setplot)."""
    if lets and spec.lower() in lets:
        kind, vals = lets[spec.lower()]
        return spec, kind, vals
    m = _VEC_RE.match(spec)
    branch = None
    if m is None and spec.lower().endswith("#branch"):
        branch = spec[:-len("#branch")]
    for kind, plot in _current_plots(result):
        if m is not None:
            acc, name = m.group(1).lower(), m.group(2)
            if acc == "i" or branch is not None:
                pass
            elif acc != "v" and kind != "ac":
                continue  # vm/vdb/vp/vr/vi are AC accessors
            vals = (_ci_get(plot.element_currents, name) if acc == "i"
                    else _ci_get(plot.node_voltages, name))
            if vals is None:
                continue
            arr = np.asarray(vals)
            if kind == "ac" and acc != "v" and acc != "i":
                arr = _apply_acc(arr, acc)
            return spec, kind, np.atleast_1d(arr)
        name = branch if branch is not None else spec
        vals = _ci_get(plot.element_currents, name)
        if vals is None and branch is None:
            vals = _ci_get(plot.node_voltages, name)
        if vals is not None:
            return spec, kind, np.atleast_1d(np.asarray(vals))
    return None


def _fmt(x) -> str:
    if np.iscomplexobj(x):
        return f"{x.real:.6e},{x.imag:.6e}"
    return f"{float(x):.6e}"


def _print_cmd(result, rest: str, lets: dict | None = None) -> list[str]:
    specs = rest.split()
    plots = _current_plots(result)
    if not plots and not lets:
        return ["print: no analysis results"]
    if specs and specs[0].lower() == "all" and plots:
        specs = [f"v({n})" for n in plots[0][1].node_voltages]
    cols, labels, kinds = [], [], []
    out: list[str] = []
    for spec in specs:
        got = _resolve(result, spec, lets)
        if got is None:
            out.append(f"print: no such vector {spec}")
            continue
        label, kind, vals = got
        labels.append(label)
        kinds.append(kind)
        cols.append(vals)
    if not cols:
        return out
    # group columns by the plot they came from so axes line up
    by_kind = dict(plots)
    for kind in dict.fromkeys(kinds):
        sel = [i for i, k in enumerate(kinds) if k == kind]
        plot = by_kind.get(kind)
        # Scalars (single-element vectors, e.g. mean/rms lets) print as
        # `name = value` lines; full-length vectors get tabulated. Deciding
        # table-vs-scalar mode from the FIRST column of the group silently
        # dropped sibling vectors when a scalar led (`print s v(2)`).
        scalars = [i for i in sel if len(cols[i]) == 1]
        vectors = [i for i in sel if len(cols[i]) > 1]
        out.extend(f"{labels[i]} = {_fmt(cols[i][0])}" for i in scalars)
        if not vectors:
            continue
        if kind in (None, "op") or plot is None:
            # no analysis axis to line up against (bare lets): index scale
            hdr = ["Index"] + [labels[i] for i in vectors]
            out.append("  ".join(f"{h:<15}" for h in hdr).rstrip())
            for j in range(max(len(cols[i]) for i in vectors)):
                row = [f"{j:<15d}"]
                row += [f"{_fmt(cols[i][j]) if j < len(cols[i]) else '':<15}"
                        for i in vectors]
                out.append("  ".join(row).rstrip())
            continue
        x_name, x = _axis(kind, plot)
        hdr = ["Index", x_name] + [labels[i] for i in vectors]
        out.append("  ".join(f"{h:<15}" for h in hdr).rstrip())
        for j in range(len(x)):
            row = [f"{j:<15d}", f"{x[j]:<15.6e}"]
            row += [f"{_fmt(cols[i][j]) if j < len(cols[i]) else '':<15}"
                    for i in vectors]
            out.append("  ".join(row).rstrip())
    return out


def _wrdata_cmd(result, rest: str, base_dir: str | None,
                lets: dict | None = None) -> str | None:
    toks = rest.split()
    if len(toks) < 2:
        return "wrdata: need a file and at least one vector"
    path = _respath(toks[0], base_dir)
    cols: list[np.ndarray] = []
    missing = []
    for spec in toks[1:]:
        got = _resolve(result, spec, lets)
        if got is None:
            missing.append(spec)
            continue
        _, kind, vals = got
        plot = dict(_current_plots(result)).get(kind)
        _, x = _axis(kind, plot) if plot is not None and kind != "op" \
            else ("", np.zeros(0))
        if len(x) != len(vals):
            x = np.arange(len(vals), dtype=np.float64)
        cols.append(x)
        if np.iscomplexobj(vals):
            cols.append(vals.real.astype(np.float64))
            cols.append(vals.imag.astype(np.float64))
        else:
            cols.append(np.asarray(vals, np.float64))
    if not cols:
        return f"wrdata: no such vector {' '.join(missing)}"
    notes = []
    n = max(len(c) for c in cols)
    if any(len(c) != n for c in cols):
        # vectors from different plots (e.g. tran vs ac) have different
        # lengths; ngspice pads rather than truncating — pad with the last
        # value and say so instead of silently dropping trailing rows
        notes.append("wrdata: vectors have differing lengths; shorter "
                     "columns padded with their last value")
        cols = [np.concatenate([c, np.full(n - len(c),
                                           c[-1] if len(c) else 0.0)])
                if len(c) < n else c for c in cols]
    try:
        with open(path, "w") as fh:
            for j in range(n):
                fh.write(" ".join(f"{c[j]: .12e}" for c in cols) + "\n")
    except OSError as err:
        # a bad output path must not discard the finished analyses
        # (ngspice reports and continues)
        notes.append(f"wrdata: {err}")
    if missing:
        notes.append(f"wrdata: no such vector {' '.join(missing)}")
    return "\n".join(notes) if notes else None


def _respath(path: str, base_dir: str | None) -> str:
    path = path.strip("\"'")
    if os.path.isabs(path):
        return path
    return os.path.join(base_dir or os.getcwd(), path)


def run_control(result, base_dir: str | None = None) -> str:
    """Execute the post-processing tail of a ``.control`` script against a
    finished SimulationResult; returns the accumulated output text
    (also surfaced as ``SimulationResult.control_output`` and printed by
    the CLI)."""
    circuit = result.circuit
    settings: dict[str, str] = {}
    lets: dict[str, tuple] = {}
    out: list[str] = []
    for line in circuit.control:
        head, _, rest = line.partition(" ")
        head = head.lower()
        rest = rest.strip()
        if head == "echo":
            out.append(rest.strip("\"'"))
        elif head == "set":
            for tok in rest.split():
                k, _, v = tok.partition("=")
                settings[k.lower()] = v.strip("\"'").lower()
        elif head == "let":
            name, eq, expr = rest.partition("=")
            name = name.strip().lower()
            if not eq or not name.isidentifier():
                out.append(f"let: expected `let name = expr`, got {line!r}")
                continue
            try:
                lets[name] = _let_eval(result, lets, expr.strip())
            except (ValueError, ZeroDivisionError, OverflowError) as err:
                # scalar constants evaluate as Python floats, so 1/0 and
                # huge ** raise; report into the output like ngspice's
                # shell, never crash the simulation
                out.append(f"let: {err}")
        elif head == "print":
            out.extend(_print_cmd(result, rest, lets))
        elif head == "write":
            toks = rest.split()
            if not toks:
                out.append("write: need a file name")
                continue
            from ..formatting.rawfile import write_rawfile

            try:
                write_rawfile(
                    result, _respath(toks[0], base_dir),
                    ascii_values=settings.get("filetype") == "ascii")
            except OSError as err:
                # an unwritable path must not crash simulate() after every
                # analysis already ran; report like ngspice and continue
                out.append(f"write: {err}")
        elif head == "wrdata":
            err = _wrdata_cmd(result, rest, base_dir, lets)
            if err:
                out.append(err)
    return "\n".join(out)
