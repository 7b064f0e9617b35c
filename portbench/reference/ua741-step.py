"""Plain reference of the ``ua741-step`` configuration: the DC operating
point of the uA741 Boyle macromodel wired as an inverting amplifier,
every variant of its stepped feedback resistor on its own, by Newton's
method on the modified nodal equations in PyTorch. Imports only PyTorch
and the standard library.

What a deck may hold here: R, C (open at DC), V and I (``dc`` value or a
bare value; AC and transient specifications are ignored), D with
``.model <name> D(Is= N= Rs=)``, Q with ``.model <name> NPN|PNP(Is= Bf=
Br=)``, E and G (linear, or POLY(n) over n node pairs), F and H (linear,
or POLY(n) over n controlling V sources), X instances of ``.subckt``
definitions (nested), ``.op``, ``.step param <element> <start> <stop>
<step>`` (read; the traffic sweeps instead), ``.end``. The first line is
the title; ``+`` continues a line, ``*`` starts a comment line and ``;``
an inline comment. Anything else raises.

Semantics (SPICE's conventions): unknowns are the node voltages, then one
internal node per diode with Rs > 0 (between the anode and the junction),
then one branch current per V, E and H, flowing from the + node through
the element to the - node; an I, F or G current flows from its + node
through the element to its - node. A subcircuit's internal nodes and
elements are named ``<name>.<instance>``; node 0 (and ``gnd``) is ground
everywhere. A POLY(n) source's value is p0 + sum_k p_k x_k (the first
order terms; more coefficients raise). A diode is Is (e^(v/(N VT)) - 1);
a BJT is the Ebers-Moll transport model, collector current
Is (e^(vbe/VT) - e^(vbc/VT)) - Is/Br (e^(vbc/VT) - 1), base current
Is/Bf (e^(vbe/VT) - 1) + Is/Br (e^(vbc/VT) - 1), signs flipped for PNP.

Newton starts from rest. Each pass linearizes every junction at its
voltage limited by SPICE3's pnjlim against the junction voltage of the
last pass (above the critical voltage, a step beyond 2 VT shrinks to a
logarithm of itself), with each companion conductance floored at GMIN.
A variant is done after a pass that limited no junction and moved no
unknown by more than ``TOL_ULPS`` units in the last place of the dtype
times (1 + |x|). A variant still open after ``MAX_PASSES``, or whose
solve failed, goes through the convergence aids, each stage seeded from
the one before: gmin stepping (a conductance from every node to ground,
1e-2 S down to 0), and where that fails, source stepping (every V and I
source's value from 10% to 100%, starting from rest). A variant that
none of them solves is reported not solved.

Where this departs from ngspice: no GMIN conductance is placed across
the junctions (the floor only keeps the Jacobian regular and leaves the
solution where it is); the BJT is the transport model without Early
voltage, high-injection roll-off or series resistances (ngspice's
Gummel-Poon with the model's defaults, less its GMIN); the thermal
voltage is fixed at 300 K's (the upstream physics.ts), not computed
from TNOM; the convergence test is on the unknowns alone (ngspice also
tests the device currents and uses RELTOL/VNTOL/ABSTOL); gmin stepping
runs a fixed ladder, not ngspice's adaptive one; POLY terms beyond the
first order are not read.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import torch

VT = 0.02585              # thermal voltage at 300 K (the upstream physics.ts)
GMIN = 1e-12              # companion conductance floor (S)
MAX_PASSES = 200
TOL_ULPS = 4096
GMIN_STEPS = (1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-8, 1e-10, 1e-12, 0.0)
SOURCE_STEPS = tuple((k + 1) / 10.0 for k in range(10))

_SUFFIX = (("meg", 1e6), ("mil", 25.4e-6), ("t", 1e12), ("g", 1e9),
           ("k", 1e3), ("m", 1e-3), ("u", 1e-6), ("n", 1e-9), ("p", 1e-12),
           ("f", 1e-15))
_NUM = re.compile(r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)([a-zA-Z]*)$")
_GROUND = ("0", "gnd")


def number(tok: str) -> float:
    m = _NUM.match(tok.strip())
    if not m:
        raise ValueError(f"not a number: {tok!r}")
    value, suffix = float(m.group(1)), m.group(2).lower()
    for name, mult in _SUFFIX:
        if suffix.startswith(name):
            return value * mult
    return value


@dataclass
class Element:
    name: str           # as written, prefixed with its instances' names
    kind: str           # R C V I D Q E F G H
    nodes: tuple        # its terminals (flattened node names)
    value: float = 0.0  # R, C, V, I: the value; linear E F G H: the gain
    model: dict = field(default_factory=dict)   # D, Q
    controls: tuple = ()  # E, G: node pairs; F, H: V source names
    coeffs: tuple = ()  # p0, p1, ... (a linear source: (0, gain))


@dataclass
class Deck:
    elements: list = field(default_factory=list)
    nodes: list = field(default_factory=list)    # deck nodes, first seen
    op: bool = False
    step: tuple | None = None

    def of(self, kind: str) -> list:
        return [e for e in self.elements if e.kind == kind]


def _lines(text: str) -> list[list[str]]:
    """The deck's logical lines as token lists, the title dropped."""
    out: list[str] = []
    for raw in text.strip("\n").splitlines()[1:]:
        line = raw.split(";")[0].strip()
        if not line or line.startswith("*"):
            continue
        if line.startswith("+"):
            if not out:
                raise ValueError("a continuation line with nothing before")
            out[-1] += " " + line[1:]
        else:
            out.append(line)
    return [re.sub(r"[(),=]", " ", line).split() for line in out]


def _model(toks: list[str]) -> tuple[str, dict]:
    kind = toks[2].upper()
    defaults = {"D": {"is": 1e-14, "n": 1.0, "rs": 0.0},
                "NPN": {"is": 1e-16, "bf": 100.0, "br": 1.0},
                "PNP": {"is": 1e-16, "bf": 100.0, "br": 1.0}}
    if kind not in defaults:
        raise ValueError(f"the reference does not read {kind} models")
    params = dict(defaults[kind], kind=kind)
    for key, val in zip(toks[3::2], toks[4::2]):
        if key.lower() not in params:
            raise ValueError(f"the reference does not read the {kind} "
                             f"parameter {key}")
        params[key.lower()] = number(val)
    return toks[1].upper(), params


def _controlled(kind: str, toks: list[str]) -> tuple[tuple, tuple]:
    """(controls, coefficients) of an E/F/G/H line after its two nodes."""
    per = 2 if kind in "EG" else 1
    if toks[0].lower() == "poly":
        n = int(toks[1])
        controls = toks[2:2 + per * n]
        coeffs = tuple(number(t) for t in toks[2 + per * n:])
        if len(coeffs) > n + 1:
            raise ValueError("the reference reads first-order POLY terms "
                             "only")
    else:
        n = 1
        controls = toks[:per]
        coeffs = (0.0, number(toks[per]))
    if per == 2:
        controls = tuple(zip(controls[0::2], controls[1::2]))
    return tuple(controls), coeffs


def read_deck(text: str) -> Deck:
    """The deck flattened: every X instance replaced by its subcircuit's
    elements, their internal nodes and names prefixed by the instance."""
    deck = Deck()
    models: dict[str, dict] = {}
    subckts: dict[str, tuple[list[str], list[list[str]]]] = {}
    top: list[list[str]] = []
    body = None
    for toks in _lines(text):
        head = toks[0].lower()
        if head == ".end":
            break
        if head == ".subckt":
            body = []
            subckts[toks[1].upper()] = (toks[2:], body)
        elif head == ".ends":
            body = None
        elif head == ".model":
            name, params = _model(toks)
            models[name] = params
        elif head == ".op":
            deck.op = True
        elif head == ".step" and len(toks) > 1 and toks[1].lower() == "param":
            deck.step = (toks[2], *(number(t) for t in toks[3:6]))
        elif head.startswith("."):
            raise ValueError(f"the reference does not read {toks[0]}")
        else:
            (top if body is None else body).append(toks)

    def expand(lines, node_of, prefix: str) -> None:
        def vname(name: str) -> str:
            return name + prefix
        for toks in lines:
            name, kind = toks[0], toks[0][0].upper()
            if kind == "X":
                ports, inner = subckts[toks[-1].upper()]
                outer = [node_of(n) for n in toks[1:-1]]
                if len(outer) != len(ports):
                    raise ValueError(f"{name}: {len(outer)} nodes for "
                                     f"{len(ports)} ports")
                bind = dict(zip(ports, outer))
                inst = "." + name + prefix

                def inner_node(n, bind=bind, inst=inst):
                    if n.lower() in _GROUND:
                        return "0"
                    return bind.get(n, n + inst)
                expand(inner, inner_node, inst)
                continue
            el_name = vname(name)
            if kind in "RC":
                el = Element(el_name, kind, (node_of(toks[1]),
                                             node_of(toks[2])),
                             value=number(toks[3]))
            elif kind in "VI":
                rest = toks[3:]
                value = 0.0
                if rest and rest[0].lower() == "dc":
                    value = number(rest[1])
                elif rest and _NUM.match(rest[0]):
                    value = number(rest[0])
                el = Element(el_name, kind, (node_of(toks[1]),
                                             node_of(toks[2])), value=value)
            elif kind == "D":
                el = Element(el_name, kind, (node_of(toks[1]),
                                             node_of(toks[2])),
                             model=models[toks[3].upper()])
                if el.model["kind"] != "D":
                    raise ValueError(f"{name}: not a diode model")
            elif kind == "Q":
                el = Element(el_name, kind, tuple(node_of(n)
                                                  for n in toks[1:4]),
                             model=models[toks[4].upper()])
                if el.model["kind"] not in ("NPN", "PNP"):
                    raise ValueError(f"{name}: not a BJT model")
            elif kind in "EFGH":
                controls, coeffs = _controlled(kind, toks[3:])
                if kind in "EG":
                    controls = tuple((node_of(a), node_of(b))
                                     for a, b in controls)
                else:
                    controls = tuple(vname(v) for v in controls)
                el = Element(el_name, kind, (node_of(toks[1]),
                                             node_of(toks[2])),
                             controls=controls, coeffs=coeffs)
            else:
                raise ValueError(f"the reference does not read {name}")
            for n in el.nodes:
                if n != "0" and n not in deck.nodes:
                    deck.nodes.append(n)
            deck.elements.append(el)

    expand(top, lambda n: "0" if n.lower() in _GROUND else n, "")
    return deck


def _unknowns(deck: Deck) -> tuple[dict, dict, dict, int]:
    """Rows: deck nodes, the diodes' internal nodes, the branch currents.
    Returns (node row, diode's internal row, branch row by name, n)."""
    row = {n: i for i, n in enumerate(deck.nodes)}
    n = len(row)
    inner = {}
    for d in deck.of("D"):
        if d.model["rs"] > 0:
            inner[d.name] = n
            n += 1
    branch = {}
    for el in deck.elements:
        if el.kind in "VEH":
            branch[el.name.upper()] = n
            n += 1
    return row, inner, branch, n


def facts(deck_text: str) -> dict:
    """The analysis, every R's nominal value, and the shapes the work
    formulas read (the unknowns), read from the deck here."""
    deck = read_deck(deck_text)
    if not deck.op:
        raise ValueError("the deck has no .op line")
    return {"analysis": "op",
            "nominal": {e.name: e.value for e in deck.of("R")},
            "shape": {"unknowns": _unknowns(deck)[3]}}


def _pnjlim(vnew: torch.Tensor, vold: torch.Tensor, vt: float,
            vcrit: float) -> tuple[torch.Tensor, torch.Tensor]:
    """SPICE3's junction limiter: (limited voltage, limited?)."""
    big = (vnew > vcrit) & ((vnew - vold).abs() > 2.0 * vt)
    arg = 1.0 + (vnew - vold) / vt
    up = torch.where(arg > 0, vold + vt * torch.log(arg.clamp_min(1e-30)),
                     torch.full_like(vnew, vcrit))
    down = vt * torch.log((vnew / vt).clamp_min(1e-30))
    return torch.where(big, torch.where(vold > 0, up, down), vnew), big


class _System:
    """The deck's equations for B variants: the linear part once, the
    junctions' companions each pass."""

    def __init__(self, deck: Deck, r_of: dict, B: int, dtype, device):
        self.row, self.inner, self.branch, self.n = _unknowns(deck)
        self.B, self.dtype, self.device = B, dtype, device
        n = self.n
        G = torch.zeros((B, n, n), dtype=torch.float64)
        s = torch.zeros((B, n), dtype=torch.float64)   # source values
        f = torch.zeros((B, n), dtype=torch.float64)   # fixed values

        def r(node):
            return self.row.get(node)

        def admit(a, b, y):
            i, j = r(a), r(b)
            for p, q, sg in ((i, i, 1), (j, j, 1), (i, j, -1), (j, i, -1)):
                if p is not None and q is not None:
                    G[:, p, q] += sg * y

        def through(a, b, col, gain):
            """A current gain * x[col] from a through the element to b."""
            for node, sg in ((a, 1.0), (b, -1.0)):
                if r(node) is not None:
                    G[:, r(node), col] += sg * gain

        def across(k, a, b, sg=1.0):
            """Branch row k reads v(a) - v(b) (times sg)."""
            for node, s_ in ((a, 1.0), (b, -1.0)):
                if r(node) is not None:
                    G[:, k, r(node)] += sg * s_

        for el in deck.elements:
            a, b = el.nodes[0], el.nodes[1]
            if el.kind == "R":
                value = r_of.get(el.name.upper())
                value = (torch.full((B,), el.value, dtype=torch.float64)
                         if value is None else value)
                admit(a, b, 1.0 / value)
            elif el.kind == "D" and el.name in self.inner:
                g = 1.0 / el.model["rs"]
                i, k = r(a), self.inner[el.name]
                G[:, k, k] += g
                if i is not None:
                    G[:, i, i] += g
                    G[:, i, k] -= g
                    G[:, k, i] -= g
            elif el.kind == "I":
                for node, sg in ((a, -1.0), (b, 1.0)):
                    if r(node) is not None:
                        s[:, r(node)] += sg * el.value
            elif el.kind in "VEH":
                k = self.branch[el.name.upper()]
                through(a, b, k, 1.0)
                across(k, a, b)
                if el.kind == "V":
                    s[:, k] = el.value
                elif el.kind == "E":
                    f[:, k] = el.coeffs[0]
                    for (ca, cb), p in zip(el.controls, el.coeffs[1:]):
                        across(k, ca, cb, -p)
                else:
                    f[:, k] = el.coeffs[0]
                    for v, p in zip(el.controls, el.coeffs[1:]):
                        G[:, k, self.branch[v.upper()]] -= p
            elif el.kind == "G":
                for node, sg in ((a, -1.0), (b, 1.0)):
                    if r(node) is not None:
                        f[:, r(node)] += sg * el.coeffs[0]
                for (ca, cb), p in zip(el.controls, el.coeffs[1:]):
                    for cn, cs in ((ca, 1.0), (cb, -1.0)):
                        if r(cn) is not None:
                            through(a, b, r(cn), p * cs)
            elif el.kind == "F":
                for node, sg in ((a, -1.0), (b, 1.0)):
                    if r(node) is not None:
                        f[:, r(node)] += sg * el.coeffs[0]
                for v, p in zip(el.controls, el.coeffs[1:]):
                    through(a, b, self.branch[v.upper()], p)
        to = dict(dtype=dtype, device=device)
        self.G, self.s, self.f = G.to(**to), s.to(**to), f.to(**to)
        self.shunt = torch.zeros(n, **to)
        self.shunt[:len(self.row) + len(self.inner)] = 1.0
        # the junctions: (anode-side row, cathode row, model) for diodes;
        # (c, b, e rows, model) for BJTs; None is ground
        self.diodes = [(self.inner.get(d.name, r(d.nodes[0])),
                        r(d.nodes[1]), d.model) for d in deck.of("D")]
        self.bjts = [tuple(r(nd) for nd in q.nodes) + (q.model,)
                     for q in deck.of("Q")]

    def _at(self, x: torch.Tensor, i) -> torch.Tensor:
        return x[:, i] if i is not None else torch.zeros_like(x[:, 0])

    def junctions(self, x: torch.Tensor) -> torch.Tensor:
        """Every junction's voltage, (B, nD + 2 nQ), in its own frame."""
        cols = [self._at(x, a) - self._at(x, c) for a, c, _m in self.diodes]
        for c, b, e, m in self.bjts:
            sg = 1.0 if m["kind"] == "NPN" else -1.0
            cols += [sg * (self._at(x, b) - self._at(x, e)),
                     sg * (self._at(x, b) - self._at(x, c))]
        return torch.stack(cols, dim=1)

    def vcrit(self) -> list[tuple[float, float]]:
        out = []
        for _a, _c, m in self.diodes:
            nvt = m["n"] * VT
            out.append((nvt, nvt * math.log(nvt / (math.sqrt(2) * m["is"]))))
        for *_t, m in self.bjts:
            vc = VT * math.log(VT / (math.sqrt(2) * m["is"]))
            out += [(VT, vc), (VT, vc)]
        return out

    def assemble(self, vj: torch.Tensor, scale: float, gshunt: float | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """A and b with every junction linearized at ``vj``; the
        independent sources times ``scale``; ``gshunt`` from every node to
        ground."""
        A = self.G.clone()
        b = self.s * scale + self.f
        if gshunt is not None:
            A = A + torch.diag_embed(self.shunt * gshunt)

        def put(rows, cols, vals):
            for i, ri in enumerate(rows):
                if ri is None:
                    continue
                for j, cj in enumerate(cols):
                    if cj is not None:
                        A[:, ri, cj] += vals[i][j]

        def inject(rows, cur):
            for ri, ci in zip(rows, cur):
                if ri is not None:
                    b[:, ri] -= ci

        k = 0
        for a, c, m in self.diodes:
            nvt = m["n"] * VT
            e = torch.exp(vj[:, k] / nvt)
            g = (m["is"] / nvt * e).clamp_min(GMIN)
            i0 = m["is"] * (e - 1.0) - g * vj[:, k]
            put((a, c), (a, c), ((g, -g), (-g, g)))
            inject((a, c), (i0, -i0))
            k += 1
        for c, bb, e_, m in self.bjts:
            sg = 1.0 if m["kind"] == "NPN" else -1.0
            vbe, vbc = vj[:, k], vj[:, k + 1]
            k += 2
            ebe, ebc = torch.exp(vbe / VT), torch.exp(vbc / VT)
            i_s, bf, br = m["is"], m["bf"], m["br"]
            ic = i_s * (ebe - ebc) - i_s / br * (ebc - 1.0)
            ib = i_s / bf * (ebe - 1.0) + i_s / br * (ebc - 1.0)
            # d(ic, ib)/d(vbe, vbc), each floored at GMIN in magnitude
            gf = (i_s / VT * ebe).clamp_min(GMIN)
            gr = (i_s / VT * ebc).clamp_min(GMIN)
            gpi = (i_s / bf / VT * ebe).clamp_min(GMIN)
            gmu = (i_s / br / VT * ebc).clamp_min(GMIN)
            dic = (gf, -gr - gmu)
            dib = (gpi, gmu)
            # d(node current)/d(node voltage): vbe = sg (vb - ve), vbc =
            # sg (vb - vc) and the node currents are sg times the frame's,
            # so the two signs cancel
            cols = (c, bb, e_)
            dv = {"c": (0.0, -1.0), "b": (1.0, 1.0), "e": (-1.0, 0.0)}

            def row(d):
                return tuple(d[0] * dv[t][0] + d[1] * dv[t][1]
                             for t in ("c", "b", "e"))
            rc, rb = row(dic), row(dib)
            re_ = tuple(-(p + q) for p, q in zip(rc, rb))
            put(cols, cols, (rc, rb, re_))
            # the currents' constant parts, into each terminal, in the
            # node frame (sg flips a PNP's)
            c0 = sg * (ic - dic[0] * vbe - dic[1] * vbc)
            b0 = sg * (ib - dib[0] * vbe - dib[1] * vbc)
            inject(cols, (c0, b0, -(c0 + b0)))
        return A, b


def _newton(sys_: _System, x0: torch.Tensor, scale: float,
            gshunt: float | None) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Newton from ``x0`` for every variant: (x, solved, passes)."""
    x = x0.clone()
    vj = sys_.junctions(x)
    lims = sys_.vcrit()
    tol = TOL_ULPS * torch.finfo(x.dtype).eps
    B = x.shape[0]
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    failed = torch.zeros_like(done)
    passes = torch.zeros(B, dtype=torch.int64, device=x.device)
    for _ in range(MAX_PASSES):
        A, rhs = sys_.assemble(vj, scale, gshunt)
        sol, info = torch.linalg.solve_ex(A, rhs[..., None])
        x_new = sol[..., 0]
        bad = (info != 0) | ~torch.isfinite(x_new).all(dim=1)
        raw = sys_.junctions(x_new)
        limited = torch.zeros_like(done)
        cols = []
        for k, (vt, vc) in enumerate(lims):
            v, hit = _pnjlim(raw[:, k], vj[:, k], vt, vc)
            cols.append(v)
            limited |= hit
        vj_new = torch.stack(cols, dim=1)
        settled = ~limited & ((x_new - x).abs()
                              <= tol * (1.0 + x_new.abs())).all(dim=1)
        open_ = ~done & ~failed
        passes += open_.long()
        keep = (~open_ | bad)[:, None]
        x = torch.where(keep, x, x_new)
        vj = torch.where(keep, vj, vj_new)
        failed |= open_ & bad
        done |= open_ & ~bad & settled
        if bool((done | failed).all()):
            break
    return x, done & torch.isfinite(x).all(dim=1), passes


def operating_points(deck_text: str, overrides: dict, dtype: torch.dtype,
                     device: torch.device
                     ) -> tuple[torch.Tensor, list[str], torch.Tensor, dict]:
    """Every variant's deck node voltages (B, nodes) at ``dtype``, the
    nodes' names, the variants solved (B,), and what it took: the Newton
    passes a variant needed (``passes_per_lane``, the mean, the aids'
    passes included) and the variants the aids took (``aided``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    deck = read_deck(deck_text)
    upper = {k.upper(): v for k, v in overrides.items()}
    names = {e.name.upper() for e in deck.of("R")}
    unknown = sorted(set(upper) - names)
    if unknown:
        raise ValueError(f"the deck has no R named {unknown}")
    B = len(next(iter(overrides.values())))
    r_of = {k: torch.as_tensor(v, dtype=torch.float64).reshape(B)
            for k, v in upper.items()}
    full = _System(deck, r_of, B, dtype, device)
    x, ok, passes = _newton(full, torch.zeros((B, full.n), dtype=dtype,
                                              device=device), 1.0, None)
    aided = int((~ok).sum())
    if aided:
        idx = torch.nonzero(~ok).flatten()
        sub_r = {k: v[idx.cpu()] for k, v in r_of.items()}
        sub = _System(deck, sub_r, len(idx), dtype, device)
        zero = torch.zeros((len(idx), full.n), dtype=dtype, device=device)
        got, sol, used = _ladder(sub, zero)
        x[idx] = torch.where(sol[:, None], got, x[idx])
        ok[idx] = sol
        passes[idx] += used
    nodes = len(deck.nodes)
    return (x[:, :nodes], list(deck.nodes), ok,
            {"passes_per_lane": float(passes.double().mean()),
             "aided": aided})


def _ladder(sys_: _System, zero: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gmin stepping, then source stepping for the variants it leaves:
    (x, solved, passes) of each variant of ``sys_``."""
    B = zero.shape[0]
    passes = torch.zeros(B, dtype=torch.int64, device=zero.device)
    x, alive = zero.clone(), torch.ones(B, dtype=torch.bool,
                                        device=zero.device)
    for g in GMIN_STEPS:
        got, sol, used = _newton(sys_, x, 1.0, g)
        passes += torch.where(alive, used, 0)
        alive &= sol
        x = torch.where(alive[:, None], got, x)
    solved = alive.clone()
    x_s, alive = zero.clone(), ~solved
    for scale in SOURCE_STEPS:
        got, sol, used = _newton(sys_, x_s, scale, None)
        passes += torch.where(alive, used, 0)
        alive &= sol
        x_s = torch.where(alive[:, None], got, x_s)
    x = torch.where(solved[:, None], x, x_s)
    return x, solved | alive, passes
