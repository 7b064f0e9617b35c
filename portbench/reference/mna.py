"""The plain reference: a SPICE deck read, stamped and solved in PyTorch.

It follows the semantics of the upstream engine's transient
(tscircuit/spicey: ``simulateTRAN.ts``) and imports nothing of the
program under test: its own netlist reader, its own modified nodal
analysis, its own Newton loop. It is written for clarity, not speed: one
dense system per variant, solved by ``torch.linalg.solve_ex`` in float64
or float32, or by the plain Gaussian elimination below in a precision
that library lacks (bfloat16, the control's).

What a deck may hold here: R, C, L, V (``dc`` or a bare value, ``PULSE(v1
v2 td tr tf ton period [ncycles])``), D and S elements, ``.model <name>
D|SW(params)`` (a diode by ``Is`` and ``N``, a switch by ``Ron``,
``Roff``, ``Von``, ``Voff``), ``.tran dt tstop [uic]``, ``.print`` (no
semantics) and ``.end``. The first line is the title. Anything else
raises.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np
import torch

EPS = 1e-15            # simulateTRAN.ts / Complex.ts singularity floor
VT = 0.02585           # thermal voltage at 300 K, physics.ts
GMIN = 1e-12           # diode conductance floor, simulateTRAN.ts:95
VD_MIN, VD_MAX = -1.0, 0.8   # diode voltage limits, simulateTRAN.ts:89-91
MAX_PASSES = 20        # Newton passes per time step, simulateTRAN.ts:151

_SUFFIX = (("meg", 1e6), ("t", 1e12), ("g", 1e9), ("k", 1e3), ("m", 1e-3),
           ("u", 1e-6), ("n", 1e-9), ("p", 1e-12), ("f", 1e-15))
_NUM = re.compile(r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)([a-zA-Z]*)$")


def number(tok: str) -> float:
    """A SPICE number: ``10U``, ``1K``, ``0.00068``, ``2meg``."""
    m = _NUM.match(tok.strip())
    if not m:
        raise ValueError(f"not a number: {tok!r}")
    value, suffix = float(m.group(1)), m.group(2).lower()
    for name, mult in _SUFFIX:
        if suffix.startswith(name):
            return value * mult
    return value


@dataclass
class Pulse:
    v1: float
    v2: float
    td: float
    tr: float
    tf: float
    ton: float
    period: float
    ncycles: float = math.inf

    def at(self, t: float) -> float:
        """pulseValue.ts: delay, fold by the period, rise, hold, fall."""
        if t < self.td:
            return self.v1
        tt = t - self.td
        k = math.floor(tt / self.period)
        if k >= self.ncycles:
            return self.v1
        tc = tt - k * self.period
        if tc < self.tr:
            return self.v1 + (self.v2 - self.v1) * (tc / max(self.tr, EPS))
        if tc < self.tr + self.ton:
            return self.v2
        if tc < self.tr + self.ton + self.tf:
            a = (tc - self.tr - self.ton) / max(self.tf, EPS)
            return self.v2 + (self.v1 - self.v2) * a
        return self.v1


@dataclass
class Element:
    name: str
    kind: str                 # R C L V D S
    nodes: tuple[str, ...]
    value: float = 0.0        # R, C, L; a V source's DC value
    pulse: Pulse | None = None
    model: dict = field(default_factory=dict)


@dataclass
class Deck:
    elements: list[Element]
    nodes: list[str]          # every node but ground, in order of appearance
    tran: tuple[float, float] | None = None   # (dt, tstop)

    def of(self, kind: str) -> list[Element]:
        return [e for e in self.elements if e.kind == kind]

    @property
    def unknowns(self) -> list[str]:
        """Node voltages, then one branch current per V source, named as
        ``V(node)`` and ``I(source)``."""
        return ([f"V({n})" for n in self.nodes]
                + [f"I({e.name})" for e in self.of("V")])


_MODEL_DEFAULTS = {"D": {"is": 1e-14, "n": 1.0},
                   "SW": {"ron": 1.0, "roff": 1e12, "von": 0.0, "voff": 0.0}}


def read_deck(text: str) -> Deck:
    """Parse the deck's text (the first line is its title)."""
    lines = text.strip("\n").splitlines()[1:]
    models: dict[str, dict] = {}
    raw: list[list[str]] = []
    tran = None
    for line in lines:
        line = line.split(";")[0].strip()
        if not line or line.startswith("*"):
            continue
        flat = re.sub(r"[()]", " ", line).split()
        head = flat[0].lower()
        if head == ".end":
            break
        if head == ".model":
            kind = flat[2].upper()
            params = dict(_MODEL_DEFAULTS[kind])
            for tok in re.findall(r"(\w+)\s*=\s*([^\s,]+)", " ".join(flat)):
                if tok[0].lower() not in params:
                    raise ValueError(f"the reference does not read the "
                                     f"{kind} parameter {tok[0]}")
                params[tok[0].lower()] = number(tok[1])
            models[flat[1].upper()] = params
        elif head == ".tran":
            tran = (number(flat[1]), number(flat[2]))
        elif head == ".print":
            continue               # which outputs to print: no semantics
        elif head.startswith("."):
            raise ValueError(f"the reference does not read {flat[0]}")
        else:
            raw.append(flat)
    elements, nodes = [], []

    def node(n: str) -> str:
        if n != "0" and n.lower() != "gnd" and n not in nodes:
            nodes.append(n)
        return n

    for flat in raw:
        name, kind = flat[0], flat[0][0].upper()
        if kind in "RCL":
            elements.append(Element(name, kind, (node(flat[1]), node(flat[2])),
                                    value=number(flat[3])))
        elif kind == "V":
            el = Element(name, kind, (node(flat[1]), node(flat[2])))
            toks = [t.lower() for t in flat[3:]]
            i = 0
            while i < len(toks):
                if toks[i] == "dc":
                    el.value = number(toks[i + 1])
                    i += 2
                elif toks[i] == "pulse":
                    args = []
                    while (len(args) < 8 and i + 1 + len(args) < len(toks)
                           and _NUM.match(toks[i + 1 + len(args)])):
                        args.append(number(toks[i + 1 + len(args)]))
                    el.pulse = Pulse(*args)
                    i += 1 + len(args)
                else:
                    el.value = number(toks[i])
                    i += 1
            elements.append(el)
        elif kind == "D":
            elements.append(Element(name, kind, (node(flat[1]), node(flat[2])),
                                    model=models[flat[3].upper()]))
        elif kind == "S":
            elements.append(Element(
                name, kind, tuple(node(n) for n in flat[1:5]),
                model=models[flat[5].upper()]))
        else:
            raise ValueError(f"the reference does not read {name}")
    return Deck(elements, nodes, tran)


def time_grid(deck: Deck) -> tuple[float, np.ndarray]:
    """computeEffectiveTimeStep (simulateTRAN.ts:14-19): steps =
    ceil(tstop / dt), dt snapped to tstop / steps, points 0..steps."""
    dt, tstop = deck.tran
    dt = dt if dt > EPS else tstop / 1000.0
    steps = max(1, math.ceil(tstop / max(dt, EPS)))
    dt = tstop / steps
    return dt, np.arange(steps + 1, dtype=np.float64) * dt


class Stamper:
    """Index helpers of one deck: where each element's terminals and each
    V source's branch row sit in the system."""

    def __init__(self, deck: Deck):
        self.deck = deck
        self.row = {n: i for i, n in enumerate(deck.nodes)}
        self.n = len(deck.nodes) + len(deck.of("V"))

    def idx(self, node: str) -> int | None:
        return self.row.get(node)

    def admittance(self, A: torch.Tensor, a: str, b: str,
                   y: torch.Tensor) -> None:
        """stampAdmittanceReal: y on both diagonals, -y off them; ``y``
        (..., ) broadcast over A's leading axes."""
        i, j = self.idx(a), self.idx(b)
        if i is not None:
            A[..., i, i] += y
        if j is not None:
            A[..., j, j] += y
        if i is not None and j is not None:
            A[..., i, j] -= y
            A[..., j, i] -= y

    def current(self, rhs: torch.Tensor, a: str, b: str,
                i_val: torch.Tensor) -> None:
        """stampCurrentReal: b[a] -= I, b[b] += I."""
        i, j = self.idx(a), self.idx(b)
        if i is not None:
            rhs[..., i] -= i_val
        if j is not None:
            rhs[..., j] += i_val

    def vsource(self, A: torch.Tensor, k: int, el: Element) -> int:
        """stampVoltageSourceReal's matrix part; returns the branch row."""
        j = len(self.deck.nodes) + k
        i1, i2 = self.idx(el.nodes[0]), self.idx(el.nodes[1])
        if i1 is not None:
            A[..., i1, j] += 1.0
            A[..., j, i1] += 1.0
        if i2 is not None:
            A[..., i2, j] -= 1.0
            A[..., j, i2] -= 1.0
        return j


def gauss_solve(A: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian elimination with partial pivoting, every step in A's own
    dtype (solveReal.ts): the control's solver, for precisions that
    ``torch.linalg.solve_ex`` lacks. A (..., n, n), b (..., n) ->
    (x, ok), ok false where a pivot fell under EPS."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1).clone()
    ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    ar = torch.arange(n, device=A.device)
    for c in range(n):
        col = M[..., c:, c].abs().float()
        p = col.argmax(dim=-1) + c                       # (...,)
        rows = ar.expand(M.shape[:-2] + (n,)).clone()
        rows[..., c] = p
        rows.scatter_(-1, p[..., None], torch.full_like(p[..., None], c))
        M = M.gather(-2, rows[..., None].expand(M.shape))
        piv = M[..., c, c]
        ok = ok & (piv.abs().float() >= EPS)
        f = M[..., :, c] / torch.where(piv == 0, torch.ones_like(piv), piv)[..., None]
        f[..., c] = 0.0
        M = M - f[..., None] * M[..., c, None, :]
    diag = M[..., ar, ar]
    x = M[..., n] / torch.where(diag == 0, torch.ones_like(diag), diag)
    return x, ok


def solve(A: torch.Tensor, b: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, ok) of A x = b, batched: LU with partial pivoting from the
    linear-algebra library where it has the dtype, else ``gauss_solve``."""
    if A.dtype in (torch.float64, torch.float32):
        x, info = torch.linalg.solve_ex(A, b[..., None])
        x = x[..., 0]
        return x, (info == 0) & torch.isfinite(x.abs()).all(dim=-1)
    return gauss_solve(A, b)


def sweep_values(deck: Deck, overrides: dict[str, torch.Tensor], kind: str,
                 B: int, dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    """(B, n_kind) element values: the deck's, each overridden element's
    (B,) draws in its place."""
    els = deck.of(kind)
    out = torch.empty((B, len(els)), dtype=torch.float64, device=device)
    upper = {k.upper(): v for k, v in overrides.items()}
    for i, el in enumerate(els):
        v = upper.get(el.name.upper())
        out[:, i] = (el.value if v is None
                     else torch.as_tensor(v, dtype=torch.float64,
                                          device=device))
    return out.to(dtype)


def check_overrides(deck: Deck, overrides: dict) -> None:
    names = {e.name.upper() for e in deck.elements if e.kind in "RCL"}
    unknown = sorted(set(k.upper() for k in overrides) - names)
    if unknown:
        raise ValueError(f"the deck has no R, C or L named {unknown}")


def tran_response(deck: Deck, overrides: dict, probe: str,
                  dtype: torch.dtype, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every variant's backward-Euler transient (simulateTRAN.ts), V(probe)
    at every time point.

    Per step the system starts from zero and is rebuilt and solved up to
    20 times; a variant's step ends at the first pass after which no
    switch toggled (its later passes leave it as it is). C is C/dt with
    -C/dt v_prev injected, L dt/L with i_prev; a switch is Ron or Roff by
    its state, which turns on above Von and off below Voff after each
    solve; a diode is its Shockley companion at vd clamped to
    [-1, 0.8], vd the previous step's on the first pass and the current
    iterate's after, g = max(Is/(N VT) e^(vd/(N VT)), GMIN). Returns
    (v (B, S+1), ok (B,), passes (B,) Newton passes each variant
    needed)."""
    check_overrides(deck, overrides)
    B = len(next(iter(overrides.values())))
    st = Stamper(deck)
    n = st.n
    dt, times = time_grid(deck)
    vals = {k: sweep_values(deck, overrides, k, B, dtype, device)
            for k in "RCL"}
    caps, inds = deck.of("C"), deck.of("L")
    diodes, switches, vsrcs = deck.of("D"), deck.of("S"), deck.of("V")
    probe_row = st.idx(probe)

    def drop(x: torch.Tensor, a: str, b: str) -> torch.Tensor:
        i, j = st.idx(a), st.idx(b)
        zero = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return ((x[..., i] if i is not None else zero)
                - (x[..., j] if j is not None else zero))

    src = torch.tensor([[el.pulse.at(float(t)) if el.pulse else el.value
                         for el in vsrcs] for t in times],
                       dtype=torch.float64).to(device=device, dtype=dtype)
    v_c = torch.zeros((B, len(caps)), dtype=dtype, device=device)
    i_l = torch.zeros((B, len(inds)), dtype=dtype, device=device)
    vd_prev = torch.zeros((B, len(diodes)), dtype=dtype, device=device)
    sw_on = torch.zeros((B, len(switches)), dtype=torch.bool, device=device)
    ok = torch.ones(B, dtype=torch.bool, device=device)
    passes = torch.zeros(B, dtype=torch.int64, device=device)
    out = torch.empty((B, len(times)), dtype=dtype, device=device)
    base = torch.zeros((B, n, n), dtype=dtype, device=device)
    for i, el in enumerate(deck.of("R")):
        st.admittance(base, el.nodes[0], el.nodes[1], 1.0 / vals["R"][:, i])
    for i, el in enumerate(caps):
        st.admittance(base, el.nodes[0], el.nodes[1], vals["C"][:, i] / dt)
    for i, el in enumerate(inds):
        st.admittance(base, el.nodes[0], el.nodes[1], dt / vals["L"][:, i])
    branch = [st.vsource(base, k, el) for k, el in enumerate(vsrcs)]
    for s in range(len(times)):
        rhs0 = torch.zeros((B, n), dtype=dtype, device=device)
        for i, el in enumerate(caps):
            st.current(rhs0, el.nodes[0], el.nodes[1],
                       -(vals["C"][:, i] / dt) * v_c[:, i])
        for i, el in enumerate(inds):
            st.current(rhs0, el.nodes[0], el.nodes[1], i_l[:, i])
        for k, j in enumerate(branch):
            rhs0[:, j] += src[s, k]
        x = torch.zeros((B, n), dtype=dtype, device=device)
        sw = sw_on
        done = torch.zeros(B, dtype=torch.bool, device=device)
        for it in range(MAX_PASSES):
            A, rhs = base.clone(), rhs0.clone()
            for k, el in enumerate(switches):
                m = el.model
                r = torch.where(sw[:, k], torch.tensor(m["ron"], dtype=dtype,
                                                       device=device),
                                torch.tensor(m["roff"], dtype=dtype,
                                             device=device))
                st.admittance(A, el.nodes[0], el.nodes[1],
                              1.0 / torch.clamp(r.abs(), min=EPS))
            for k, el in enumerate(diodes):
                m = el.model
                vd = (vd_prev[:, k] if it == 0
                      else drop(x, el.nodes[0], el.nodes[1]))
                vd = torch.clamp(vd, VD_MIN, VD_MAX)
                nvt = m["n"] * VT
                e = torch.exp(vd / nvt)
                i_d = m["is"] * (e - 1.0)
                g = torch.clamp((m["is"] / nvt) * e, min=GMIN)
                st.admittance(A, el.nodes[0], el.nodes[1], g)
                st.current(rhs, el.nodes[0], el.nodes[1], i_d - g * vd)
            x_new, solved = solve(A, rhs)
            new_on = sw.clone()
            for k, el in enumerate(switches):
                vc = drop(x_new, el.nodes[2], el.nodes[3])
                new_on[:, k] = torch.where(sw[:, k], ~(vc < el.model["voff"]),
                                           vc > el.model["von"])
            settled = (new_on == sw).all(dim=-1)
            passes += (~done).long()
            ok = ok & (done | solved)
            x = torch.where(done[:, None], x, x_new)
            sw = torch.where(done[:, None], sw, new_on)
            done = done | settled
            if not switches or bool(done.all()):
                break
        sw_on = sw
        for i, el in enumerate(caps):
            v_c[:, i] = drop(x, el.nodes[0], el.nodes[1])
        for i, el in enumerate(inds):
            i_l[:, i] = i_l[:, i] + (dt / vals["L"][:, i]) * drop(
                x, el.nodes[0], el.nodes[1])
        for k, el in enumerate(diodes):
            vd_prev[:, k] = drop(x, el.nodes[0], el.nodes[1])
        out[:, s] = x[:, probe_row]
    return out, ok & torch.isfinite(out).all(dim=-1), passes


def stamp_adds(deck: Deck) -> int:
    """Matrix and right-hand-side entries one transient assembly of
    ``deck`` adds to: an admittance touches k^2 entries for its k
    terminals off ground, a current source k, a V source its four (or
    two) incidence entries and its right-hand side."""
    st = Stamper(deck)

    def k(el: Element, pair: tuple[str, str]) -> int:
        return sum(st.idx(n) is not None for n in pair)

    adds = 0
    for el in deck.elements:
        pair = el.nodes[:2]
        if el.kind in "RCL":
            adds += k(el, pair) ** 2
            if el.kind in "CL":
                adds += k(el, pair)
        elif el.kind == "V":
            adds += 2 * k(el, pair) + 1
        elif el.kind in "DS":
            adds += k(el, pair) ** 2 + (k(el, pair) if el.kind == "D" else 0)
    return adds


def lane_values(deck: Deck) -> int:
    """Stamp values one transient assembly of ``deck`` reads that the
    stamper above holds per variant: each R, C and L conductance, each C's
    and L's history current, a diode's conductance and companion current,
    a switch's conductance (``tran_response`` keeps each switch's state
    per variant, since its control voltage is in general the variant's own
    solution; where a deck drives the control from a V source alone, as
    the boost does, every variant reads the same, and this counts one
    value a variant more than the least an assembly must read). A V
    source's value is the same for every variant (the deck's, at the
    step's time) and is not counted."""
    per = {"R": 1, "C": 2, "L": 2, "D": 2, "S": 1, "V": 0}
    return sum(per[el.kind] for el in deck.elements)


def tran_facts(deck_text: str) -> dict:
    """What a transient configuration states of its deck, read here:
    the analysis, every R, C and L's nominal value, and the shapes the
    work formulas read (unknowns, time points, V sources, ``stamp_adds``,
    ``lane_values``)."""
    deck = read_deck(deck_text)
    if deck.tran is None:
        raise ValueError("the deck has no .tran line")
    return {"analysis": "tran",
            "nominal": {el.name: el.value for el in deck.elements
                        if el.kind in "RCL"},
            "shape": {"unknowns": len(deck.unknowns),
                      "points": len(time_grid(deck)[1]),
                      "sources": len(deck.of("V")),
                      "stamp_adds": stamp_adds(deck),
                      "lane_values": lane_values(deck)}}
