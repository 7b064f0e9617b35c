"""Plain reference of the ``divider-clamp`` fixture configuration: the DC
operating point of a deck of R, V (DC) and D elements, every variant on
its own, by Newton's method on the modified nodal equations in PyTorch.
Imports only PyTorch and the standard library.

What a deck may hold here: R, V (``dc`` or a bare value), D with
``.model <name> D(Is= N=)``, ``.op``, ``.step param <element> <start>
<stop> <step>`` (read, and swept by the traffic instead), ``.end``. The
first line is the title. Anything else raises.

Semantics: unknowns are the node voltages, then one branch current per V
source. A diode is its Shockley companion at its junction voltage,
conductance max(Is/(N VT) e^(vd/(N VT)), GMIN); Newton starts from rest,
and a pass may raise a junction's voltage by at most ``STEP_UP`` (a
plain limit that keeps the exponential finite); a variant is done after
a pass that limited no junction and moved no unknown by more than
``tol`` (1 + |x|), ``tol`` a few hundred units in the last place of the
dtype.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import torch

VT = 0.02585             # thermal voltage at 300 K (the upstream physics.ts)
GMIN = 1e-12
STEP_UP = 0.1            # V, the most a pass raises a junction's voltage
MAX_PASSES = 200
TOL_ULPS = 256

_SUFFIX = (("meg", 1e6), ("t", 1e12), ("g", 1e9), ("k", 1e3), ("m", 1e-3),
           ("u", 1e-6), ("n", 1e-9), ("p", 1e-12), ("f", 1e-15))
_NUM = re.compile(r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)([a-zA-Z]*)$")


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
class Deck:
    elements: list[tuple[str, str, tuple[str, str], dict]] = \
        field(default_factory=list)   # (name, kind, nodes, params)
    nodes: list[str] = field(default_factory=list)
    op: bool = False
    step: tuple | None = None         # (element, start, stop, step)

    def of(self, kind: str) -> list:
        return [e for e in self.elements if e[1] == kind]


def read_deck(text: str) -> Deck:
    deck = Deck()
    models: dict[str, dict] = {}
    raw = []
    for line in text.strip("\n").splitlines()[1:]:
        line = line.split(";")[0].strip()
        if not line or line.startswith("*"):
            continue
        flat = re.sub(r"[()=]", " ", line).split()
        head = flat[0].lower()
        if head == ".end":
            break
        if head == ".model":
            if flat[2].upper() != "D":
                raise ValueError(f"the reference does not read {flat[2]}")
            params = {"is": 1e-14, "n": 1.0}
            for key, val in zip(flat[3::2], flat[4::2]):
                if key.lower() not in params:
                    raise ValueError(f"the reference does not read the D "
                                     f"parameter {key}")
                params[key.lower()] = number(val)
            models[flat[1].upper()] = params
        elif head == ".op":
            deck.op = True
        elif head == ".step" and flat[1].lower() == "param":
            deck.step = (flat[2], *(number(t) for t in flat[3:6]))
        elif head.startswith("."):
            raise ValueError(f"the reference does not read {flat[0]}")
        else:
            raw.append(flat)
    for flat in raw:
        name, kind = flat[0], flat[0][0].upper()
        nodes = (flat[1], flat[2])
        for n in nodes:
            if n != "0" and n.lower() != "gnd" and n not in deck.nodes:
                deck.nodes.append(n)
        if kind == "R":
            params = {"value": number(flat[3])}
        elif kind == "V":
            toks = flat[3:]
            params = {"value": number(toks[1] if toks[0].lower() == "dc"
                                      else toks[0])}
        elif kind == "D":
            params = dict(models[flat[3].upper()])
        else:
            raise ValueError(f"the reference does not read {name}")
        deck.elements.append((name, kind, nodes, params))
    return deck


def facts(deck_text: str) -> dict:
    """The analysis, every R's nominal value, and the shapes the work
    formulas read (the unknowns), read from the deck here."""
    deck = read_deck(deck_text)
    if not deck.op:
        raise ValueError("the deck has no .op line")
    return {"analysis": "op",
            "nominal": {n: p["value"] for n, _k, _nd, p in deck.of("R")},
            "shape": {"unknowns": len(deck.nodes) + len(deck.of("V"))}}


def operating_points(deck_text: str, overrides: dict, dtype: torch.dtype,
                     device: torch.device
                     ) -> tuple[torch.Tensor, list[str], torch.Tensor, dict]:
    """Every variant's node voltages (B, nodes) at ``dtype``, the nodes'
    names, the variants solved (converged, finite) (B,), and the Newton
    passes they needed (``passes_per_lane``, the mean)."""
    deck = read_deck(deck_text)
    upper = {k.upper(): v for k, v in overrides.items()}
    names = {e[0].upper() for e in deck.of("R")}
    unknown = sorted(set(upper) - names)
    if unknown:
        raise ValueError(f"the deck has no R named {unknown}")
    B = len(next(iter(overrides.values())))
    row = {n: i for i, n in enumerate(deck.nodes)}
    nn, vsrc, diodes = len(deck.nodes), deck.of("V"), deck.of("D")
    n = nn + len(vsrc)

    def at(x: torch.Tensor, node: str) -> torch.Tensor:
        i = row.get(node)
        return x[:, i] if i is not None else torch.zeros_like(x[:, 0])

    def admit(A: torch.Tensor, a: str, b: str, y: torch.Tensor) -> None:
        i, j = row.get(a), row.get(b)
        if i is not None:
            A[:, i, i] += y
        if j is not None:
            A[:, j, j] += y
        if i is not None and j is not None:
            A[:, i, j] -= y
            A[:, j, i] -= y

    def inject(rhs: torch.Tensor, a: str, b: str, cur: torch.Tensor) -> None:
        i, j = row.get(a), row.get(b)
        if i is not None:
            rhs[:, i] -= cur
        if j is not None:
            rhs[:, j] += cur

    base = torch.zeros((B, n, n), dtype=dtype, device=device)
    rhs0 = torch.zeros((B, n), dtype=dtype, device=device)
    for name, _k, (a, b), p in deck.of("R"):
        r = upper.get(name.upper())
        r = (torch.full((B,), p["value"], dtype=torch.float64) if r is None
             else torch.as_tensor(r, dtype=torch.float64))
        admit(base, a, b, (1.0 / r).to(device=device, dtype=dtype))
    for k, (_name, _k, (a, b), p) in enumerate(vsrc):
        j = nn + k
        for node, sign in ((a, 1.0), (b, -1.0)):
            i = row.get(node)
            if i is not None:
                base[:, i, j] += sign
                base[:, j, i] += sign
        rhs0[:, j] = p["value"]
    tol = TOL_ULPS * torch.finfo(dtype).eps
    x = torch.zeros((B, n), dtype=dtype, device=device)
    vj = torch.zeros((B, len(diodes)), dtype=dtype, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    passes = torch.zeros(B, dtype=torch.int64, device=device)
    for _ in range(MAX_PASSES):
        A, rhs = base.clone(), rhs0.clone()
        for k, (_name, _k, (a, b), p) in enumerate(diodes):
            nvt = p["n"] * VT
            e = torch.exp(vj[:, k] / nvt)
            g = torch.clamp(p["is"] / nvt * e, min=GMIN)
            admit(A, a, b, g)
            inject(rhs, a, b, p["is"] * (e - 1.0) - g * vj[:, k])
        sol, info = torch.linalg.solve_ex(A, rhs[..., None])
        x_new = torch.where((info == 0)[:, None], sol[..., 0],
                            torch.full_like(x, math.nan))
        vj_new = torch.stack([at(x_new, a) - at(x_new, b)
                              for _n, _k, (a, b), _p in diodes], dim=1) \
            if diodes else vj
        limited = (vj_new > vj + STEP_UP).any(dim=1)
        vj_new = torch.minimum(vj_new, vj + STEP_UP)
        settled = ~limited & ((x_new - x).abs()
                              <= tol * (1.0 + x_new.abs())).all(dim=1)
        passes += (~done).long()
        x = torch.where(done[:, None], x, x_new)
        vj = torch.where(done[:, None], vj, vj_new)
        done = done | settled
        if bool(done.all()):
            break
    ok = done & torch.isfinite(x).all(dim=1)
    return (x[:, :nn], list(deck.nodes), ok,
            {"passes_per_lane": float(passes.double().mean())})
