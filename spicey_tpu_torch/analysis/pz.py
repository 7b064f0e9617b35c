"""Pole-zero analysis (.pz) — an extension.

The reference has no pole-zero analysis (SURVEY §2.9 lists only AC/TRAN;
`.pz` lines land in `skipped`). This mirrors ngspice's
``.pz n1 n2 n3 n4 cur|vol pol|zer|pz``.

Formulation: at the DC operating point the small-signal MNA system is a
linear matrix pencil ``A(s) = G + s*C`` — polynomial in s because inductors
enter through BRANCH unknowns (row ``v1 - v2 - s*L*i = 0``: incidence in G,
``-L`` on the branch diagonal of C; mutual couplings put ``-M`` on the
off-diagonals), exactly the op-system layout of analysis/op.py. Then

  - poles  = finite generalized eigenvalues of det(G + s*C) = 0, with the
    input port active (shorted ideal V branch for ``vol``, open for
    ``cur`` — matching how each drive loads the network);
  - zeros  = finite generalized eigenvalues of the BORDERED pencil
    ``det([[G + s*C, b], [cᵀ, 0]]) = 0`` where b is the input excitation
    column and c the output selection row (Cramer's rule: the transfer
    function's numerator is that bordered determinant up to the constant
    denominator factor).

Both are one host-side QZ decomposition each (scipy.linalg.eigvals with a
B matrix); the matrices are tiny (N ≲ dozens) and the decomposition is a
one-shot direct method — this is post-processing like .meas/.four, not a
sweep, so it stays off the card, as it stays off the TPU in
spicey_tpu/analysis/pz.py, of which this is a copy; the operating point
it linearizes at is the port's (kernel K2 on the card). Every linearized
device the .op/.noise paths know (R, C, L+K, V/I/E/F/G/H, switch state,
diode gd, MOSFET/BJT/JFET small-signal rows, behavioral-source gradients)
participates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS
from ..ir.circuit import CircuitTensors, build_tensors, bv_branch_rows
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .ac import _bsource_small_signal, small_signal_rows
from .op import simulate_op


@dataclass
class PZResult:
    poles: np.ndarray   # (nP,) complex128, rad/s
    zeros: np.ndarray   # (nZ,) complex128, rad/s (empty when which="pol")
    transfer: str       # "cur" | "vol"
    which: str          # "pol" | "zer" | "pz"
    in_spec: str        # "(n1,n2)"
    out_spec: str       # "(n3,n4)"

    @property
    def poles_hz(self) -> np.ndarray:
        return self.poles / (2.0 * np.pi)

    @property
    def zeros_hz(self) -> np.ndarray:
        return self.zeros / (2.0 * np.pi)


# --- host-side stamp helpers (numpy twins of ops/stamps.py) ---

def _adm(A, idx, y):
    if idx.shape[0] == 0:
        return
    i1, i2 = idx[:, 0], idx[:, 1]
    np.add.at(A, (i1, i1), y)
    np.add.at(A, (i2, i2), y)
    np.add.at(A, (i1, i2), -y)
    np.add.at(A, (i2, i1), -y)


def _vsrc(A, idx3):
    if idx3.shape[0] == 0:
        return
    i1, i2, j = idx3[:, 0], idx3[:, 1], idx3[:, 2]
    np.add.at(A, (i1, j), 1.0)
    np.add.at(A, (j, i1), 1.0)
    np.add.at(A, (i2, j), -1.0)
    np.add.at(A, (j, i2), -1.0)


def _vccs(A, idx4, g):
    if idx4.shape[0] == 0:
        return
    i1, i2, icp, icn = idx4[:, 0], idx4[:, 1], idx4[:, 2], idx4[:, 3]
    np.add.at(A, (i1, icp), g)
    np.add.at(A, (i1, icn), -g)
    np.add.at(A, (i2, icp), -g)
    np.add.at(A, (i2, icn), g)


def _vcvs(A, idx5, gain):
    if idx5.shape[0] == 0:
        return
    i1, i2, j, icp, icn = (idx5[:, 0], idx5[:, 1], idx5[:, 2],
                           idx5[:, 3], idx5[:, 4])
    np.add.at(A, (i1, j), 1.0)
    np.add.at(A, (i2, j), -1.0)
    np.add.at(A, (j, i1), 1.0)
    np.add.at(A, (j, i2), -1.0)
    np.add.at(A, (j, icp), -gain)
    np.add.at(A, (j, icn), gain)


def _cccs(A, idx3, gain):
    if idx3.shape[0] == 0:
        return
    i1, i2, jv = idx3[:, 0], idx3[:, 1], idx3[:, 2]
    np.add.at(A, (i1, jv), gain)
    np.add.at(A, (i2, jv), -gain)


def _ccvs(A, idx4, r):
    if idx4.shape[0] == 0:
        return
    i1, i2, j, jv = idx4[:, 0], idx4[:, 1], idx4[:, 2], idx4[:, 3]
    np.add.at(A, (i1, j), 1.0)
    np.add.at(A, (i2, j), -1.0)
    np.add.at(A, (j, i1), 1.0)
    np.add.at(A, (j, i2), -1.0)
    np.add.at(A, (j, jv), -r)


def _build_pencil(ckt: ParsedCircuit, tensors: CircuitTensors, op,
                  vol_input: bool, n1: int | None, n2: int | None):
    """(G, C, b, n_tot): the padded small-signal pencil at the op point.

    Layout: tensors.nvar AC unknowns (nodes + V/E/H/Bv branches), then nL
    inductor-branch currents, then (vol only) one input-source branch.
    Ground writes land on a dump row/col at index n_tot and are sliced off
    by the caller. ``n1``/``n2`` are node matrix indices (None = ground).
    """
    n0 = tensors.nvar
    n_l = tensors.n_l
    # A vol input drives an existing independent V source's branch when one
    # spans the port (adding a second ideal source in parallel would make a
    # voltage loop and the whole pencil singular for every s); only a port
    # with no source there gets a new branch appended.
    reuse_branch = None
    reuse_sign = 1.0
    if vol_input and tensors.n_v:
        p1 = n0 if n1 is None else n1  # n0 = the v_idx ground dump value
        p2 = n0 if n2 is None else n2
        for i1, i2, br_v in tensors.v_idx:
            if (i1, i2) == (p1, p2):
                reuse_branch, reuse_sign = int(br_v), 1.0
                break
            if (i1, i2) == (p2, p1):
                reuse_branch, reuse_sign = int(br_v), -1.0
                break
    new_branch = vol_input and reuse_branch is None
    n_tot = n0 + n_l + (1 if new_branch else 0)
    pad = n_tot

    def remap(a):
        a = np.asarray(a)
        return np.where(a == n0, pad, a).astype(np.int64)

    G = np.zeros((n_tot + 1, n_tot + 1))
    C = np.zeros((n_tot + 1, n_tot + 1))
    b = np.zeros(n_tot + 1)

    # linear resistive part
    _adm(G, remap(tensors.r_idx), 1.0 / tensors.r_vals)
    # switches at their converged hysteresis states
    if tensors.n_s:
        on = np.asarray([op.switch_states[n] for n in tensors.s_names])
        r_sw = np.maximum(np.abs(np.where(on, tensors.s_ron,
                                          tensors.s_roff)), EPS)
        _adm(G, remap(tensors.s_idx[:, :2]), 1.0 / r_sw)
    # independent V sources are small-signal shorts: branch rows stay,
    # excitations are zero; V-kind behavioral sources likewise
    _vsrc(G, remap(tensors.v_idx))
    _vsrc(G, remap(bv_branch_rows(ckt, n0)))
    # linear controlled sources
    _vccs(G, remap(tensors.g_idx), tensors.g_gm)
    _vcvs(G, remap(tensors.e_idx), tensors.e_gain)
    _cccs(G, remap(tensors.f_idx), tensors.f_gain)
    _ccvs(G, remap(tensors.h_idx), tensors.h_r)
    # nonlinear devices linearized at the op point (diode gd, MOSFET/BJT/
    # JFET gm/gds/..., exactly the linearize="op" AC rows)
    ss_idx, ss_g = small_signal_rows(tensors, op)
    _vccs(G, remap(ss_idx), ss_g)
    if ckt.B:
        bs_idx, bs_g = _bsource_small_signal(ckt, tensors, op)
        _vccs(G, remap(bs_idx), bs_g)

    # transmission lines at DC (theta -> 0 steady state): differential
    # short between the ports. Valid for G (.sens); the delay itself is
    # NOT polynomial in s, so .pz refuses circuits with lines.
    if tensors.n_t:
        ti = remap(tensors.t_idx)
        for (i1, i2, i3, i4, b1, b2), z0 in zip(ti, tensors.t_z0):
            for (p, q, br, fp, fq, obr) in ((i1, i2, b1, i3, i4, b2),
                                            (i3, i4, b2, i1, i2, b1)):
                G[p, br] += 1.0
                G[q, br] -= 1.0
                G[br, p] += 1.0
                G[br, q] -= 1.0
                G[br, br] -= z0
                G[br, fp] -= 1.0
                G[br, fq] += 1.0
                G[br, obr] -= z0

    # capacitors: admittance pattern with value C in the s-plane,
    # plus diode junction capacitances at the op point (extended TT/CJO)
    _adm(C, remap(tensors.c_idx), tensors.c_vals)
    if tensors.has_d_charge or tensors.has_q_charge:
        from .ac import diode_smallsignal_caps

        cj_idx, cj_vals = diode_smallsignal_caps(tensors, op)
        _adm(C, remap(cj_idx), cj_vals)
    # inductors: branch unknowns after the AC block; the branch row is
    # v1 - v2 - s*L*i = 0 (incidence in G, -L on C's branch diagonal)
    if n_l:
        l_br = n0 + np.arange(n_l)
        l_bidx = np.concatenate([remap(tensors.l_idx), l_br[:, None]], axis=1)
        _vsrc(G, l_bidx)
        C[l_br, l_br] -= tensors.l_vals
        # mutual couplings: -M on the off-diagonal branch pairs
        for (a, bpos), k in zip(tensors.k_pairs, tensors.k_vals):
            m = k * np.sqrt(tensors.l_vals[a] * tensors.l_vals[bpos])
            C[l_br[a], l_br[bpos]] -= m
            C[l_br[bpos], l_br[a]] -= m

    # input excitation
    if vol_input:
        if reuse_branch is not None:
            b[reuse_branch] = reuse_sign
        else:
            br = n0 + n_l
            _vsrc(G, np.asarray([[pad if n1 is None else n1,
                                  pad if n2 is None else n2, br]]))
            b[br] = 1.0
    else:
        if n1 is not None:
            b[n1] += 1.0
        if n2 is not None:
            b[n2] -= 1.0
    return (G[:n_tot, :n_tot], C[:n_tot, :n_tot], b[:n_tot], n_tot)


def _finite_eigs(G: np.ndarray, C: np.ndarray,
                 inf_threshold: float = 1e18) -> np.ndarray:
    """Finite generalized eigenvalues s of det(G + s*C) = 0 via QZ.

    Infinite eigenvalues (directions with no reactive part — most of the
    pencil, since C is rank-deficient) come back as inf/nan from the
    beta≈0 pairs and are dropped, as are numerically-infinite artifacts
    beyond ``inf_threshold`` rad/s. Conjugate-pair imaginary dust is
    squared off so real poles print as real."""
    from scipy.linalg import eigvals

    if G.shape[0] == 0:
        return np.zeros(0, np.complex128)
    s = eigvals(-G, C)
    s = s[np.isfinite(s)]
    s = s[np.abs(s) < inf_threshold]
    # zero out imaginary dust relative to the eigenvalue's own magnitude
    clean_im = np.where(np.abs(s.imag) < 1e-9 * np.maximum(np.abs(s), 1.0),
                        0.0, s.imag)
    s = s.real + 1j * clean_im
    order = np.lexsort((s.imag, -s.real))
    return s[order]


def simulate_pz(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    op=None,
    inf_threshold: float = 1e18,
    device: torch.device | str | None = None,
) -> PZResult | None:
    """Run the `.pz` analysis (None if the netlist has no .pz line).
    ``op`` optionally reuses an already-solved operating point; otherwise
    it is solved on ``device`` (the card unless ``device="cpu"``)."""
    if ckt.pz is None:
        return None
    device = resolve_device(device)
    if tensors is None:
        tensors = build_tensors(ckt)
    if tensors.n_t:
        raise ValueError(
            ".pz does not support transmission lines: the delay e^{-s*Td} "
            "is not a polynomial pencil (infinitely many poles)")
    spec = ckt.pz

    def node_index(name: str) -> int | None:
        node_id = ckt.nodes.get(name)
        if node_id is None:
            raise ValueError(f"Unknown node {name} in .pz directive")
        return None if node_id == 0 else node_id - 1

    n1, n2 = node_index(spec.n1), node_index(spec.n2)
    n3, n4 = node_index(spec.n3), node_index(spec.n4)

    if op is None:
        op = simulate_op(ckt, tensors=tensors, method=method, device=device)

    vol = spec.transfer == "vol"
    G, C, b, n_tot = _build_pencil(ckt, tensors, op, vol, n1, n2)

    poles = np.zeros(0, np.complex128)
    zeros = np.zeros(0, np.complex128)
    if spec.which in ("pol", "pz"):
        poles = _finite_eigs(G, C, inf_threshold)
    if spec.which in ("zer", "pz"):
        # bordered pencil: [[G + sC, b], [c^T, 0]] singular at the zeros
        c_row = np.zeros(n_tot)
        if n3 is not None:
            c_row[n3] += 1.0
        if n4 is not None:
            c_row[n4] -= 1.0
        Gz = np.zeros((n_tot + 1, n_tot + 1))
        Cz = np.zeros((n_tot + 1, n_tot + 1))
        Gz[:n_tot, :n_tot] = G
        Gz[:n_tot, n_tot] = b
        Gz[n_tot, :n_tot] = c_row
        Cz[:n_tot, :n_tot] = C
        zeros = _finite_eigs(Gz, Cz, inf_threshold)

    return PZResult(
        poles=poles, zeros=zeros, transfer=spec.transfer, which=spec.which,
        in_spec=f"({spec.n1},{spec.n2})", out_spec=f"({spec.n3},{spec.n4})")


def format_pz_result(res: PZResult) -> str:
    """ngspice-flavored pole/zero table (values in rad/s)."""
    lines = [f"pole-zero analysis ({res.transfer}): "
             f"input {res.in_spec} -> output {res.out_spec}"]
    if res.which in ("pol", "pz"):
        lines.append(f"poles ({len(res.poles)}):")
        for p in res.poles:
            lines.append(f"  {p.real: .6e} {p.imag:+.6e}j rad/s")
    if res.which in ("zer", "pz"):
        lines.append(f"zeros ({len(res.zeros)}):")
        for z in res.zeros:
            lines.append(f"  {z.real: .6e} {z.imag:+.6e}j rad/s")
    return "\n".join(lines) + "\n"
