"""AC small-signal frequency sweep on torch tensors.

Contract: spicey/lib/analysis/simulateAC.ts:9-130. The reference loops
frequencies serially, refactorizing an O(Nvar^2) complex matrix per point.
Here assembly is batched over (variants, frequencies) with leading tensor
dimensions and the whole grid is ONE batched complex solve: kernel K1 on a
CUDA tensor (ops/gj.py), its plain version on the CPU.

The complex system A(f) = G + j*B(f) is kept as two real planes, as in the
JAX package, so both packages solve the same systems the same way; phasors
are reassembled host-side.

Stamp semantics per frequency f (simulateAC.ts:24-60):
  - R as Y = 1/R (R <= 0 raises);
  - C as Y = j*2*pi*f*C                               -> imaginary part;
  - L as Y = 1/(j*2*pi*f*L) = -j/(2*pi*f*L), open circuit when
    |2*pi*f*L| < EPS                                  -> imaginary part;
  - V as phasor fromPolar(acMag, acPhaseDeg) on its branch row.
Switches and diodes are NOT stamped in AC (no DC operating point / small-
signal linearization exists in the reference).

Not ported yet, each raising ``NotImplementedError``: ``linearize="op"``
(needs the operating point, ROADMAP §1 item 4), the Schur tier
(``method="schur"``, item 6), K coupling and T lines (item 2). The JAX
package's host interp tier for tiny decks has no counterpart: the device
path is the path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import EPS
from ..ir.circuit import (CircuitTensors, build_tensors, bv_branch_rows,
                          ext_arrays)
from ..ops.linsolve import solve_planes
from ..ops.stamps import (
    stamp_admittance,
    stamp_current,
    stamp_extended,
    stamp_voltage_source,
)
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from ..utils.logspace import linear_grid, logspace, octspace
from .results import ACResult


def build_frequency_array(mode: str, N: int, f1: float, f2: float) -> np.ndarray:
    if mode == "dec":
        return logspace(f1, f2, N)
    if mode == "oct":  # extended dialect (.ac oct parses only there)
        return octspace(f1, f2, N)
    return linear_grid(f1, f2, N)


def _inductor_susceptance(w: torch.Tensor, l_vals: torch.Tensor
                          ) -> torch.Tensor:
    """Imag part of Y_L = -1/(w*L), masked open when |w*L| < EPS.
    w: (F,); l_vals: (B, nL) -> (B, F, nL)."""
    wl = w[None, :, None] * l_vals[:, None, :]
    small = wl.abs() < EPS
    one = torch.ones((), dtype=wl.dtype, device=wl.device)
    return torch.where(small, torch.zeros_like(wl),
                       -1.0 / torch.where(small, one, wl))


def _assemble_grid(freqs: torch.Tensor, r_idx: torch.Tensor,
                   r_vals: torch.Tensor, c_idx: torch.Tensor,
                   c_vals: torch.Tensor, l_idx: torch.Tensor,
                   l_vals: torch.Tensor, v_idx: torch.Tensor,
                   v_re: torch.Tensor, v_im: torch.Tensor, nvar: int,
                   ext: dict | None = None,
                   i_re: torch.Tensor | None = None,
                   i_im: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, ...]:
    """Batched MNA assembly over variants and frequencies.

    Value arrays lead with a variants axis B: r/c/l_vals (B, nE), v_re/v_im
    (B, nV), ext value arrays (B, nX); i_re/i_im (nI,) are shared. Index
    arrays are int64 tensors on the values' device. Returns the planes
    (A_re, A_im, b_re, b_im) shaped (B, F, N, N) and (B, F, N), batch-first
    as K1 takes them. This one function plays the roles of the JAX
    package's ``_assemble_one``/``_assemble_grid`` (a batch dimension in
    place of ``vmap``) and of ``_assemble_grid_batchlast`` (the K1 route's
    assembly)."""
    B = r_vals.shape[0]
    F = freqs.shape[0]
    dtype = r_vals.dtype
    dev = r_vals.device
    n1 = nvar + 1
    A_re = torch.zeros((B, F, n1, n1), dtype=dtype, device=dev)
    A_im = torch.zeros((B, F, n1, n1), dtype=dtype, device=dev)
    b_re = torch.zeros((B, F, n1), dtype=dtype, device=dev)
    b_im = torch.zeros((B, F, n1), dtype=dtype, device=dev)

    w = (2.0 * math.pi) * freqs.to(dtype)
    stamp_admittance(A_re, r_idx, (1.0 / r_vals)[:, None, :])
    stamp_admittance(A_im, c_idx, w[None, :, None] * c_vals[:, None, :])
    stamp_admittance(A_im, l_idx, _inductor_susceptance(w, l_vals))
    stamp_voltage_source(A_re, b_re, v_idx, v_re[:, None, :])
    b_im.index_add_(-1, v_idx[:, 2],
                    v_im[:, None, :].expand(B, F, v_idx.shape[0]))
    if ext is not None:
        # extended-dialect current sources: RHS phasor injection
        stamp_current(b_re, ext["i_idx"], i_re)
        stamp_current(b_im, ext["i_idx"], i_im)
        # controlled sources: real, frequency-independent stamps
        stamp_extended(A_re, {k: (v if k.endswith("idx") else v[:, None, :])
                              for k, v in ext.items()})
    return (A_re[..., :nvar, :nvar], A_im[..., :nvar, :nvar],
            b_re[..., :nvar], b_im[..., :nvar])


def _ac_sweep_core(freqs: torch.Tensor, r_idx: torch.Tensor,
                   r_vals: torch.Tensor, c_idx: torch.Tensor,
                   c_vals: torch.Tensor, l_idx: torch.Tensor,
                   l_vals: torch.Tensor, v_idx: torch.Tensor,
                   v_re: torch.Tensor, v_im: torch.Tensor, nvar: int,
                   method: str = "gj", ext: dict | None = None,
                   i_re: torch.Tensor | None = None,
                   i_im: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble + one batched solve over the whole grid. Values as in
    ``_assemble_grid``; returns (x_re, x_im, valid) shaped (B, F, N),
    (B, F, N), (B, F)."""
    A_re, A_im, b_re, b_im = _assemble_grid(
        freqs, r_idx, r_vals, c_idx, c_vals, l_idx, l_vals, v_idx,
        v_re, v_im, nvar, ext=ext, i_re=i_re, i_im=i_im)
    return solve_planes(A_re, A_im, b_re, b_im, method=method)


def _element_currents(tensors: CircuitTensors, freqs, x) -> dict[str, np.ndarray]:
    """Per-element current phasors, vectorized over the grid
    (simulateAC.ts:94-126). Host-side complex128 NumPy."""
    x_pad = np.concatenate(
        [x, np.zeros((x.shape[0], 1), dtype=x.dtype)], axis=1
    )
    w = 2.0 * np.pi * freqs  # (F,)
    out: dict[str, np.ndarray] = {}

    def vdrop(idx):
        return x_pad[:, idx[:, 0]] - x_pad[:, idx[:, 1]]  # (F, nE)

    if tensors.n_r:
        i_r = vdrop(tensors.r_idx) / tensors.r_vals[None, :]
        for k, name in enumerate(tensors.r_names):
            out[name] = i_r[:, k]
    if tensors.n_c:
        y_c = 1j * w[:, None] * tensors.c_vals[None, :]
        i_c = y_c * vdrop(tensors.c_idx)
        for k, name in enumerate(tensors.c_names):
            out[name] = i_c[:, k]
    if tensors.n_l:
        vd_l = vdrop(tensors.l_idx)
        wl = w[:, None] * tensors.l_vals[None, :]
        y_l = np.where(np.abs(wl) < EPS, 0.0,
                       -1.0 / np.where(np.abs(wl) < EPS, 1.0, wl))
        i_l = (1j * y_l) * vd_l
        for k, name in enumerate(tensors.l_names):
            out[name] = i_l[:, k]
    for k, name in enumerate(tensors.v_names):
        out[name] = x[:, tensors.v_idx[k, 2]]
    if tensors.n_g:
        vc = (x_pad[:, tensors.g_idx[:, 2]]
              - x_pad[:, tensors.g_idx[:, 3]])
        i_g = tensors.g_gm[None, :] * vc
        for k, name in enumerate(tensors.g_names):
            out[name] = i_g[:, k]
    for k, name in enumerate(tensors.e_names):
        out[name] = x[:, tensors.e_idx[k, 2]]
    for k, name in enumerate(tensors.f_names):
        out[name] = tensors.f_gain[k] * x[:, tensors.f_idx[k, 2]]
    for k, name in enumerate(tensors.h_names):
        out[name] = x[:, tensors.h_idx[k, 2]]
    if tensors.n_i:
        iph = tensors.i_ac_phase_deg * np.pi / 180.0
        i_ph = tensors.i_ac_mag * np.exp(1j * iph)
        for k, name in enumerate(tensors.i_names):
            out[name] = np.full(x.shape[0], i_ph[k], dtype=np.complex128)
    return out


def ac_vsource_arrays(ckt: ParsedCircuit, tensors: CircuitTensors):
    """(v_idx, v_re, v_im) for the AC sweep: independent V phasors
    fromPolar(acMag, acPhaseDeg) (Complex.ts:16-19), plus V-kind behavioral
    sources' branch rows stamped as 0 V small-signal shorts so the system
    stays regular (matching the reference's policy of not stamping
    nonlinear devices)."""
    ph = tensors.v_ac_phase_deg * math.pi / 180.0
    v_re = tensors.v_ac_mag * np.cos(ph)
    v_im = tensors.v_ac_mag * np.sin(ph)
    v_idx = tensors.v_idx
    bv = bv_branch_rows(ckt, tensors.nvar)
    if bv.shape[0]:
        v_idx = np.concatenate([tensors.v_idx, bv], axis=0)
        z = np.zeros(bv.shape[0])
        v_re = np.concatenate([v_re, z])
        v_im = np.concatenate([v_im, z])
    return v_idx, v_re, v_im


def check_ported(tensors: CircuitTensors, method: str) -> None:
    """Raise ``NotImplementedError`` for what the AC slice does not carry
    yet, naming the ROADMAP item that brings it."""
    if method == "schur":
        raise NotImplementedError(
            "the Schur tier is not ported yet (ROADMAP §1 item 6)")
    if tensors.n_k:
        raise NotImplementedError(
            "K (mutual inductance) elements are not ported yet "
            "(ROADMAP §1 item 2)")
    if tensors.n_t:
        raise NotImplementedError(
            "T (transmission line) elements are not ported yet "
            "(ROADMAP §1 item 2)")


def index_tensor(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def simulate_ac(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    linearize: str | None = None,
    device: torch.device | str | None = None,
) -> ACResult | None:
    """AC sweep in float64 on ``device`` (the card unless
    ``device="cpu"``). ``linearize=None`` (the only ported mode) keeps
    reference parity: nonlinear devices are NOT stamped
    (simulateAC.ts:24-60)."""
    device = resolve_device(device)
    if ckt.ac is None:
        return None
    for r in ckt.R:
        if r.R <= 0:
            raise ValueError(f"R {r.name} must be > 0")
    if tensors is None:
        tensors = build_tensors(ckt)
    if linearize not in (None, "op"):
        raise ValueError("linearize must be None or 'op'")
    if linearize == "op":
        raise NotImplementedError(
            "linearize='op' needs the operating point, which is not "
            "ported yet (ROADMAP §1 item 4)")
    check_ported(tensors, method)
    freqs = build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2)
    v_idx_ac, v_re, v_im = ac_vsource_arrays(ckt, tensors)
    iph = tensors.i_ac_phase_deg * math.pi / 180.0
    f64 = torch.float64

    def vals(a: np.ndarray) -> torch.Tensor:
        # one variant: a leading batch axis of 1
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64,
                               device=device)[None]

    x_re, x_im, valid = _ac_sweep_core(
        torch.as_tensor(freqs, dtype=f64, device=device),
        index_tensor(tensors.r_idx, device), vals(tensors.r_vals),
        index_tensor(tensors.c_idx, device), vals(tensors.c_vals),
        index_tensor(tensors.l_idx, device), vals(tensors.l_vals),
        index_tensor(v_idx_ac, device), vals(v_re), vals(v_im),
        tensors.nvar, method=method,
        ext={k: (v if k.endswith("idx") else v[None])
             for k, v in ext_arrays(tensors, device, f64).items()},
        i_re=vals(tensors.i_ac_mag * np.cos(iph))[0],
        i_im=vals(tensors.i_ac_mag * np.sin(iph))[0],
    )
    # one device->host transfer of the packed result
    packed = torch.cat([x_re[0], x_im[0], valid[0][:, None].to(f64)],
                       dim=1).cpu().numpy()
    nv = tensors.nvar
    if not bool(np.all(packed[:, -1] > 0.5)):
        raise ValueError("Singular matrix in AC solve")
    x = packed[:, :nv] + 1j * packed[:, nv:2 * nv]  # (F, nvar) c128

    node_voltages = {
        name: x[:, i] for i, name in enumerate(tensors.node_names)
    }
    if getattr(ckt, "ac_probes", None):
        # extended .print ac v(...): filter like the reference's tran
        # probe filter (canonical-casing keys kept)
        upper = {p.upper() for p in ckt.ac_probes}
        node_voltages = {
            name: series for name, series in node_voltages.items()
            if name.upper() in upper
        }
    element_currents = _element_currents(tensors, freqs, x)
    return ACResult(
        freqs=freqs,
        node_voltages=node_voltages,
        element_currents=element_currents,
    )
