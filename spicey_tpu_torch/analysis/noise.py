"""Small-signal noise analysis (.noise) on torch tensors.

Contract: spicey_tpu/analysis/noise.py, an extension mirroring ngspice's
``.noise v(out[,ref]) <src> <dec|lin> <N> <f1> <f2>``:

  1. solve the DC operating point and linearize every nonlinear device
     there (the rows AC ``linearize="op"`` uses, analysis/ac.py);
  2. over the whole frequency grid, solve the forward system A(f) x = b
     (a unit excitation at ``src``: the gain that refers the output noise
     back to the input) and the ADJOINT system A(f)^T z = e_out. By the
     adjoint property ``z_i - z_j`` is the transfer from a unit current
     injected between nodes (i, j) to v(out), so every noise generator's
     contribution is one vectorized |z_p - z_n|^2 * S product.

Both solves share A(f), so they run as ONE batched complex inverse per
frequency, kernel K4 on the card (ops/linsolve.inverse_planes), and two
batched matvecs, x = M b and z = M^T e_out, written as multiply + sum. The
JAX package's pallas tier keeps a residual guard on its inverse route
(spicey_tpu/ops/pallas_gj.py:551-555, :761-787), and so does this one: the
relative residual ||r|| / (||A|| ||x|| + ||b||) of x and of z is formed in
float64, and the systems above 1e-12 (the inverse loses accuracy against a
direct solve when cond(A) is large, as at the top of a GHz sweep) are
solved again directly by kernel K1, forward on A and adjoint on A^T. Their
number is ``NoiseResult.guard_resolves``. ``method="gj"`` and
``"pallas"`` name this same route, as in ``ops/linsolve.solve_planes``.

Noise generators (``_noise_generators``): resistor/switch thermal 4kT/R;
diode shot 2q*Id plus flicker KF*|Id|^AF / f; BJT collector/base shot
plus base flicker; MOSFET channel thermal by region at the operating point
((8/3)kT*gm in saturation, 4kT*gds in triode, zero in cutoff) plus flicker.
kT uses the circuit's ``.temp``.

The structured tier (ops/schur.py) routes as in the JAX package: forced
by ``method="schur"``, taken by ``method="gj"`` on a subcircuit board past
N = 128. Under a plan the forward and the adjoint systems are two Schur
solves (the transpose of a BBD matrix is BBD with the same partition, so
A^T takes the plan unchanged), not the inverse route; where a block pivot
fails the whole sweep is retried on the dense route above. A flat deck
past N = 128 runs the dense route (K4 in a global workspace where a
system overflows shared memory).

B sources are noiseless (ngspice semantics) but their gradients at the
operating point shape the transfer (``ac._bsource_small_signal``); K
couplings and T lines enter the systems as in AC (analysis/ac.py), and a
singular coupled-inductance matrix raises before any solve, as the JAX
package checks it (``_mutual_ok_np``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS, K_BOLTZMANN, Q_ELECTRON, T_NOISE
from ..ir.circuit import (CircuitTensors, build_tensors, bv_branch_rows,
                          ext_arrays, lk_arrays, tl_arrays)
from ..models.devices import bjt_ebers_moll, mos_level1
from ..ops.linsolve import _check_method, inverse_planes, solve_planes
from ..ops.schur import plan_for
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .ac import (_assemble_grid, _op_voltage_pad, batched_tl,
                 build_frequency_array, find_input_source, format_out_spec,
                 index_tensor, op_linearized_extras)
from .op import simulate_op
from .tran import _host, _mutual_inv, _mv

RESIDUAL_RTOL = 1e-12  # the JAX pallas tier's guard (pallas_gj.py:696-699)


@dataclass
class NoiseResult:
    freqs: np.ndarray               # (F,)
    output_psd: np.ndarray          # (F,) V^2/Hz at the output port
    input_psd: np.ndarray           # (F,) referred through |gain|^2
    gain: np.ndarray                # (F,) complex transfer src -> out
    contributions: dict[str, np.ndarray]  # per-device (F,) V^2/Hz
    total_output_rms: float         # sqrt(integral of output_psd over band)
    out_spec: str
    src_name: str
    guard_resolves: int = 0         # systems the residual guard re-solved

    @property
    def output_v_per_sqrt_hz(self) -> np.ndarray:
        return np.sqrt(self.output_psd)

    @property
    def input_v_per_sqrt_hz(self) -> np.ndarray:
        return np.sqrt(self.input_psd)


def _noise_generators(tensors: CircuitTensors, op) -> tuple[
        np.ndarray, np.ndarray, np.ndarray, list[str]]:
    """Every noise current generator as (node-pair rows, white PSD A^2/Hz,
    flicker coefficient A^2, owning-device names); the full PSD at
    frequency f is ``white + flicker / f``. Node indices are tran/AC matrix
    indices with the ground dump at tensors.nvar."""
    # T_NOISE (=VT_300K*q/k ~ 299.98 K) keeps kT consistent with the
    # reference's rounded VT constant at the default temperature; .temp
    # scales it proportionally
    t_eff = T_NOISE * (tensors.temp_k / 300.0)
    four_kt = 4.0 * K_BOLTZMANN * t_eff
    x_pad = _op_voltage_pad(tensors, op)
    idx: list[np.ndarray] = []
    psd: list[np.ndarray] = []
    flick: list[np.ndarray] = []
    names: list[str] = []

    def gen(rows, white, flicker=None):
        idx.append(rows)
        white = np.asarray(white, np.float64)
        psd.append(white)
        flick.append(np.zeros_like(white) if flicker is None
                     else np.asarray(flicker, np.float64))

    if tensors.n_r:
        gen(tensors.r_idx, four_kt / tensors.r_vals)
        names.extend(tensors.r_names)
    if tensors.n_s:
        on = np.asarray([op.switch_states[n] for n in tensors.s_names])
        r_sw = np.maximum(np.abs(np.where(on, tensors.s_ron,
                                          tensors.s_roff)), EPS)
        gen(tensors.s_idx[:, :2], four_kt / r_sw)
        names.extend(tensors.s_names)
    if tensors.n_d:
        i_d = np.abs([op.element_currents[n] for n in tensors.d_names])
        gen(tensors.d_idx, 2.0 * Q_ELECTRON * i_d,
            tensors.d_kf * i_d ** tensors.d_af)
        names.extend(tensors.d_names)
    if tensors.n_m:
        mi = tensors.m_idx
        vgs = x_pad[mi[:, 1]] - x_pad[mi[:, 2]]
        vds = x_pad[mi[:, 0]] - x_pad[mi[:, 2]]
        gm, gds, _, i_ds = _host(mos_level1, vgs, vds, tensors.m_beta,
                                 tensors.m_vto, tensors.m_lambda,
                                 tensors.m_polarity)
        # operating region at the DC point (reflected frame, symmetric in
        # vds like mos_level1): cutoff -> no channel noise; triode -> the
        # resistive-channel form 4kT*gds; saturation -> (8/3)kT*gm
        s = tensors.m_polarity
        vgs_r = s * vgs
        vds_e = np.abs(vds)
        vov = np.where(s * vds < 0, vgs_r + vds_e, vgs_r) - s * tensors.m_vto
        cutoff = vov <= 0.0
        sat = vds_e >= vov
        white_m = np.where(
            cutoff, 0.0,
            np.where(sat, (8.0 / 3.0) * K_BOLTZMANN * t_eff * np.abs(gm),
                     four_kt * np.abs(gds)))
        gen(mi[:, [0, 2]], white_m,  # drain-source channel
            tensors.m_kf * np.abs(i_ds) ** tensors.m_af)
        names.extend(tensors.m_names)
    if tensors.n_q:
        qi = tensors.q_idx
        vbe = x_pad[qi[:, 1]] - x_pad[qi[:, 2]]
        vbc = x_pad[qi[:, 1]] - x_pad[qi[:, 0]]
        *_, i_c, i_b = _host(bjt_ebers_moll, vbe, vbc, tensors.q_is,
                             tensors.q_bf, tensors.q_br, tensors.q_polarity,
                             tensors.vt, tensors.q_polarity * vbe,
                             tensors.q_polarity * vbc)
        gen(qi[:, [0, 2]], 2.0 * Q_ELECTRON * np.abs(i_c))
        names.extend(tensors.q_names)  # collector shot, c-e
        gen(qi[:, [1, 2]], 2.0 * Q_ELECTRON * np.abs(i_b),
            tensors.q_kf * np.abs(i_b) ** tensors.q_af)
        names.extend(tensors.q_names)  # base shot + flicker, b-e

    if not idx:
        return (np.zeros((0, 2), np.int32), np.zeros((0,)),
                np.zeros((0,)), [])
    return (np.concatenate(idx, axis=0).astype(np.int32),
            np.concatenate(psd, axis=0).astype(np.float64),
            np.concatenate(flick, axis=0).astype(np.float64), names)


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M^T v per system as multiply + reduce."""
    return _mv(M.transpose(-1, -2), v)


def _rel_residual(A_re: torch.Tensor, A_im: torch.Tensor,
                  x_re: torch.Tensor, x_im: torch.Tensor,
                  b_re: torch.Tensor, b_im: torch.Tensor,
                  transpose: bool) -> torch.Tensor:
    """Per-system relative residual ||b - A x|| / (||A|| ||x|| + ||b||)
    of the complex system (A^T with ``transpose``), inf-norms over
    max(|re|, |im|) as the JAX pallas tier forms them."""
    if x_re.shape[-1] == 0:  # no unknowns: nothing left over
        return torch.zeros(x_re.shape[:-1], dtype=x_re.dtype,
                           device=x_re.device)
    mv = _mtv if transpose else _mv
    r_re = b_re - (mv(A_re, x_re) - mv(A_im, x_im))
    r_im = b_im - (mv(A_re, x_im) + mv(A_im, x_re))

    def amax(p, q, dims):
        return torch.maximum(p.abs().amax(dim=dims), q.abs().amax(dim=dims))

    scale = (amax(A_re, A_im, (-2, -1)) * amax(x_re, x_im, -1)
             + amax(b_re, b_im, -1)).clamp_min(torch.finfo(A_re.dtype).tiny)
    return amax(r_re, r_im, -1) / scale


def _noise_core(A_re: torch.Tensor, A_im: torch.Tensor, b_re: torch.Tensor,
                b_im: torch.Tensor, e_out: torch.Tensor, method: str
                ) -> tuple[torch.Tensor, ...]:
    """Forward and adjoint solves of the (F, N, N) planes from one inverse
    per system (K4 on the card), then the residual guard: systems above
    ``RESIDUAL_RTOL`` are solved again directly (K1), forward on A and
    adjoint on A^T. Returns (x_re, x_im, z_re, z_im, ok_f, ok_a, number
    of re-solved systems)."""
    M_re, M_im, valid = inverse_planes(A_re, A_im)
    x_re = _mv(M_re, b_re) - _mv(M_im, b_im)
    x_im = _mv(M_im, b_re) + _mv(M_re, b_im)
    e = e_out.expand(b_re.shape)
    e_im = torch.zeros_like(e)
    z_re = _mtv(M_re, e)
    z_im = _mtv(M_im, e)
    bad_f = valid & ~(_rel_residual(A_re, A_im, x_re, x_im, b_re, b_im,
                                    False) <= RESIDUAL_RTOL)
    bad_a = valid & ~(_rel_residual(A_re, A_im, z_re, z_im, e, e_im,
                                    True) <= RESIDUAL_RTOL)
    counts = torch.stack([bad_f.sum(), bad_a.sum()]).cpu()
    ok_f, ok_a = valid, valid
    if int(counts[0]):
        sel = bad_f.nonzero()[:, 0]
        xr, xi, v = solve_planes(A_re[sel], A_im[sel], b_re[sel], b_im[sel],
                                 method=method)
        x_re, x_im = x_re.index_copy(0, sel, xr), x_im.index_copy(0, sel, xi)
        ok_f = ok_f.index_copy(0, sel, v)
    if int(counts[1]):
        sel = bad_a.nonzero()[:, 0]
        zr, zi, v = solve_planes(A_re[sel].transpose(-1, -2),
                                 A_im[sel].transpose(-1, -2), e[sel],
                                 e_im[sel], method=method)
        z_re, z_im = z_re.index_copy(0, sel, zr), z_im.index_copy(0, sel, zi)
        ok_a = ok_a.index_copy(0, sel, v)
    return x_re, x_im, z_re, z_im, ok_f, ok_a, int(counts.sum())


def _noise_schur(A_re: torch.Tensor, A_im: torch.Tensor,
                 b_re: torch.Tensor, b_im: torch.Tensor, e_out: torch.Tensor,
                 plan: dict) -> tuple[torch.Tensor, ...]:
    """The forward and the adjoint solves through the structured tier, as
    the JAX package's ``_noise_core`` runs them under a plan: A x = b and
    A^T z = e_out, both with ``plan``. Returns what ``_noise_core`` does,
    with no re-solved system."""
    x_re, x_im, ok_f = solve_planes(A_re, A_im, b_re, b_im, plan=plan)
    e = e_out.expand(b_re.shape)
    z_re, z_im, ok_a = solve_planes(A_re.transpose(-1, -2),
                                    A_im.transpose(-1, -2), e,
                                    torch.zeros_like(e), plan=plan)
    return x_re, x_im, z_re, z_im, ok_f, ok_a, 0


def noise_system(ckt: ParsedCircuit, tensors: CircuitTensors, op,
                 device: torch.device) -> tuple:
    """The .noise systems at the operating point ``op``, float64 on
    ``device``: (freqs (F,) host, (A_re, A_im, b_re, b_im) shaped
    (F, N, N) and (F, N) with the unit excitation at the input source,
    the adjoint probe e_out (1, N), out_p, out_n)."""
    spec = ckt.noise
    nvar = tensors.nvar

    def node_index(name: str) -> int:
        node_id = ckt.nodes.get(name)
        if node_id is None:
            raise ValueError(f"Unknown node {name} in .noise output spec")
        return nvar if node_id == 0 else node_id - 1

    out_p = node_index(spec.out_pos)
    out_n = node_index(spec.out_neg) if spec.out_neg is not None else nvar
    v_pos, i_pos = find_input_source(tensors, spec.src, ".noise")
    freqs = build_frequency_array(spec.mode, spec.N, spec.f1, spec.f2)
    # small-signal VCCS rows, and the junction capacitances at the op
    # point that shape the transfer (the noise system is op-linearized by
    # definition)
    ss_idx, ss_g, c_idx_eff, c_vals_eff = op_linearized_extras(ckt, tensors,
                                                               op)

    # unit excitation at the input source only (all other sources zeroed)
    v_unit = np.zeros(tensors.n_v)
    i_unit = np.zeros(tensors.n_i)
    if v_pos is not None:
        v_unit[v_pos] = 1.0
    else:
        i_unit[i_pos] = 1.0
    v_idx_ac = tensors.v_idx
    bv = bv_branch_rows(ckt, tensors.nvar)
    if bv.shape[0]:
        v_idx_ac = np.concatenate([tensors.v_idx, bv], axis=0)
        v_unit = np.concatenate([v_unit, np.zeros(bv.shape[0])])
    # adjoint excitation: unit current probe into the output port
    e_pad = np.zeros(nvar + 1)
    e_pad[out_p] += 1.0
    e_pad[out_n] -= 1.0

    f64 = torch.float64

    def vals(a: np.ndarray) -> torch.Tensor:
        # one variant: a leading batch axis of 1
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64,
                               device=device)[None]

    ext = ext_arrays(tensors, device, f64)
    ext["g_idx"] = torch.cat([ext["g_idx"], index_tensor(ss_idx, device)])
    ext["g_gm"] = torch.cat([ext["g_gm"], vals(ss_g)[0]])
    lk = lk_arrays(tensors, device, f64)
    minv = (None if lk is None
            else _mutual_inv(vals(tensors.l_vals), lk)[0])
    planes = _assemble_grid(
        torch.as_tensor(freqs, dtype=f64, device=device),
        index_tensor(tensors.r_idx, device), vals(tensors.r_vals),
        index_tensor(c_idx_eff, device), vals(c_vals_eff),
        index_tensor(tensors.l_idx, device), vals(tensors.l_vals),
        index_tensor(v_idx_ac, device), vals(v_unit),
        vals(np.zeros(v_unit.shape[0])), nvar,
        ext={k: (v if k.endswith("idx") else v[None])
             for k, v in ext.items()},
        i_re=vals(i_unit)[0], i_im=vals(np.zeros(tensors.n_i))[0],
        minv=minv, tl=batched_tl(tl_arrays(tensors, device, f64)))
    return (freqs, tuple(p[0] for p in planes), vals(e_pad[:nvar]), out_p,
            out_n)


def _mutual_ok_np(tensors: CircuitTensors) -> bool:
    """The JAX package's host singularity test of the coupled-inductance
    matrix (``interp._mutual_inv_np``): M = diag(L) + offdiag(k_ab
    sqrt(L_a L_b)) factored by partial-pivot LU; False when a pivot falls
    below EPS (|k| = 1 makes M singular)."""
    lu = np.diag(tensors.l_vals.astype(np.float64))
    a, b = tensors.k_pairs[:, 0], tensors.k_pairs[:, 1]
    m = tensors.k_vals * np.sqrt(tensors.l_vals[a] * tensors.l_vals[b])
    lu[a, b] += m
    lu[b, a] += m
    for k in range(tensors.n_l):
        piv = int(np.argmax(np.abs(lu[k:, k]))) + k
        if not abs(lu[piv, k]) >= EPS:
            return False
        lu[[k, piv]] = lu[[piv, k]]
        f = lu[k + 1:, k] / lu[k, k]
        lu[k + 1:, k + 1:] -= f[:, None] * lu[k, k + 1:]
    return True


def simulate_noise(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    op=None,
    device: torch.device | str | None = None,
) -> NoiseResult | None:
    """Run the `.noise` analysis (None if the netlist has no .noise line)
    in float64 on ``device`` (the card unless ``device="cpu"``). ``op``
    reuses an already-solved operating point (this package's ``OPResult``
    or the JAX package's: only its dicts are read)."""
    device = resolve_device(device)
    if ckt.noise is None:
        return None
    if tensors is None:
        tensors = build_tensors(ckt)
    _check_method(method)
    if tensors.n_k and not _mutual_ok_np(tensors):
        raise ValueError("Singular coupled-inductance matrix in .noise")
    spec = ckt.noise
    nvar = tensors.nvar
    if op is None:
        op = simulate_op(ckt, tensors=tensors, method=method, device=device)
    freqs, planes, e_out, out_p, out_n = noise_system(ckt, tensors, op,
                                                      device)
    F = freqs.shape[0]
    f64 = torch.float64
    # the structured tier (the AC-space plan), dense retry on failure
    plan = plan_for(method, ckt, tensors, nvar, device)
    dense_method = "gj" if method == "schur" else method

    def run(plan_arrays: dict | None) -> tuple[np.ndarray, int]:
        if plan_arrays is None:
            out = _noise_core(*planes, e_out, dense_method)
        else:
            out = _noise_schur(*planes, e_out, plan_arrays)
        x_re, x_im, z_re, z_im, ok_f, ok_a, n_resolved = out
        # one device->host transfer of the packed result
        return torch.cat([x_re, x_im, z_re, z_im, ok_f[:, None].to(f64),
                          ok_a[:, None].to(f64)], dim=1).cpu().numpy(), \
            n_resolved

    packed, n_resolved = run(plan)
    if plan is not None and not bool(np.all(packed[:, -2:] > 0.5)):
        packed, n_resolved = run(None)
    if not bool(np.all(packed[:, -2:] > 0.5)):
        raise ValueError("Singular matrix in .noise solve")
    x = packed[:, :nvar] + 1j * packed[:, nvar:2 * nvar]
    z = packed[:, 2 * nvar:3 * nvar] + 1j * packed[:, 3 * nvar:4 * nvar]
    x_pad = np.concatenate([x, np.zeros((F, 1), np.complex128)], axis=1)
    z_pad = np.concatenate([z, np.zeros((F, 1), np.complex128)], axis=1)

    gain = x_pad[:, out_p] - x_pad[:, out_n]

    g_idx, g_psd, g_flick, g_names = _noise_generators(tensors, op)
    h = z_pad[:, g_idx[:, 0]] - z_pad[:, g_idx[:, 1]]  # (F, nSrc)
    s_gen = g_psd[None, :] + g_flick[None, :] / freqs[:, None]  # (F, nSrc)
    contrib = (np.abs(h) ** 2) * s_gen
    s_out = contrib.sum(axis=1) if g_psd.size else np.zeros(F)

    gain_sq = np.abs(gain) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        s_in = np.where(gain_sq > 0.0, s_out / gain_sq, np.inf)

    contributions: dict[str, np.ndarray] = {}
    for k, name in enumerate(g_names):
        if name in contributions:
            contributions[name] = contributions[name] + contrib[:, k]
        else:
            contributions[name] = contrib[:, k]

    # the trapezoid rule as numpy's trapezoid forms it
    total = (float(np.sqrt((np.diff(freqs) * (s_out[1:] + s_out[:-1])
                            / 2.0).sum())) if F > 1 else 0.0)
    out_spec = format_out_spec(spec.out_pos, spec.out_neg)
    return NoiseResult(
        freqs=freqs, output_psd=s_out, input_psd=s_in, gain=gain,
        contributions=contributions, total_output_rms=total,
        out_spec=out_spec, src_name=spec.src, guard_resolves=n_resolved)
