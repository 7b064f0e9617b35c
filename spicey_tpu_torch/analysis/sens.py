"""DC sensitivity analysis (.sens) — an extension.

The reference has no sensitivity analysis (SURVEY §2.9; `.sens` lines land
in `skipped`). This mirrors ngspice's ``.sens v(out[,ref])``: the
derivative of the DC output voltage with respect to EVERY circuit
parameter, by the classic adjoint (transpose-system) method:

  at the converged operating point, F(x, p) = 0 with Jacobian G, so
  dV_out/dp = -zᵀ · (∂F/∂p)  where  Gᵀ z = e_out   (ONE extra solve
  total, regardless of how many parameters the circuit has).

The G matrix is exactly the op-linearized pencil the `.pz` analysis builds
(analysis/pz.py:_build_pencil — small-signal rows for every nonlinear
device, inductor branches as 0 V shorts); the per-parameter residual
partials ∂F/∂p are closed forms per element family below. Contrast with
`sensitivity_ac`/`sensitivity_tran` (analysis/sensitivity.py), which
differentiate the compiled sweeps by JAX autodiff for *selected* targets
in the JAX package; .sens covers the whole parameter list at DC for the
cost of one solve.

Parameters reported (ngspice's set, adapted to this device set):
  R value; V/I DC level; G/E/F/H gain; diode Is and N; MOSFET beta and
  Vto; JFET model Beta (the 2x lowering scale is undone) and Vto; BJT Is
  and Bf. C and L have zero DC sensitivity and are omitted.

A copy of spicey_tpu/analysis/sens.py. The operating point is the
port's (kernel K2 on the card); the adjoint solve and the partials are
host work, as there. Where the JAX package takes the MOSFET/JFET and BJT
partials by ``jax.jvp``, this takes them by ``torch.func.jvp`` on the
port's own device functions (models/devices.py) over float64 CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import DIODE_VD_MAX, DIODE_VD_MIN, VT_300K
from ..ir.circuit import CircuitTensors, build_tensors
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .ac import _op_voltage_pad, format_out_spec
from .op import simulate_op
from .pz import _build_pencil


@dataclass
class SensResult:
    out_spec: str
    # dV(out)/dp in V per parameter unit, keyed by element (or
    # "element:param") name
    values: dict[str, float]
    # the parameter's own value, for normalization
    params: dict[str, float]

    @property
    def normalized(self) -> dict[str, float]:
        """dV(out) per 1 % parameter change: value * p / 100."""
        return {k: self.values[k] * self.params[k] / 100.0
                for k in self.values}


def _t64(a) -> torch.Tensor:
    """A host array as a float64 CPU tensor."""
    return torch.as_tensor(np.asarray(a, np.float64))


def _jvp(fn, primal: np.ndarray):
    """d fn / d primal along a unit tangent, forward mode, on float64 CPU
    tensors (``jax.jvp`` with a ones tangent in the JAX package); ``fn``
    maps a tensor to a tensor or a tuple of them."""
    from torch.func import jvp

    p = _t64(primal)
    return jvp(fn, (p,), (torch.ones_like(p),))[1]


def simulate_sens(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    op=None,
    device: torch.device | str | None = None,
) -> SensResult | None:
    """Run the `.sens` analysis (None if the netlist has no .sens line);
    its operating point, unless ``op`` gives one, is solved on ``device``
    (the card unless ``device="cpu"``)."""
    if ckt.sens is None:
        return None
    device = resolve_device(device)
    if tensors is None:
        tensors = build_tensors(ckt)
    spec = ckt.sens

    def node_index(name: str) -> int | None:
        node_id = ckt.nodes.get(name)
        if node_id is None:
            raise ValueError(f"Unknown node {name} in .sens output spec")
        return None if node_id == 0 else node_id - 1

    out_p = node_index(spec.out_pos)
    out_n = node_index(spec.out_neg) if spec.out_neg is not None else None

    if op is None:
        op = simulate_op(ckt, tensors=tensors, method=method, device=device)

    G, _C, _b, n_tot = _build_pencil(ckt, tensors, op,
                                     vol_input=False, n1=None, n2=None)
    e = np.zeros(n_tot)
    if out_p is not None:
        e[out_p] += 1.0
    if out_n is not None:
        e[out_n] -= 1.0
    try:
        z = np.linalg.solve(G.T, e)
    except np.linalg.LinAlgError as err:
        raise ValueError(f"Singular matrix in .sens adjoint solve: {err}")
    z_pad = np.concatenate([z, [0.0]])  # dump slot reads 0

    x_pad = _op_voltage_pad(tensors, op)  # node voltages, ground = 0
    values: dict[str, float] = {}
    params: dict[str, float] = {}

    def zd(idx2):
        """z differences across element node pairs (dump-safe)."""
        return z_pad[idx2[:, 0]] - z_pad[idx2[:, 1]]

    def vd_of(idx2):
        return x_pad[idx2[:, 0]] - x_pad[idx2[:, 1]]

    # R: F rows carry ±(v1-v2)/R -> ∂F/∂R = ∓(v1-v2)/R²
    if tensors.n_r:
        v = vd_of(tensors.r_idx)
        s = zd(tensors.r_idx) * v / tensors.r_vals ** 2
        for k, name in enumerate(tensors.r_names):
            values[name] = float(s[k])
            params[name] = float(tensors.r_vals[k])
    # V dc: branch row v1 - v2 - V = 0 -> ∂F_br/∂V = -1 -> sens = z_br
    for k, name in enumerate(tensors.v_names):
        values[name] = float(z_pad[tensors.v_idx[k, 2]])
        params[name] = float(tensors.v_dc[k])
    # I dc: b[i1] -= I, b[i2] += I (F = Ax - b) -> sens = -(z_i1 - z_i2)
    if tensors.n_i:
        s = -zd(tensors.i_idx)
        for k, name in enumerate(tensors.i_names):
            values[name] = float(s[k])
            params[name] = float(tensors.i_dc[k])
    # G gm: rows ±gm*(vc+ - vc-) -> sens = -(z_i1 - z_i2)(vc+ - vc-)
    if tensors.n_g:
        vc = x_pad[tensors.g_idx[:, 2]] - x_pad[tensors.g_idx[:, 3]]
        s = -zd(tensors.g_idx[:, :2]) * vc
        for k, name in enumerate(tensors.g_names):
            values[name] = float(s[k])
            params[name] = float(tensors.g_gm[k])
    # E gain: branch row ... - gain*(vc+ - vc-) -> sens = z_br*(vc+ - vc-)
    if tensors.n_e:
        vc = x_pad[tensors.e_idx[:, 3]] - x_pad[tensors.e_idx[:, 4]]
        for k, name in enumerate(tensors.e_names):
            values[name] = float(z_pad[tensors.e_idx[k, 2]] * vc[k])
            params[name] = float(tensors.e_gain[k])
    # F gain: rows ±gain*i_ctrl -> sens = -(z_i1 - z_i2)*i_ctrl
    if tensors.n_f:
        zdf = -zd(tensors.f_idx[:, :2])
        for k, name in enumerate(tensors.f_names):
            i_ctrl = float(z_ctrl_current(ckt, tensors, op,
                                          int(tensors.f_idx[k, 2])))
            values[name] = float(zdf[k]) * i_ctrl
            params[name] = float(tensors.f_gain[k])
    # H r: branch row ... - r*i_ctrl -> sens = z_br*i_ctrl
    if tensors.n_h:
        for k, name in enumerate(tensors.h_names):
            i_ctrl = float(z_ctrl_current(ckt, tensors, op,
                                          int(tensors.h_idx[k, 3])))
            values[name] = float(z_pad[tensors.h_idx[k, 2]]) * i_ctrl
            params[name] = float(tensors.h_r[k])
    # diode Is, N: i = Is(e^{vd/(N*VT)} - 1) into (p, n)
    if tensors.n_d:
        tscale = tensors.vt / VT_300K
        vd = np.clip(vd_of(tensors.d_idx),
                     DIODE_VD_MIN * tscale, DIODE_VD_MAX * tscale)
        v_th = tensors.d_n * VT_300K
        ev = np.exp(vd / v_th)
        zdd = -zd(tensors.d_idx)
        for k, name in enumerate(tensors.d_names):
            values[f"{name}:is"] = float(zdd[k] * (ev[k] - 1.0))
            params[f"{name}:is"] = float(tensors.d_is[k])
            # ∂i/∂N = -Is*e^{vd/NVT} * vd/(N² VT); d_n folds .temp so
            # report against the model's N = d_n / tscale
            n_model = tensors.d_n[k] / tscale
            di_dn = (-tensors.d_is[k] * ev[k] * vd[k]
                     / (tensors.d_n[k] ** 2 * VT_300K)) * tscale
            values[f"{name}:n"] = float(zdd[k] * di_dn)
            params[f"{name}:n"] = float(n_model)
    # MOSFET/JFET beta & vto, BJT Is & Bf: exact partials by forward-mode
    # AD on the same device functions the engines stamp with
    if tensors.n_m:
        from ..models.devices import mos_level1

        mi = tensors.m_idx
        vgs = _t64(x_pad[mi[:, 1]] - x_pad[mi[:, 2]])
        vds = _t64(x_pad[mi[:, 0]] - x_pad[mi[:, 2]])
        zdm = -zd(mi[:, [0, 2]])
        m_beta, m_vto = _t64(tensors.m_beta), _t64(tensors.m_vto)

        def i_d(beta, vto):
            return mos_level1(vgs, vds, beta, vto, _t64(tensors.m_lambda),
                              _t64(tensors.m_polarity))[3]

        di_dbeta = _jvp(lambda b: i_d(b, m_vto), tensors.m_beta)
        di_dvto = _jvp(lambda v: i_d(m_beta, v), tensors.m_vto)
        scale = tensors.m_beta_scale
        pol = tensors.m_polarity
        for k, name in enumerate(tensors.m_names):
            # J rows: m_beta = scale*Beta and m_vto = pol*Vto — report
            # against the MODEL parameters
            values[f"{name}:beta"] = float(
                zdm[k] * np.asarray(di_dbeta)[k] * scale[k])
            params[f"{name}:beta"] = float(tensors.m_beta[k] / scale[k])
            vto_sign = pol[k] if scale[k] != 1.0 else 1.0
            values[f"{name}:vto"] = float(
                zdm[k] * np.asarray(di_dvto)[k] * vto_sign)
            params[f"{name}:vto"] = float(tensors.m_vto[k] * vto_sign)
    if tensors.n_q:
        from ..models.devices import bjt_ebers_moll

        qi = tensors.q_idx
        vbe = _t64(x_pad[qi[:, 1]] - x_pad[qi[:, 2]])
        vbc = _t64(x_pad[qi[:, 1]] - x_pad[qi[:, 0]])
        z_c, z_b = zd(qi[:, [0, 2]]), zd(qi[:, [1, 2]])
        q_is, q_bf = _t64(tensors.q_is), _t64(tensors.q_bf)

        def currents(i_s, bf):
            out = bjt_ebers_moll(vbe, vbc, i_s, bf, _t64(tensors.q_br),
                                 _t64(tensors.q_polarity), vt=tensors.vt)
            return out[7], out[8]  # i_c, i_b

        dic_dis, dib_dis = _jvp(lambda s: currents(s, q_bf), tensors.q_is)
        dic_dbf, dib_dbf = _jvp(lambda b: currents(q_is, b), tensors.q_bf)
        for k, name in enumerate(tensors.q_names):
            values[f"{name}:is"] = float(
                -(z_c[k] * np.asarray(dic_dis)[k]
                  + z_b[k] * np.asarray(dib_dis)[k]))
            params[f"{name}:is"] = float(tensors.q_is[k])
            values[f"{name}:bf"] = float(
                -(z_c[k] * np.asarray(dic_dbf)[k]
                  + z_b[k] * np.asarray(dib_dbf)[k]))
            params[f"{name}:bf"] = float(tensors.q_bf[k])

    return SensResult(
        out_spec=format_out_spec(spec.out_pos, spec.out_neg),
        values=values, params=params)


def z_ctrl_current(ckt, tensors, op, branch: int) -> float:
    """DC current of the V source whose MNA branch index is ``branch``
    (F/H controlling currents are branch unknowns; the op result records
    them as the source's element current)."""
    for k in range(tensors.n_v):
        if int(tensors.v_idx[k, 2]) == branch:
            return op.element_currents[tensors.v_names[k]]
    raise ValueError(f"no V source on branch {branch}")


def format_sens_result(res: SensResult) -> str:
    """ngspice-flavored sensitivity table."""
    lines = [f"dc sensitivities of {res.out_spec}",
             f"{'parameter':<16}{'value':>14}{'dV/dp':>16}"
             f"{'dV per 1%':>16}"]
    norm = res.normalized
    for name in res.values:
        lines.append(f"{name:<16}{res.params[name]:>14.6g}"
                     f"{res.values[name]:>16.6g}{norm[name]:>16.6g}")
    return "\n".join(lines) + "\n"
