"""DC small-signal transfer function (.tf) on torch tensors.

Contract: spicey_tpu/analysis/tf.py, an extension mirroring ngspice's
``.tf v(out[,ref]) <src>``: solve the DC operating point, linearize every
nonlinear device there, and report

  - ``transfer_function``  dV(out)/d(input)  (V/V for a V-source input,
    V/A for an I-source input),
  - ``input_impedance``    resistance seen by the input source,
  - ``output_impedance``   resistance seen looking into the output port.

The linearized conductance matrix is assembled on the host in NumPy in the
``.op`` unknown ordering (op.py), as the JAX package assembles it; both
right-hand sides, the unit input excitation and the unit output current
probe, go to the device in ONE batched real solve (kernel K2 on the card).
B sources linearize at the operating point, I-kind as VCCS rows, V-kind
as their branch row with the gradient couplings (the Newton loop's
decomposition; ``bexpr_partials`` on float64 CPU tensors). The structured
tier (ops/schur.py) takes the op-space plan as the JAX package does:
forced by ``method="schur"``, taken by ``method="gj"`` past 128 op
unknowns on a subcircuit board, both right-hand sides retried dense when a
block pivot fails.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS
from ..ir.circuit import CircuitTensors, build_tensors
from ..ops.linsolve import solve
from ..ops.schur import plan_for
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from .ac import (bsource_gradients, find_input_source, format_out_spec,
                 small_signal_rows)
from .op import _op_indices, simulate_op


@dataclass
class TFResult:
    transfer_function: float
    input_impedance: float
    output_impedance: float
    out_spec: str
    src_name: str


def _node_matrix_index(ckt: ParsedCircuit, name: str, dump: int) -> int:
    node_id = ckt.nodes.get(name)
    if node_id is None:
        raise ValueError(f"Unknown node {name} in .tf output spec")
    return dump if node_id == 0 else node_id - 1


def simulate_tf(
    ckt: ParsedCircuit,
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    op=None,
    device: torch.device | str | None = None,
) -> TFResult | None:
    """Run the `.tf` analysis (None if the netlist has no .tf line) on
    ``device`` (the card unless ``device="cpu"``). ``op`` reuses an
    already-solved operating point (this package's ``OPResult`` or the JAX
    package's: only its dicts of floats are read)."""
    device = resolve_device(device)
    if ckt.tf is None:
        return None
    if tensors is None:
        tensors = build_tensors(ckt)

    spec = ckt.tf
    if op is None:
        op = simulate_op(ckt, tensors=tensors, method=method, device=device)
    nvar_op, remap, l_bidx, v_idx_op = _op_indices(tensors)
    dump = nvar_op

    out_p = _node_matrix_index(ckt, spec.out_pos, dump)
    out_n = (_node_matrix_index(ckt, spec.out_neg, dump)
             if spec.out_neg is not None else dump)

    # a V source (branch excitation) or an extended-dialect I source
    # (nodal injection)
    v_pos, i_pos = find_input_source(tensors, spec.src, ".tf")

    # the linearized DC conductance matrix at the operating point, on the
    # host: its operands are host data and it is one small matrix
    A = np.zeros((nvar_op + 1, nvar_op + 1))

    def adm(idx, y):
        np.add.at(A, (idx[:, 0], idx[:, 0]), y)
        np.add.at(A, (idx[:, 1], idx[:, 1]), y)
        np.add.at(A, (idx[:, 0], idx[:, 1]), -y)
        np.add.at(A, (idx[:, 1], idx[:, 0]), -y)

    def vrows(idx):
        # voltage-source ±1 node/branch couplings (0 V small-signal)
        one = np.ones(idx.shape[0])
        np.add.at(A, (idx[:, 0], idx[:, 2]), one)
        np.add.at(A, (idx[:, 2], idx[:, 0]), one)
        np.add.at(A, (idx[:, 1], idx[:, 2]), -one)
        np.add.at(A, (idx[:, 2], idx[:, 1]), -one)

    def vccs(idx, gm):
        np.add.at(A, (idx[:, 0], idx[:, 2]), gm)
        np.add.at(A, (idx[:, 0], idx[:, 3]), -gm)
        np.add.at(A, (idx[:, 1], idx[:, 2]), -gm)
        np.add.at(A, (idx[:, 1], idx[:, 3]), gm)

    adm(remap(tensors.r_idx), 1.0 / tensors.r_vals)
    # V sources and L shorts contribute their branch rows with 0 V: all
    # independent sources are zeroed for small-signal solves
    vrows(l_bidx)
    vrows(v_idx_op)
    # linear extended controlled sources (G/E/F/H)
    if tensors.n_g:
        vccs(remap(tensors.g_idx), tensors.g_gm)
    if tensors.n_e:
        ei = remap(tensors.e_idx)
        vrows(ei[:, :3])
        np.add.at(A, (ei[:, 2], ei[:, 3]), -tensors.e_gain)
        np.add.at(A, (ei[:, 2], ei[:, 4]), tensors.e_gain)
    if tensors.n_f:
        fi = remap(tensors.f_idx)
        np.add.at(A, (fi[:, 0], fi[:, 2]), tensors.f_gain)
        np.add.at(A, (fi[:, 1], fi[:, 2]), -tensors.f_gain)
    if tensors.n_h:
        hi = remap(tensors.h_idx)
        vrows(hi[:, :3])
        np.add.at(A, (hi[:, 2], hi[:, 3]), -tensors.h_r)
    # nonlinear devices (diode/switch/MOSFET/BJT) as small-signal VCCS
    ss_idx, ss_g = small_signal_rows(tensors, op)
    vccs(remap(ss_idx), ss_g)
    if ckt.B:
        # behavioral sources at the operating point, the Newton loop's
        # decomposition: I-kind as VCCS rows, V-kind as their branch row
        # with the gradient couplings
        for kind, i1, i2, br, refs, gs in bsource_gradients(
                ckt, tensors, op, nvar_op):
            if kind == "i":
                for (a, b2), g in zip(refs, gs):
                    vccs(np.asarray([[i1, i2, a, b2]]), np.asarray([g]))
            else:
                A[i1, br] += 1.0
                A[i2, br] -= 1.0
                A[br, i1] += 1.0
                A[br, i2] -= 1.0
                for (a, b2), g in zip(refs, gs):
                    A[br, a] -= g
                    A[br, b2] += g
    A = A[:nvar_op, :nvar_op]

    # RHS 1: unit input excitation (all other sources stay zeroed)
    b_in = np.zeros(nvar_op + 1)
    if v_pos is not None:
        in_branch = int(tensors.v_idx[v_pos, 2])
        b_in[in_branch] = 1.0
    else:
        i1, i2 = (int(x) for x in remap(tensors.i_idx)[i_pos])
        b_in[i1] -= 1.0
        b_in[i2] += 1.0
    # RHS 2: unit current probe into the output port
    b_out = np.zeros(nvar_op + 1)
    b_out[out_p] += 1.0
    b_out[out_n] -= 1.0
    rhs = np.stack([b_in[:nvar_op], b_out[:nvar_op]])

    f64 = torch.float64
    A_t = torch.as_tensor(A, dtype=f64, device=device)
    # the structured tier: the op-linearized system lives in op space
    # (nodes + branches + L shorts), so the op plan applies
    plan = plan_for(method, ckt, tensors, nvar_op, device, op=True)

    def tf_solve(plan_arrays: dict | None) -> np.ndarray:
        x, ok = solve(A_t.expand((2,) + A.shape),
                      torch.as_tensor(rhs, dtype=f64, device=device),
                      method="gj" if method == "schur" else method,
                      plan=plan_arrays)
        # one device->host transfer of [x | ok]
        return torch.cat([x, ok[:, None].to(f64)], dim=1).cpu().numpy()

    packed = tf_solve(plan)
    if plan is not None and not bool(np.all(packed[:, -1] > 0.5)):
        packed = tf_solve(None)
    if not bool(np.all(packed[:, -1] > 0.5)):
        raise ValueError("Singular matrix in .tf small-signal solve")
    x_pad = np.concatenate([packed[:, :nvar_op], np.zeros((2, 1))], axis=1)

    gain = float(x_pad[0, out_p] - x_pad[0, out_n])
    if v_pos is not None:
        # recorded branch current flows INTO the + terminal; the circuit
        # draws -i_branch from a 1 V excitation
        i_branch = x_pad[0, in_branch]
        r_in = float("inf") if abs(i_branch) < EPS else float(-1.0 / i_branch)
    else:
        i1, i2 = (int(v) for v in remap(tensors.i_idx)[i_pos])
        r_in = float(x_pad[0, i2] - x_pad[0, i1])
    r_out = float(x_pad[1, out_p] - x_pad[1, out_n])

    out_spec = format_out_spec(spec.out_pos, spec.out_neg)
    return TFResult(transfer_function=gain, input_impedance=r_in,
                    output_impedance=r_out, out_spec=out_spec,
                    src_name=spec.src)
