"""Vectorized MNA stamp assembly on torch tensors.

The reference's stamp functions (spicey/lib/stamping/*.ts) are per-element
scatter-adds with ground guards. Here each becomes ONE batched
``index_add_`` over all elements of a device type, into a padded
(nvar+1)-sized system whose last row/column is a dump slot for ground (see
ir/circuit.py); contributions to the dump row/column are sliced off by the
callers. Duplicate indices accumulate, as scatter-add semantics require.

Every function updates ``A_pad``/``b_pad`` IN PLACE (a batched system is
the largest tensor of an assembly; building it once saves a copy per
stamp) and returns it for chaining. ``A_pad`` is (..., n+1, n+1) and
``b_pad`` (..., n+1); values broadcast against the leading batch dims and
end in the element axis.

Patterns:
  - admittance (4-point ±Y): stampAdmittance{Real,Complex}.ts:10-29
  - RHS current injection:   stampCurrent{Real,Complex}.ts:10-14
  - voltage-source rows (±1 couplings + RHS voltage):
                             stampVoltageSource{Real,Complex}.ts:11-34
"""

from __future__ import annotations

import torch


def _source(y: torch.Tensor | float, like: torch.Tensor) -> torch.Tensor:
    """``y`` as a tensor of ``like``'s dtype and device. A Python constant
    becomes a fill on the device: ``torch.as_tensor`` of a float copies it
    from pageable host memory, a stream sync per stamp on the card."""
    if isinstance(y, torch.Tensor):
        return y.to(like.dtype)
    return torch.full((), y, dtype=like.dtype, device=like.device)


def _add(A_pad: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
         y: torch.Tensor | float) -> torch.Tensor:
    """A_pad[..., i[e], j[e]] += y[..., e] for every element e."""
    if i.shape[0] == 0:  # no element of this kind: no launch
        return A_pad
    n1 = A_pad.shape[-1]
    lead = A_pad.shape[:-2]
    flat = A_pad.view(*lead, n1 * n1)
    src = _source(y, A_pad).expand(*lead, i.shape[0])
    flat.index_add_(-1, i * n1 + j, src)
    return A_pad


def _add_vec(b_pad: torch.Tensor, i: torch.Tensor,
             y: torch.Tensor | float) -> torch.Tensor:
    """b_pad[..., i[e]] += y[..., e] for every element e."""
    if i.shape[0] == 0:
        return b_pad
    b_pad.index_add_(-1, i, _source(y, b_pad).expand(*b_pad.shape[:-1],
                                                      i.shape[0]))
    return b_pad


def pad_solution(x: torch.Tensor, nvar: int) -> torch.Tensor:
    """Append the ground slot (0) at index ``nvar``: (..., nvar) ->
    (..., nvar+1), so index arrays holding the dump slot gather 0."""
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)


def stamp_admittance(A_pad: torch.Tensor, idx: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Scatter ±y for each 2-terminal element. idx: (nE, 2); y: (..., nE)."""
    i1, i2 = idx[:, 0], idx[:, 1]
    _add(A_pad, i1, i1, y)
    _add(A_pad, i2, i2, y)
    _add(A_pad, i1, i2, -y)
    _add(A_pad, i2, i1, -y)
    return A_pad


def stamp_current(b_pad: torch.Tensor, idx: torch.Tensor,
                  current: torch.Tensor) -> torch.Tensor:
    """RHS injection: b[i1] -= I, b[i2] += I. Batch dims broadcast."""
    _add_vec(b_pad, idx[:, 0], -current)
    _add_vec(b_pad, idx[:, 1], current)
    return b_pad


def stamp_voltage_source(A_pad: torch.Tensor, b_pad: torch.Tensor,
                         v_idx: torch.Tensor, volts: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """±1 node/branch couplings and branch-row RHS voltage.

    v_idx: (nV, 3) = [i1, i2, branch]; volts: (..., nV).
    """
    i1, i2, j = v_idx[:, 0], v_idx[:, 1], v_idx[:, 2]
    _add(A_pad, i1, j, 1.0)
    _add(A_pad, j, i1, 1.0)
    _add(A_pad, i2, j, -1.0)
    _add(A_pad, j, i2, -1.0)
    _add_vec(b_pad, j, volts)
    return A_pad, b_pad


def stamp_vccs(A_pad: torch.Tensor, idx: torch.Tensor,
               gm: torch.Tensor) -> torch.Tensor:
    """Voltage-controlled current source (extended dialect).

    idx: (nG, 4) = [i1, i2, ic_pos, ic_neg]; gm: (..., nG). Injects
    gm*(v(ic+)-v(ic-)) out of i1's KCL row into i2's.
    """
    i1, i2, icp, icn = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    _add(A_pad, i1, icp, gm)
    _add(A_pad, i1, icn, -gm)
    _add(A_pad, i2, icp, -gm)
    _add(A_pad, i2, icn, gm)
    return A_pad


def stamp_vcvs(A_pad: torch.Tensor, idx: torch.Tensor,
               gain: torch.Tensor) -> torch.Tensor:
    """Voltage-controlled voltage source (extended dialect).

    idx: (nE, 5) = [i1, i2, branch, ic_pos, ic_neg]; gain: (..., nE). The
    branch row enforces v(i1) - v(i2) - gain*(v(ic+) - v(ic-)) = 0.
    """
    i1, i2, j = idx[:, 0], idx[:, 1], idx[:, 2]
    icp, icn = idx[:, 3], idx[:, 4]
    _add(A_pad, i1, j, 1.0)
    _add(A_pad, i2, j, -1.0)
    _add(A_pad, j, i1, 1.0)
    _add(A_pad, j, i2, -1.0)
    _add(A_pad, j, icp, -gain)
    _add(A_pad, j, icn, gain)
    return A_pad


def stamp_cccs(A_pad: torch.Tensor, idx: torch.Tensor,
               gain: torch.Tensor) -> torch.Tensor:
    """Current-controlled current source (extended dialect).

    idx: (nF, 3) = [i1, i2, ctrl_branch]; gain: (..., nF):
    i(F) = gain * x[ctrl_branch], flowing i1 -> i2 through the source.
    """
    i1, i2, jv = idx[:, 0], idx[:, 1], idx[:, 2]
    _add(A_pad, i1, jv, gain)
    _add(A_pad, i2, jv, -gain)
    return A_pad


def stamp_ccvs(A_pad: torch.Tensor, idx: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """Current-controlled voltage source (extended dialect).

    idx: (nH, 4) = [i1, i2, branch, ctrl_branch]; r: (..., nH). The branch
    row enforces v(i1) - v(i2) - r * x[ctrl_branch] = 0.
    """
    i1, i2, j, jv = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    _add(A_pad, i1, j, 1.0)
    _add(A_pad, i2, j, -1.0)
    _add(A_pad, j, i1, 1.0)
    _add(A_pad, j, i2, -1.0)
    _add(A_pad, j, jv, -r)
    return A_pad


def stamp_mutual(A_pad: torch.Tensor, l_idx: torch.Tensor,
                 G: torch.Tensor) -> torch.Tensor:
    """Coupled-inductor companion matrix stamp (extended K lines).

    The current of inductor a is sum_b G[a,b] * (v[i1_b] - v[i2_b]), so
    every (a, b) pair contributes the 4-point pattern across a's KCL rows
    and b's voltage columns. G: (..., nL, nL), its pairs flattened row
    by row into the element axis."""
    n_l = l_idx.shape[0]
    i1, i2 = l_idx[:, 0], l_idx[:, 1]
    rows1, cols1 = i1.repeat_interleave(n_l), i1.repeat(n_l)
    rows2, cols2 = i2.repeat_interleave(n_l), i2.repeat(n_l)
    g = G.reshape(G.shape[:-2] + (n_l * n_l,))
    _add(A_pad, rows1, cols1, g)
    _add(A_pad, rows1, cols2, -g)
    _add(A_pad, rows2, cols1, -g)
    _add(A_pad, rows2, cols2, g)
    return A_pad


def stamp_tline_ports(A_pad: torch.Tensor, t_idx: torch.Tensor,
                      z0: torch.Tensor) -> torch.Tensor:
    """Transmission-line near-end pattern (Branin model; extended T lines).

    t_idx: (nT, 6) = [i1, i2, i3, i4, br1, br2]; z0: (..., nT). Each port's
    branch row enforces v(+) - v(-) - Z0*i_port = E(t) (the delayed far-end
    Thevenin source lands in the RHS), and the port currents enter the node
    KCL rows. This is the whole matrix contribution in the transient: the
    far-end coupling is history, not topology."""
    i1, i2, i3, i4 = t_idx[:, 0], t_idx[:, 1], t_idx[:, 2], t_idx[:, 3]
    b1, b2 = t_idx[:, 4], t_idx[:, 5]
    for (p, q, br) in ((i1, i2, b1), (i3, i4, b2)):
        _add(A_pad, p, br, 1.0)
        _add(A_pad, q, br, -1.0)
        _add(A_pad, br, p, 1.0)
        _add(A_pad, br, q, -1.0)
        _add(A_pad, br, br, -z0)
    return A_pad


def stamp_tline_coupling(A_pad: torch.Tensor, t_idx: torch.Tensor,
                         z0: torch.Tensor, c: torch.Tensor
                         ) -> torch.Tensor:
    """Far-end coupling rows with coefficient ``c`` (..., nT) per plane.

    Branch row br1 gains ``c`` times (v(i3) - v(i4) + Z0*i2) and br2 the
    mirror; in AC ``c = -e^{-j w Td}`` split into its real and imaginary
    planes, at DC ``c = -1`` (the theta -> 0 steady state: a differential
    short, the classic SPICE T-element DC behaviour)."""
    i1, i2, i3, i4 = t_idx[:, 0], t_idx[:, 1], t_idx[:, 2], t_idx[:, 3]
    b1, b2 = t_idx[:, 4], t_idx[:, 5]
    for (br, p, q, obr) in ((b1, i3, i4, b2), (b2, i1, i2, b1)):
        _add(A_pad, br, p, c)
        _add(A_pad, br, q, -c)
        _add(A_pad, br, obr, c * z0)
    return A_pad


def stamp_extended(A_pad: torch.Tensor, ext: dict) -> torch.Tensor:
    """All linear extended-dialect controlled sources from an ext dict
    (ir.circuit.ext_arrays): G/E/F/H. Independent I sources are RHS-only
    and handled by the callers."""
    stamp_vccs(A_pad, ext["g_idx"], ext["g_gm"])
    stamp_vcvs(A_pad, ext["e_idx"], ext["e_gain"])
    stamp_cccs(A_pad, ext["f_idx"], ext["f_gain"])
    stamp_ccvs(A_pad, ext["h_idx"], ext["h_r"])
    return A_pad
