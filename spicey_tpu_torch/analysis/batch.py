"""Batched corner sweeps: every parameter variant of one topology at once.

Contract: spicey_tpu/analysis/batch.py. The reference simulates one
netlist per call; here thousands of parameter variants of one topology
solve in one call, with a leading variants axis on the element values.

API:
  overrides = {"r1": values_B, "c1": values_B, "v1": dc_values_B, ...}
  simulate_ac_batch(netlist_or_ckt, overrides)   -> BatchACResult
  simulate_tran_batch(netlist_or_ckt, overrides) -> BatchTranResult

Element names match case-insensitively. Voltage- and current-source
overrides set the DC value (the whole time grid of a source without a
waveform); overriding a waveform-driven source raises. A K element's name
sweeps its coupling coefficient, and a T line's two parameters take
suffixed keys: ``"t1.z0"`` sweeps its characteristic impedance, ``"t1.td"``
its delay (the transient's history then covers the longest swept delay).

Routes on a CUDA tensor, each solve a kernel launch (their plain versions
on a CPU tensor), all in float64:
  - AC, ``method="pallas"``, N <= 16, no K coupling or T line: the fused
    full-solution kernel K7 (ops/mc_ac_fused.py), which builds and solves
    every (variant, frequency) system on chip, so the (B*F, N, N+1)
    planes never exist in device memory; every other AC deck assembles
    the planes in torch and solves them with K1
    (``analysis/ac._ac_sweep_core``; a K deck's M^{-1} per variant by
    K3);
  - the transient: the batched time loop of analysis/tran.py with a
    (B,) lead, K2 every Newton pass, or K3 once for a linear deck (K and
    T decks included; a B deck iterates Newton to convergence).
  - a linear BE transient where ``timeparallel.worthwhile`` says the regime
    fits (``time_parallel="auto"``): full trajectories from the
    parallel-in-time core (``mc._tp_solutions``, one K3 inverse per
    variant, the time axis in O(log S) depth).
V-kind B sources stamp as 0 V shorts in AC, as the JAX package's batch AC
does. As in the JAX package, neither batch entry point plans a Schur
partition: ``method="schur"`` names the dense elimination here. The JAX
package's ``interpret`` has no counterpart. Entry points run on the card
unless ``device="cpu"``.

``device_put=sharder(mesh)`` (parallel/mesh.py) splits the variants over
the mesh's "batch" axis and, in AC, the frequencies over its "freq" axis:
each (variants x frequencies) block runs the route above on its device,
and the full solutions gather on the mesh's first device before their
one copy to the host.

The helpers tile netlist values to the variants axis for these analyses
and for the Monte-Carlo statistics (analysis/mc.py) and ``op_batch``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ir.circuit import (CircuitTensors, build_tensors, bv_branch_rows,
                          effective_time_step, ext_arrays, nl_arrays,
                          sample_source_values, tl_arrays)
from ..ops.mc_ac_fused import (FUSED_MAX_N, PackedPattern,
                               build_stamp_pattern, combine_values,
                               mc_ac_fused_x, pack_pattern)
from ..parallel.mesh import VARIANTS, map_blocks
from ..parsing.netlist import ParsedCircuit, parse_netlist
from ..utils.device import resolve_device
from .ac import _ac_sweep_core, build_frequency_array, index_tensor
from .timeparallel import eligible as tp_eligible
from .timeparallel import worthwhile as tp_worthwhile
from .tran import _tran_core, tran_arrays, vt_scale_of


@dataclass
class BatchACResult:
    freqs: np.ndarray          # (F,)
    node_names: tuple[str, ...]
    x: np.ndarray              # (B, F, nvar) complex128 solution
    valid: np.ndarray          # (B, F) bool

    def node_voltage(self, name: str) -> np.ndarray:
        i = [n.upper() for n in self.node_names].index(name.upper())
        return self.x[..., i]


@dataclass
class BatchTranResult:
    times: np.ndarray          # (S+1,)
    node_names: tuple[str, ...]
    xs: np.ndarray             # (B, S+1, nvar)
    sw_states: np.ndarray      # (B, S+1, nS)
    valid: np.ndarray          # (B,)

    def node_voltage(self, name: str) -> np.ndarray:
        i = [n.upper() for n in self.node_names].index(name.upper())
        return self.xs[..., i]


def _resolve(ckt: ParsedCircuit | str,
             dialect: str = "spicey") -> ParsedCircuit:
    return parse_netlist(ckt, dialect=dialect) if isinstance(ckt, str) else ckt


def _batch_values(base: np.ndarray, names: tuple[str, ...],
                  overrides: dict[str, np.ndarray], B: int) -> np.ndarray:
    """Tile (nE,) base values to (B, nE), applying per-element overrides."""
    out = np.broadcast_to(base, (B,) + base.shape).copy()
    lower = {n.lower(): i for i, n in enumerate(names)}
    for key, vals in overrides.items():
        idx = lower.get(key.lower())
        if idx is None:
            continue
        vals = np.asarray(vals, dtype=np.float64)
        if vals.shape != (B,):
            raise ValueError(
                f"override for {key!r} must have shape ({B},), got {vals.shape}"
            )
        out[:, idx] = vals
    return out


def _batched_ext(tensors: CircuitTensors, overrides, B: int,
                 device: torch.device | str, dtype: torch.dtype) -> dict:
    """ext dict with value arrays tiled to (B, nX) + overrides applied."""
    ext = ext_arrays(tensors, device, dtype)
    for key, base, names in (("g_gm", tensors.g_gm, tensors.g_names),
                             ("e_gain", tensors.e_gain, tensors.e_names),
                             ("f_gain", tensors.f_gain, tensors.f_names),
                             ("h_r", tensors.h_r, tensors.h_names)):
        ext[key] = torch.as_tensor(
            _batch_values(base, names, overrides, B), dtype=dtype,
            device=device)
    return ext


def _batched_nl(tensors: CircuitTensors, overrides, B: int,
                device: torch.device | str, dtype: torch.dtype) -> dict:
    """nl dict with per-device betas and Is tiled to (B, nX): overriding an
    M name sweeps its beta, a J name its model Beta (the stored channel
    value is 2x the model's; ``m_beta_scale`` undoes the lowering, so
    user values stay in model units), a Q name its Is. The products are
    formed in float64 and rounded once to ``dtype``."""
    nl = nl_arrays(tensors, device, dtype)
    scale = tensors.m_beta_scale
    nl["m_beta"] = torch.as_tensor(
        _batch_values(tensors.m_beta / scale, tensors.m_names, overrides, B)
        * scale, dtype=dtype, device=device)
    nl["q_is"] = torch.as_tensor(
        _batch_values(tensors.q_is, tensors.q_names, overrides, B),
        dtype=dtype, device=device)
    return nl


def _batched_lk(tensors: CircuitTensors, overrides, B: int,
                device: torch.device | str, dtype: torch.dtype
                ) -> dict | None:
    """The couplings with their coefficients tiled to (B, nK) + overrides
    applied (a K element's name sweeps its coefficient), or None when the
    deck has none."""
    if tensors.n_k == 0:
        return None
    return {"k_pairs": torch.as_tensor(np.asarray(tensors.k_pairs, np.int64),
                                       device=device),
            "k_vals": torch.as_tensor(
                _batch_values(tensors.k_vals, tensors.k_names, overrides, B),
                dtype=dtype, device=device)}


def _batched_tl(tensors: CircuitTensors, overrides, B: int,
                device: torch.device | str, dtype: torch.dtype
                ) -> dict | None:
    """The T lines with Z0 and Td tiled to (B, nT) + overrides applied
    (keys ``"<name>.z0"`` and ``"<name>.td"``), or None when the deck has
    none."""
    if tensors.n_t == 0:
        return None
    tl = tl_arrays(tensors, device, dtype)
    for key, base in (("z0", tensors.t_z0), ("td", tensors.t_td)):
        tl[key] = torch.as_tensor(_batch_values(
            base, tuple(f"{n}.{key}" for n in tensors.t_names), overrides,
            B), dtype=dtype, device=device)
    return tl


def _tl_names(tensors: CircuitTensors) -> tuple[str, ...]:
    """The override keys of the T lines' parameters (suffixed)."""
    return tuple(f"{n}.{p}" for n in tensors.t_names for p in ("z0", "td"))


def _batch_size(overrides: dict[str, np.ndarray]) -> int:
    sizes = {np.asarray(v).shape[0] for v in overrides.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent override batch sizes: {sizes}")
    return sizes.pop()


def _consumed(names_groups, overrides) -> set[str]:
    known = set()
    for names in names_groups:
        known.update(n.lower() for n in names)
    unknown = {k for k in overrides if k.lower() not in known}
    if unknown:
        raise ValueError(f"overrides reference unknown elements: {sorted(unknown)}")
    return known


def _v_idx_ac(ckt, tensors):
    """v_idx with V-kind behavioral branch rows appended as 0 V shorts
    (the batch AC policy for B sources)."""
    bv = bv_branch_rows(ckt, tensors.nvar)
    if bv.shape[0] == 0:
        return tensors.v_idx
    return np.concatenate([tensors.v_idx, bv], axis=0)


def _pad_v_phasors(ckt, v_re: torch.Tensor, v_im: torch.Tensor):
    """Zero-pad AC drive phasors for the appended behavioral branch rows."""
    n_bv = sum(1 for b in ckt.B if b.kind == "v")
    if n_bv == 0:
        return v_re, v_im
    z = v_re.new_zeros(v_re.shape[:-1] + (n_bv,))
    return torch.cat([v_re, z], dim=-1), torch.cat([v_im, z], dim=-1)


def _fused_pattern(ckt: ParsedCircuit, tensors, method: str,
                   device: torch.device | str) -> PackedPattern | None:
    """Packed stamp pattern for the fused assemble+solve tier (K5, K7), or
    None when ineligible (the JAX package's conditions, mc.py:617):
    non-pallas methods, K coupling or T lines (the kernels know no
    coupled inductance and no line), or N past FUSED_MAX_N. Both
    precisions qualify."""
    if (method != "pallas" or tensors.n_k or tensors.n_t
            or not 0 < tensors.nvar <= FUSED_MAX_N):
        return None
    ext_idx = {"i_idx": tensors.i_idx, "g_idx": tensors.g_idx,
               "e_idx": tensors.e_idx, "f_idx": tensors.f_idx,
               "h_idx": tensors.h_idx}
    pattern = build_stamp_pattern(
        tensors.nvar, tensors.r_idx, tensors.c_idx, tensors.l_idx,
        _v_idx_ac(ckt, tensors), ext_idx)
    return pack_pattern(pattern, tensors.nvar, device)


def _ac_block(freqs: torch.Tensor, idx: dict, r_vals: torch.Tensor,
              c_vals: torch.Tensor, l_vals: torch.Tensor, v_re: torch.Tensor,
              v_im: torch.Tensor, ext: dict, i_re: torch.Tensor,
              i_im: torch.Tensor, pattern: PackedPattern | None,
              lk: dict | None, tl: dict | None, nvar: int, method: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full solutions x (B, F, nvar) complex and ``valid`` (B, F) of
    the variants' values at ``freqs``: K7 with a fused ``pattern``, else
    the planes through ``_ac_sweep_core`` (K1)."""
    if pattern is not None:
        values = combine_values(r_vals, c_vals, l_vals, v_re, v_im, ext=ext,
                                i_re=i_re, i_im=i_im, dtype=r_vals.dtype)
        xr, xi, valid = mc_ac_fused_x(freqs, values, pattern)
        # (F, N, B) -> (B, F, N), permuted once on the device
        return torch.complex(xr, xi).permute(2, 0, 1), valid.T
    x_re, x_im, valid = _ac_sweep_core(
        freqs, idx["r"], r_vals, idx["c"], c_vals, idx["l"], l_vals,
        idx["v"], v_re, v_im, nvar, method=method, ext=ext, i_re=i_re,
        i_im=i_im, lk=lk, tl=tl)
    return torch.complex(x_re, x_im), valid


def simulate_ac_batch(
    circuit: ParsedCircuit | str,
    overrides: dict[str, np.ndarray],
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    dialect: str = "spicey",
    device: torch.device | str | None = None,
    device_put=None,
) -> BatchACResult:
    """One batched AC sweep over all parameter variants, in float64 on
    ``device`` (the card unless ``device="cpu"``): the full (B, F, nvar)
    solution of every variant at every frequency. ``method="pallas"``
    takes K7 where the circuit qualifies (N <= 16), ``"gj"`` always
    assembles the planes and solves them with K1.

    ``device_put``: a ``sharder(mesh)`` callable that shards the variants
    over the mesh's "batch" axis and the frequencies over its "freq"
    axis; each block takes the route above, and the solutions gather on
    the mesh's first device (``device=None`` means it; another device
    raises ``ValueError``)."""
    device = resolve_device(device, device_put)
    ckt = _resolve(circuit, dialect=dialect)
    if ckt.ac is None:
        raise ValueError("netlist has no .ac analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    B = _batch_size(overrides)
    _consumed([tensors.r_names, tensors.c_names, tensors.l_names,
               tensors.k_names, _tl_names(tensors),
               tensors.v_names, tensors.i_names, tensors.g_names,
               tensors.e_names, tensors.f_names, tensors.h_names], overrides)
    r_vals = _batch_values(tensors.r_vals, tensors.r_names, overrides, B)
    c_vals = _batch_values(tensors.c_vals, tensors.c_names, overrides, B)
    l_vals = _batch_values(tensors.l_vals, tensors.l_names, overrides, B)
    if np.any(r_vals <= 0):
        bad = tensors.r_names[int(np.argwhere(r_vals <= 0)[0][1])]
        raise ValueError(f"R {bad} must be > 0")
    f64 = torch.float64

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=f64, device=device)

    ext = _batched_ext(tensors, overrides, B, device, f64)
    freqs = build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2)
    ph = tensors.v_ac_phase_deg * math.pi / 180.0
    v_re, v_im = _pad_v_phasors(
        ckt, dev(tensors.v_ac_mag * np.cos(ph)).expand(B, tensors.n_v),
        dev(tensors.v_ac_mag * np.sin(ph)).expand(B, tensors.n_v))
    iph = tensors.i_ac_phase_deg * math.pi / 180.0
    i_re = dev(tensors.i_ac_mag * np.cos(iph))
    i_im = dev(tensors.i_ac_mag * np.sin(iph))
    args = dict(
        freqs=dev(freqs),
        idx={"r": index_tensor(tensors.r_idx, device),
             "c": index_tensor(tensors.c_idx, device),
             "l": index_tensor(tensors.l_idx, device),
             "v": index_tensor(_v_idx_ac(ckt, tensors), device)},
        r_vals=dev(r_vals), c_vals=dev(c_vals), l_vals=dev(l_vals),
        v_re=v_re, v_im=v_im, ext=ext, i_re=i_re, i_im=i_im,
        pattern=_fused_pattern(ckt, tensors, method, device),
        lk=_batched_lk(tensors, overrides, B, device, f64),
        tl=_batched_tl(tensors, overrides, B, device, f64))
    specs = dict.fromkeys(("r_vals", "c_vals", "l_vals", "v_re", "v_im",
                           "ext", "lk", "tl"), VARIANTS)
    specs["freqs"] = ("freq",)
    x, valid = map_blocks(
        device_put,
        functools.partial(_ac_block, nvar=tensors.nvar, method=method),
        args, specs, ({"batch": 0, "freq": 1},) * 2, B)
    # one contiguous device->host copy of the complex128 solution
    return BatchACResult(freqs=freqs, node_names=tensors.node_names,
                         x=x.contiguous().cpu().numpy(),
                         valid=valid.cpu().numpy())


def _tran_block(vs: torch.Tensor, arr: dict, vt_scale: torch.Tensor,
                nvar: int, tp: bool, method: str, nr: str, dt: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full trajectories of the variants of ``arr`` (tran_arrays' dict,
    values leading with the variants): xs (S+1, B, nvar), the switch
    states (S+1, B, nS) and ``valid`` (B,), from the parallel-in-time core
    (``tp``: mc._tp_solutions, no switch states) or the loop."""
    if tp:
        # a linear circuit in the parallel-in-time regime: full
        # trajectories from the affine maps
        from .mc import _tp_solutions

        xs, valid = _tp_solutions(vs, dt, arr, nvar, None)
        return (xs, torch.zeros(xs.shape[:2] + (0,), dtype=torch.bool,
                                device=xs.device), valid)
    xs, sw_states, valid, _carry = _tran_core(
        vs, dt, arr, nvar, method=method, nr=nr,
        lead=(arr["r_vals"].shape[0],), vt_scale=vt_scale)
    return xs, sw_states, valid


def simulate_tran_batch(
    circuit: ParsedCircuit | str,
    overrides: dict[str, np.ndarray],
    tensors: CircuitTensors | None = None,
    method: str = "gj",
    dialect: str = "spicey",
    time_parallel: str = "auto",
    device: torch.device | str | None = None,
    device_put=None,
) -> BatchTranResult:
    """One batched transient run over all parameter variants, in float64
    on ``device`` (the card unless ``device="cpu"``): the full (B, S+1,
    nvar) trajectories. ``overrides`` sweep R/C/L values, the extended
    G/E/F/H gains, MOSFET/JFET betas (by M/J name), BJT Is (by Q name)
    and the DC value of waveform-less V/I sources. Decks with MOSFETs or
    BJTs iterate Newton to convergence, as in the JAX package.
    ``time_parallel``: "auto" (default) takes the parallel-in-time core
    for a linear circuit in its regime (``timeparallel.worthwhile`` at
    itemsize 8); "never" forces the sequential loop.

    ``device_put``: a ``sharder(mesh)`` callable that shards the variants
    (and a batched source grid) over the mesh's "batch" axis. The route is
    chosen for the whole batch (the time-parallel guard at the global B)
    and each piece runs it; the trajectories gather on the mesh's first
    device (``device=None`` means it; another device raises
    ``ValueError``)."""
    device = resolve_device(device, device_put)
    ckt = _resolve(circuit, dialect=dialect)
    if ckt.tran is None:
        raise ValueError("netlist has no .tran analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    if time_parallel not in ("auto", "never"):
        raise ValueError("time_parallel must be 'auto' or 'never'")
    B = _batch_size(overrides)
    _consumed([tensors.r_names, tensors.c_names, tensors.l_names,
               tensors.k_names, _tl_names(tensors),
               tensors.v_names, tensors.i_names, tensors.g_names,
               tensors.e_names, tensors.f_names, tensors.h_names,
               tensors.m_names, tensors.q_names], overrides)
    f64 = torch.float64

    def vals(base: np.ndarray, names: tuple) -> torch.Tensor:
        return torch.as_tensor(_batch_values(base, names, overrides, B),
                               dtype=f64, device=device)

    # MOSFET/BJT/behavioral Newton needs convergence iterations (see
    # tran.simulate_tran)
    nr = ("converged" if (tensors.n_m or tensors.n_q or ckt.B)
          else "spicey")
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    times = np.arange(steps + 1, dtype=np.float64) * dt
    vs = torch.as_tensor(sample_source_values(ckt, times), dtype=f64,
                         device=device)               # (S+1, nV+nI)
    # DC overrides of waveform-less sources batch the source grid, laid
    # out time-major (S+1, B, nSrc) as the loop reads it (V columns first,
    # then extended-dialect I columns; ir/circuit.py)
    src = {n.lower(): i for i, n in enumerate(tensors.v_names)}
    src.update({n.lower(): tensors.n_v + i
                for i, n in enumerate(tensors.i_names)})
    has_wave = np.concatenate([tensors.v_has_waveform,
                               tensors.i_has_waveform])
    src_over = {k: v for k, v in overrides.items() if k.lower() in src}
    if src_over:
        vs = vs[:, None, :].expand(vs.shape[0], B, vs.shape[1]).clone()
        for key, v in src_over.items():
            i = src[key.lower()]
            if has_wave[i]:
                raise ValueError(
                    f"cannot override waveform-driven source {key!r}")
            vs[:, :, i] = torch.as_tensor(np.asarray(v, np.float64),
                                          dtype=f64, device=device)
    arr = tran_arrays(tensors, device, f64,
                      r_vals=vals(tensors.r_vals, tensors.r_names),
                      c_vals=vals(tensors.c_vals, tensors.c_names),
                      l_vals=vals(tensors.l_vals, tensors.l_names),
                      ext=_batched_ext(tensors, overrides, B, device, f64),
                      nl=_batched_nl(tensors, overrides, B, device, f64),
                      lk=_batched_lk(tensors, overrides, B, device, f64),
                      tl=_batched_tl(tensors, overrides, B, device, f64),
                      ckt=ckt, dt=dt)
    tp = (time_parallel == "auto" and tp_eligible(tensors, ckt, nr, "be")
          and tp_worthwhile(tensors, steps, B, 8, device=device))
    run = functools.partial(_tran_block, nvar=tensors.nvar, tp=tp,
                            method="gj" if method == "schur" else method,
                            nr=nr, dt=dt)
    xs, sw_states, valid = map_blocks(
        device_put, run,
        dict(vs=vs, arr=arr, vt_scale=vt_scale_of(tensors, device, f64)),
        {"arr": VARIANTS, "vs": (None, "batch", None) if vs.ndim == 3
         else None}, ({"batch": 1}, {"batch": 1}, {"batch": 0}), B)
    # one device->host copy of [solution | switch states], variants first
    packed = torch.cat([xs, sw_states.to(f64)], dim=-1).permute(1, 0, 2)
    packed = packed.contiguous().cpu().numpy()
    xs_np = packed[..., :tensors.nvar]
    sw_np = packed[..., tensors.nvar:] > 0.5
    tstart = getattr(ckt.tran, "tstart", 0.0)
    if tstart > 0.0:  # extended record window (see tran.simulate_tran)
        keep = times >= tstart - 1e-15
        times, xs_np, sw_np = times[keep], xs_np[:, keep], sw_np[:, keep]
    return BatchTranResult(times=times, node_names=tensors.node_names,
                           xs=xs_np, sw_states=sw_np,
                           valid=valid.cpu().numpy())
