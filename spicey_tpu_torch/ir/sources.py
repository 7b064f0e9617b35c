"""Source evaluation at arbitrary time points, for the adaptive transient.

A copy of spicey_tpu/ir/sources.py. The fixed-step engines precompute
source values over the whole grid (ir/circuit.sample_source_values)
because their time points are known ahead of the loop. The adaptive
transient chooses its own time points, so every independent source (V
then I, the sampled grid's column order) compiles into a flat parameter
table, built on the host:

  kind: (nSrc,) int64   0=DC  1=PULSE  2=PWL  3=SIN  4=EXP
  par:  (nSrc, 8)       type-specific scalars (see ``eval_sources``)
  pwl_t/pwl_v: (nSrc, L) padded PWL breakpoints (clamp-end semantics)

``eval_sources(prog, t)`` computes every source's value at time t as
tensor arithmetic on the table's device, each source's kind selected
from the formulas of the kinds present. Semantics
mirror the host-side waveforms (parsing/waveforms.py): PULSE follows
pulseValue.ts:4-22, PWL is clamp-end linear interpolation
(pwlValue.ts:3-16) in the arithmetic of ``jnp.interp``, SIN/EXP the
ngspice extended forms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parsing.netlist import ParsedCircuit
from ..parsing.waveforms import (ExpWaveform, PulseWaveform, PwlWaveform,
                                 SinWaveform)

K_DC, K_PULSE, K_PWL, K_SIN, K_EXP = 0, 1, 2, 3, 4
_NPAR = 8


def build_source_program(ckt: ParsedCircuit) -> dict:
    """Compile V then I sources into the flat table (host NumPy)."""
    sources = list(ckt.V) + list(ckt.I)
    n = len(sources)
    kind = np.zeros(n, np.int64)
    par = np.zeros((n, _NPAR), np.float64)
    pwl_len = max(
        [len(s.waveform.pairs) for s in sources
         if isinstance(getattr(s, "waveform", None), PwlWaveform)] or [1]
    )
    pwl_t = np.zeros((n, pwl_len), np.float64)
    pwl_v = np.zeros((n, pwl_len), np.float64)

    for k, s in enumerate(sources):
        w = s.waveform
        dc = s.dc
        dc = 0.0 if (dc != dc or dc == 0.0) else dc  # JS `|| 0`
        if w is None:
            kind[k] = K_DC
            par[k, 0] = dc
        elif isinstance(w, PulseWaveform):
            kind[k] = K_PULSE
            p = w.spec
            ncyc = p.ncycles if math.isfinite(p.ncycles) else 1e300
            par[k, :8] = [p.v1, p.v2, p.td, p.tr, p.tf, p.ton, p.period,
                          ncyc]
        elif isinstance(w, PwlWaveform):
            kind[k] = K_PWL
            ts = [t for t, _ in w.pairs]
            vs = [v for _, v in w.pairs]
            # pad by repeating the last breakpoint: interp then clamps
            ts += [ts[-1]] * (pwl_len - len(ts))
            vs += [vs[-1]] * (pwl_len - len(vs))
            pwl_t[k] = ts
            pwl_v[k] = vs
        elif isinstance(w, SinWaveform):
            kind[k] = K_SIN
            p = w.spec
            par[k, :6] = [p.vo, p.va, p.freq, p.td, p.theta, p.phase_deg]
        elif isinstance(w, ExpWaveform):
            kind[k] = K_EXP
            p = w.spec
            par[k, :6] = [p.v1, p.v2, p.td1, p.tau1, p.td2, p.tau2]
        else:
            raise ValueError(f"unsupported waveform on source {s.name}")
    return {"kind": kind, "par": par, "pwl_t": pwl_t, "pwl_v": pwl_v}


def source_program(ckt: ParsedCircuit, device: torch.device | str,
                   dtype: torch.dtype = torch.float64) -> dict:
    """``build_source_program``'s table as tensors on ``device``, with the
    set of kinds present under "kinds" (host ints), so ``eval_sources``
    evaluates only those."""
    prog = build_source_program(ckt)
    out = {k: torch.as_tensor(v, dtype=torch.int64 if k == "kind"
                              else dtype, device=device)
           for k, v in prog.items()}
    out["kinds"] = frozenset(int(k) for k in prog["kind"])
    return out


def _interp(t: float, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(t, xp[k], fp[k])`` for every row k of (nSrc, L)
    breakpoints: the bracketing pair by a right-side search, a zero-width
    pair (|dx| <= the spacing of eps) taking its left value, clamped to
    the end values outside [xp[0], xp[-1]]."""
    L = xp.shape[-1]
    # (jnp.clip's order: a single breakpoint gives i = 0, i - 1 = -1,
    # which indexes the last entry)
    i = torch.clamp((xp <= t).sum(dim=-1, keepdim=True), min=1).clamp(
        max=L - 1)
    im1 = (i - 1) % L
    x0, x1 = xp.gather(-1, im1)[:, 0], xp.gather(-1, i)[:, 0]
    f0, f1 = fp.gather(-1, im1)[:, 0], fp.gather(-1, i)[:, 0]
    dx = x1 - x0
    tiny = dx.abs() <= float(np.spacing(np.finfo(np.float64).eps))
    f = torch.where(tiny, f0, f0 + ((t - x0) / torch.where(tiny, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(t < xp[:, 0], fp[:, 0], f)
    return torch.where(t > xp[:, -1], fp[:, -1], f)


def eval_sources(prog: dict, t: float) -> torch.Tensor:
    """Value of every source at time t. Returns (nSrc,). Each kind's
    formula runs only where ``prog["kinds"]`` lists it; the values are
    those of evaluating all five and selecting, as the JAX package does."""
    par, kind, kinds = prog["par"], prog["kind"], prog["kinds"]
    out = par[:, 0]
    if K_PULSE in kinds:
        out = torch.where(kind == K_PULSE, _pulse(par, t), out)
    if K_PWL in kinds:
        out = torch.where(kind == K_PWL,
                          _interp(t, prog["pwl_t"], prog["pwl_v"]), out)
    if K_SIN in kinds:
        out = torch.where(kind == K_SIN, _sin(par, t), out)
    if K_EXP in kinds:
        out = torch.where(kind == K_EXP, _exp(par, t), out)
    return out


def _pulse(par: torch.Tensor, t: float) -> torch.Tensor:
    """PULSE (pulseValue.ts:4-22): before delay -> v1; fold by period;
    after ncycles cycles -> v1; linear rise tr, hold ton, linear fall tf."""
    v1, v2, td, tr, tf, ton, period, ncyc = (par[:, i] for i in range(8))
    tc = t - td
    safe_period = torch.where(period > 0, period, 1.0)
    cycle = torch.floor(tc / safe_period)
    tin = tc - cycle * safe_period
    after_cycles = cycle >= ncyc
    rise_frac = torch.where(
        tr > 0, torch.clamp(tin / torch.where(tr > 0, tr, 1.0), 0.0, 1.0),
        1.0)
    in_rise = tin < tr
    in_on = ~in_rise & (tin < tr + ton)
    in_fall = (tin >= tr + ton) & (tin < tr + ton + tf)
    fall_frac = torch.where(
        tf > 0, torch.clamp((tin - tr - ton) / torch.where(tf > 0, tf, 1.0),
                            0.0, 1.0), 1.0)
    v_pulse = torch.where(
        in_rise, v1 + (v2 - v1) * rise_frac,
        torch.where(in_on, v2,
                    torch.where(in_fall, v2 + (v1 - v2) * fall_frac, v1)))
    return torch.where((tc < 0) | after_cycles, v1, v_pulse)


def _sin(par: torch.Tensor, t: float) -> torch.Tensor:
    vo, va, freq, std, theta, phase = (par[:, i] for i in range(6))
    dt_s = t - std
    act = dt_s >= 0
    v_sin = vo + va * torch.exp(-torch.where(act, dt_s, 0.0) * theta) \
        * torch.sin(2.0 * math.pi * (freq * dt_s + phase / 360.0))
    return torch.where(act, v_sin, vo)


def _exp(par: torch.Tensor, t: float) -> torch.Tensor:
    e1, e2, td1, tau1, td2, tau2 = (par[:, i] for i in range(6))
    tau1 = torch.clamp(tau1, min=1e-30)
    tau2 = torch.clamp(tau2, min=1e-30)
    d1 = torch.clamp(t - td1, min=0.0)
    d2 = torch.clamp(t - td2, min=0.0)
    return (e1
            + torch.where(t >= td1, (e2 - e1) * (1.0 - torch.exp(-d1 / tau1)),
                          0.0)
            + torch.where(t >= td2, (e1 - e2) * (1.0 - torch.exp(-d2 / tau2)),
                          0.0))
