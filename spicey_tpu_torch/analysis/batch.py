"""Batch helpers shared by the Monte-Carlo analyses.

Overrides map element names (case-insensitive) to (B,) value arrays; the
helpers tile netlist values to a leading variants axis and apply them.
The batched analyses themselves (``simulate_ac_batch``,
``simulate_tran_batch``) are not ported yet (ROADMAP §1 item 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.circuit import CircuitTensors, ext_arrays, nl_arrays
from ..parsing.netlist import ParsedCircuit, parse_netlist


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
