"""Monte-Carlo AC statistics: reductions over the variants axis on the device.

Monte-Carlo users want distributions, yield statistics of a response
across process variation, not raw solutions. So the batched solve and the
reduction run where the batch lives, and only the (n_stats, F) summary
crosses to the host, in one transfer.

APIs:
  mc_ac_stats(net, overrides, node)  -> per-frequency stats of |V(node)|
  mc_ac_sampled(net, spreads, B, node) -> the same with on-device draws

Routes on a CUDA tensor (every solve is a kernel launch):
  - ``method="pallas"``, N <= 16, no K/T: the fused assemble-and-solve
    kernel K5 (ops/mc_ac_fused.py), instantiated in the precision asked;
  - everything else: batched torch assembly, then kernel K1 (ops/gj.py).
On a CPU tensor the same routes run their plain versions.

Exact quantiles follow ``jnp.nanpercentile``'s linear interpolation, done
by hand: ``torch.quantile`` refuses inputs above 2^24 elements, and the
1M-variant x 201-frequency response is 2e8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ir.circuit import bv_branch_rows, build_tensors
from ..ops.mc_ac_fused import (FUSED_MAX_N, PackedPattern,
                               build_stamp_pattern, combine_values,
                               mc_ac_fused, pack_pattern)
from ..parsing.netlist import ParsedCircuit
from .ac import (_ac_sweep_core, build_frequency_array, check_ported,
                 index_tensor)
from .batch import (_batch_size, _batch_values, _batched_ext, _consumed,
                    _resolve)

_DTYPES = {"f64": torch.float64, "f32": torch.float32}


@dataclass
class MCStats:
    """Per-grid-point distribution summary of one response."""

    grid: np.ndarray          # (F,) freqs
    mean: np.ndarray
    std: np.ndarray
    min: np.ndarray
    max: np.ndarray
    quantiles: dict[float, np.ndarray]
    n_valid: int
    n_total: int


def _bisect_quantiles(resp: torch.Tensor, valid: torch.Tensor, qs: tuple,
                      lo: torch.Tensor, hi: torch.Tensor,
                      iters: int = 30) -> torch.Tensor:
    """Approximate quantiles by bisection on the empirical CDF: each
    iteration counts resp <= mid for every (quantile, grid point) as one
    compare-and-reduce over the batch, no sort. 30 halvings converge to
    ~span/2^30. resp: (B, F); valid: (B, F) mask. Returns (nQ, F)."""
    qarr = torch.tensor(qs, dtype=resp.dtype, device=resp.device)[:, None]
    qarr = qarr / 100.0
    n = valid.sum(dim=0).to(torch.float64).clamp(min=1.0)    # (F,)
    lo_q = lo[None, :].expand(len(qs), lo.shape[0])
    hi_q = hi[None, :].expand(len(qs), hi.shape[0])
    for _ in range(iters):
        mid = 0.5 * (lo_q + hi_q)                             # (nQ, F)
        le = valid[:, None, :] & (resp[:, None, :] <= mid[None, :, :])
        frac = le.sum(dim=0).to(torch.float64) / n[None, :]   # (nQ, F)
        # frac(mid) >= q: the quantile lies in [lo, mid] -> shrink hi;
        # otherwise it lies in (mid, hi] -> raise lo
        hit = frac >= qarr
        lo_q, hi_q = (torch.where(hit, lo_q, mid),
                      torch.where(hit, mid, hi_q))
    return 0.5 * (lo_q + hi_q)


def _nanpercentile(resp: torch.Tensor, valid: torch.Tensor,
                   qs: tuple) -> torch.Tensor:
    """``jnp.nanpercentile(where(valid, resp, nan), qs, axis=0)``: sort the
    batch axis with invalid entries last, then interpolate linearly between
    the order statistics at q/100 * (n - 1), n the column's valid count.
    Weights in float64, as JAX's float64 ``qs`` make them. Returns (nQ, F);
    a column with no valid entry gives NaN."""
    inf = torch.tensor(float("inf"), dtype=resp.dtype, device=resp.device)
    srt = torch.sort(torch.where(valid, resp, inf), dim=0).values  # (B, F)
    n = valid.sum(dim=0).to(torch.float64)                   # (F,)
    q = torch.tensor(qs, dtype=torch.float64, device=resp.device) / 100.0
    pos = q[:, None] * (n[None, :] - 1.0)                      # (nQ, F)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    top = n[None, :] - 1.0
    low = torch.clamp(torch.minimum(low, top), min=0.0).long()
    high = torch.clamp(torch.minimum(high, top), min=0.0).long()
    lv = srt.gather(0, low).to(torch.float64)
    hv = srt.gather(0, high).to(torch.float64)
    out = lv * lw + hv * hw
    out = torch.where(n[None, :] > 0, out, torch.full_like(out, math.nan))
    return out.to(resp.dtype)


def _stats_of(resp: torch.Tensor, valid: torch.Tensor, qs: tuple,
              q_method: str = "exact") -> dict[str, torch.Tensor]:
    """resp: (B, F); valid: (B,) or (B, F) -> stats, each (F,) or (nQ, F)."""
    if valid.ndim == 1:
        valid = valid[:, None]
    valid = valid.expand(resp.shape)
    inf = torch.tensor(float("inf"), dtype=resp.dtype, device=resp.device)
    zero = torch.zeros((), dtype=resp.dtype, device=resp.device)
    n = valid.sum(dim=0).clamp(min=1)
    mean = torch.where(valid, resp, zero).sum(dim=0) / n
    var = torch.where(valid, (resp - mean[None, :]) ** 2, zero).sum(dim=0) / n
    out = {
        "mean": mean,
        "std": torch.sqrt(var),
        "min": torch.where(valid, resp, inf).amin(dim=0),
        "max": torch.where(valid, resp, -inf).amax(dim=0),
    }
    if qs:
        if q_method == "approx":
            out["q"] = _bisect_quantiles(resp, valid, qs, out["min"],
                                         out["max"])
        else:
            out["q"] = _nanpercentile(resp, valid, qs)
    return out


def _pack_stats(stats: dict, n_valid: torch.Tensor) -> torch.Tensor:
    """Stack every statistic + the valid count into one tensor, so the
    host pays a single device->host transfer."""
    rows = torch.stack([stats["mean"], stats["std"], stats["min"],
                        stats["max"]])
    if "q" in stats:
        rows = torch.cat([rows, stats["q"]], dim=0)
    nv = n_valid.to(rows.dtype).expand(1, rows.shape[1])
    return torch.cat([rows, nv], dim=0)


def _unpack_stats(packed: np.ndarray, quantiles, grid) -> MCStats:
    return MCStats(
        grid=grid,
        mean=packed[0], std=packed[1], min=packed[2], max=packed[3],
        quantiles={q: packed[4 + i] for i, q in enumerate(quantiles)},
        n_valid=int(packed[-1, 0]),
        n_total=-1,  # caller fills
    )


def _fused_pattern(ckt: ParsedCircuit, tensors, method: str,
                   device: torch.device | str) -> PackedPattern | None:
    """Packed stamp pattern for the fused assemble+solve tier (K5), or
    None when ineligible: non-pallas methods, or N past FUSED_MAX_N (K and
    T elements never reach here). Both precisions qualify."""
    if method != "pallas" or not 0 < tensors.nvar <= FUSED_MAX_N:
        return None
    ext_idx = {"i_idx": tensors.i_idx, "g_idx": tensors.g_idx,
               "e_idx": tensors.e_idx, "f_idx": tensors.f_idx,
               "h_idx": tensors.h_idx}
    pattern = build_stamp_pattern(
        tensors.nvar, tensors.r_idx, tensors.c_idx, tensors.l_idx,
        _v_idx_ac(ckt, tensors), ext_idx)
    return pack_pattern(pattern, tensors.nvar, device)


def _mc_ac_stats_core(freqs: torch.Tensor, idx: dict,
                      r_vals: torch.Tensor, c_vals: torch.Tensor,
                      l_vals: torch.Tensor, v_re: torch.Tensor,
                      v_im: torch.Tensor, ext: dict, i_re: torch.Tensor,
                      i_im: torch.Tensor, nvar: int, node_idx: int,
                      method: str, qs: tuple, chunk: int | None = None,
                      q_method: str = "exact",
                      pattern: PackedPattern | None = None) -> torch.Tensor:
    """Solve every (variant, frequency) system, reduce over the variants.

    Values lead with the variants axis B; ``idx`` holds the r/c/l/v index
    tensors. ``chunk`` solves the batch in blocks of that many variants,
    bounding the solve buffers; only the (B, F) response accumulates.
    Returns the packed statistics (see ``_pack_stats``)."""

    def solve_block(sl: slice) -> tuple[torch.Tensor, torch.Tensor]:
        ext_b = {k: (v if k.endswith("idx") else v[sl])
                 for k, v in ext.items()}
        if pattern is not None:
            vals = combine_values(r_vals[sl], c_vals[sl], l_vals[sl],
                                  v_re[sl], v_im[sl], ext=ext_b, i_re=i_re,
                                  i_im=i_im, dtype=r_vals.dtype)
            return mc_ac_fused(freqs, vals, pattern, node_idx)
        x_re, x_im, valid = _ac_sweep_core(
            freqs, idx["r"], r_vals[sl], idx["c"], c_vals[sl], idx["l"],
            l_vals[sl], idx["v"], v_re[sl], v_im[sl], nvar, method=method,
            ext=ext_b, i_re=i_re, i_im=i_im)
        xr, xi = x_re[..., node_idx], x_im[..., node_idx]
        return torch.sqrt(xr * xr + xi * xi), valid

    B = r_vals.shape[0]
    step = B if chunk is None or chunk >= B else chunk
    blocks = [solve_block(slice(s, s + step)) for s in range(0, B, step)]
    if len(blocks) == 1:
        mag, valid = blocks[0]
    else:
        mag = torch.cat([m for m, _ in blocks], dim=0)
        valid = torch.cat([v for _, v in blocks], dim=0)
    stats = _stats_of(mag, valid, qs, q_method=q_method)
    n_valid = valid.all(dim=-1).sum()
    return _pack_stats(stats, n_valid)


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


def _check_args(precision: str, quantile_method: str) -> torch.dtype:
    if precision not in _DTYPES:
        raise ValueError("precision must be 'f64' or 'f32'")
    if quantile_method not in ("exact", "approx"):
        raise ValueError("quantile_method must be 'exact' or 'approx'")
    return _DTYPES[precision]


def _run(ckt: ParsedCircuit, tensors, r_vals: torch.Tensor,
         c_vals: torch.Tensor, l_vals: torch.Tensor, ext: dict,
         node: str, quantiles, method: str, fdt: torch.dtype,
         chunk: int | None, quantile_method: str,
         device: torch.device | str) -> MCStats:
    """Shared tail of mc_ac_stats and mc_ac_sampled: drive phasors,
    index tensors, the route, the core, one transfer to the host."""
    B = r_vals.shape[0]
    freqs = build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2)
    ph = tensors.v_ac_phase_deg * math.pi / 180.0
    v_re = torch.as_tensor(tensors.v_ac_mag * np.cos(ph), dtype=fdt,
                           device=device).expand(B, tensors.n_v)
    v_im = torch.as_tensor(tensors.v_ac_mag * np.sin(ph), dtype=fdt,
                           device=device).expand(B, tensors.n_v)
    v_re, v_im = _pad_v_phasors(ckt, v_re, v_im)
    iph = tensors.i_ac_phase_deg * math.pi / 180.0
    i_re = torch.as_tensor(tensors.i_ac_mag * np.cos(iph), dtype=fdt,
                           device=device)
    i_im = torch.as_tensor(tensors.i_ac_mag * np.sin(iph), dtype=fdt,
                           device=device)
    node_idx = [n.upper() for n in tensors.node_names].index(node.upper())
    idx = {"r": index_tensor(tensors.r_idx, device),
           "c": index_tensor(tensors.c_idx, device),
           "l": index_tensor(tensors.l_idx, device),
           "v": index_tensor(_v_idx_ac(ckt, tensors), device)}
    packed = _mc_ac_stats_core(
        torch.as_tensor(freqs, dtype=fdt, device=device), idx,
        r_vals.to(fdt), c_vals.to(fdt), l_vals.to(fdt), v_re, v_im, ext,
        i_re, i_im, tensors.nvar, node_idx, method,
        tuple(float(q) for q in quantiles), chunk=chunk,
        q_method=quantile_method,
        pattern=_fused_pattern(ckt, tensors, method, device))
    res = _unpack_stats(packed.cpu().numpy(), tuple(quantiles), freqs)
    res.n_total = B
    return res


def mc_ac_stats(
    circuit: ParsedCircuit | str,
    overrides: dict[str, np.ndarray],
    node: str,
    quantiles: tuple[float, ...] = (5.0, 50.0, 95.0),
    tensors=None,
    method: str = "gj",
    precision: str = "f64",
    dialect: str = "spicey",
    chunk: int | None = None,
    quantile_method: str = "exact",
    device: torch.device | str = "cpu",
) -> MCStats:
    """Distribution of |V(node)| per frequency across parameter variants.

    ``overrides`` maps element names to (B,) value arrays. ``chunk``
    solves the batch in blocks of that size, bounding device memory; only
    the (B, F) response stays resident. ``precision="f32"`` runs assembly,
    solve and reduction in float32 (yield statistics under percent-level
    spreads lose nothing at f32); the 6-sig-fig golden contract needs the
    default f64. ``method="pallas"`` takes the fused kernel K5 where the
    circuit qualifies (N <= 16), ``"gj"`` always assembles and solves
    with K1; on the CPU both run their plain versions.
    """
    ckt = _resolve(circuit, dialect=dialect)
    if ckt.ac is None:
        raise ValueError("netlist has no .ac analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    check_ported(tensors, method)
    fdt = _check_args(precision, quantile_method)
    B = _batch_size(overrides)
    _consumed([tensors.r_names, tensors.c_names, tensors.l_names,
               tensors.v_names, tensors.i_names, tensors.g_names,
               tensors.e_names, tensors.f_names, tensors.h_names], overrides)
    r_vals = _batch_values(tensors.r_vals, tensors.r_names, overrides, B)
    c_vals = _batch_values(tensors.c_vals, tensors.c_names, overrides, B)
    l_vals = _batch_values(tensors.l_vals, tensors.l_names, overrides, B)
    if np.any(r_vals <= 0):
        raise ValueError("R values must be > 0")

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=fdt, device=device)

    return _run(ckt, tensors, dev(r_vals), dev(c_vals), dev(l_vals),
                _batched_ext(tensors, overrides, B, device, fdt), node,
                quantiles, method, fdt, chunk, quantile_method, device)


def _sample_targets(tensors, spreads: dict[str, float]) -> list[tuple]:
    """(group, position, sigma) for every sampled element name."""
    groups = {"r": tensors.r_names, "c": tensors.c_names,
              "l": tensors.l_names}
    targets = []
    for name, sigma in spreads.items():
        for g, names in groups.items():
            upper = [n.upper() for n in names]
            if name.upper() in upper:
                targets.append((g, upper.index(name.upper()), float(sigma)))
                break
        else:
            raise ValueError(f"unknown sampled element {name!r}")
    return targets


def _spread_values(tensors, targets: list[tuple], z: torch.Tensor,
                   dist: str) -> dict[str, torch.Tensor]:
    """Apply the draws ``z`` (B, n_targets) around the netlist values:
    lognormal v*exp(sigma*z) or relative-normal v*(1 + sigma*z). Returns
    float64 (B, nE) tensors for r/c/l on z's device."""
    if dist not in ("lognormal", "normal"):
        raise ValueError("dist must be 'lognormal' or 'normal'")
    B = z.shape[0]
    vals = {g: torch.as_tensor(base, dtype=torch.float64,
                               device=z.device).expand(B, base.shape[0])
            .clone()
            for g, base in (("r", tensors.r_vals), ("c", tensors.c_vals),
                            ("l", tensors.l_vals))}
    for j, (g, i, sigma) in enumerate(targets):
        col = vals[g][:, i]
        if dist == "lognormal":
            vals[g][:, i] = col * torch.exp(sigma * z[:, j])
        else:
            vals[g][:, i] = col * (1.0 + sigma * z[:, j])
    return vals


def mc_ac_sampled(
    circuit: ParsedCircuit | str,
    spreads: dict[str, float],
    B: int,
    node: str,
    key: int = 0,
    dist: str = "lognormal",
    quantiles: tuple[float, ...] = (5.0, 50.0, 95.0),
    tensors=None,
    method: str = "gj",
    precision: str = "f64",
    chunk: int | None = None,
    dialect: str = "spicey",
    quantile_method: str = "exact",
    device: torch.device | str = "cpu",
) -> MCStats:
    """Yield analysis with ON-DEVICE parameter sampling: ``spreads`` maps
    R/C/L element names to relative sigmas; B variants are drawn from a
    lognormal (or relative-normal) distribution around the netlist values
    by a ``torch.Generator`` on ``device`` seeded with ``key``, so no
    (B, nE) host arrays ever exist. The draws differ from the JAX
    package's ``jax.random`` stream for the same key. Everything else
    matches mc_ac_stats."""
    ckt = _resolve(circuit, dialect=dialect)
    if ckt.ac is None:
        raise ValueError("netlist has no .ac analysis")
    if tensors is None:
        tensors = build_tensors(ckt)
    check_ported(tensors, method)
    fdt = _check_args(precision, quantile_method)
    targets = _sample_targets(tensors, spreads)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    z = torch.randn((B, len(targets)), generator=gen, dtype=torch.float64,
                    device=device)
    vals = _spread_values(tensors, targets, z, dist)
    return _run(ckt, tensors, vals["r"], vals["c"], vals["l"],
                _batched_ext(tensors, {}, B, device, fdt), node, quantiles,
                method, fdt, chunk, quantile_method, device)
