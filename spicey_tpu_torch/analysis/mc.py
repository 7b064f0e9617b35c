"""Monte-Carlo AC statistics: reductions over the variants axis on the device.

Monte-Carlo users want distributions, yield statistics of a response
across process variation, not raw solutions. So the batched solve and the
reduction run where the batch lives, and only the (n_stats, F) summary
crosses to the host, in one transfer.

APIs:
  mc_ac_stats(net, overrides, node)    -> per-frequency stats of |V(node)|
  mc_ac_sampled(net, spreads, B, node) -> the same with on-device draws
  mc_tran_stats(net, overrides, node)  -> per-timestep stats of V(node)
  mc_tran_sampled(net, spreads, B, node) -> the same with on-device draws

AC routes on a CUDA tensor (every solve is a kernel launch):
  - ``method="pallas"``, N <= 16, no K/T: the fused assemble-and-solve
    kernel K5 (ops/mc_ac_fused.py), instantiated in the precision asked;
  - everything else: batched torch assembly, then kernel K1 (ops/gj.py),
    a K deck's M^{-1} per variant by K3.
Transient routes, as the JAX package routes them:
  - ``method="pallas"``, ``precision="f32"``, BE, N <= 16, no
    per-variant source values, no K, T or B element: the fused
    whole-transient kernels
    (ops/mc_tran_fused.py), K8 for a linear deck, K9 for a deck with
    switches, diodes, MOSFETs/JFETs or BJTs (junction charge included),
    with the reference's switch-stability exit for S/D decks and Newton
    to convergence for M/Q decks;
  - a linear BE or trap deck where ``timeparallel.worthwhile`` says the
    regime fits (``time_parallel="auto"``): the parallel-in-time core
    (analysis/timeparallel.py, ``_tp_solutions``), one A^-1 per variant
    (K3) and the time axis in O(log S) depth;
  - everything else: the batched time loop of analysis/tran.py, one
    (B, N, N) solve per Newton pass (K2), or one inverse for a linear
    deck (K3) and a matvec per step.
On a CPU tensor the same routes run their plain versions. Entry points
run on the card unless ``device="cpu"``.

``mc_ac_stats`` and ``mc_tran_stats`` take ``device_put=sharder(mesh)``
(parallel/mesh.py): the variants split over the mesh, each piece runs
the route chosen for the whole batch (the fused kernels only on a plain
1D 'batch' mesh dividing B, and in AC only unchunked: the JAX package's
``_batch_mesh`` rule), and one reduction runs over the gathered
responses on the mesh's first device, so both quantile methods see the
batch an unsharded call sees.

The structured tier (ops/schur.py) routes as in the JAX package: forced
by ``method="schur"``, taken by ``method="gj"`` on a subcircuit board past
N = 128 (the AC sweep, the transient loop), its block solves on K1's and
K2's multi entry; a variant whose block pivots fail counts as invalid
(no dense retry in the Monte-Carlo statistics, as in the JAX package). A
flat deck past N = 128 solves dense (K1, K2 or K3 in a global workspace;
``chunk`` bounds it, B N (N + 1) elements per plane).

Exact quantiles follow ``jnp.nanpercentile``'s linear interpolation, done
by hand: ``torch.quantile`` refuses inputs above 2^24 elements, and the
1M-variant x 201-frequency response is 2e8.

Spans (utils/profiling.py, recorded inside ``profiled()`` only): each
entry opens a span of its own name at its first line, holding four in
order: ``prepare`` (the argument checks, the values tiled and copied to
the device, the source grid, the route's inputs: the fused pattern and
value rows, or the loop's arrays, or the AC phasors and pattern),
``solve`` (the route over the mesh's blocks), ``reduce`` (the statistics
on the device) and ``fetch`` (the one transfer to the host, counted as
``sync.fetch``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..constants import EPS, MAX_NR_ITERS, VT_300K
from ..ir.circuit import (build_tensors, effective_time_step, ext_arrays,
                          lk_arrays, nl_arrays, sample_source_values,
                          tl_arrays)
from ..ops import linsolve
from ..ops import mc_tran_fused as mtf
from ..ops.schur import plan_for
from ..ops.mc_ac_fused import PackedPattern, combine_values, mc_ac_fused
from ..parallel.mesh import VARIANTS, map_blocks, mesh_of
from ..parsing.netlist import ParsedCircuit
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .ac import _ac_sweep_core, build_frequency_array, index_tensor
from .batch import (_batch_size, _batch_values, _batched_ext, _batched_nl,
                    _batched_tl, _consumed, _fused_pattern, _pad_v_phasors,
                    _resolve, _tl_names, _v_idx_ac)
from .timeparallel import eligible as tp_eligible
from .timeparallel import (linear_tran_maps, linear_tran_maps_trap,
                           linear_tran_solutions)
from .timeparallel import worthwhile as tp_worthwhile
from .tran import (_mutual_inv, _tran_core, linear_system_matrix,
                   tran_arrays, vt_scale_of)

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


def _reduce(resp: torch.Tensor, valid: torch.Tensor, qs: tuple,
            q_method: str = "exact") -> torch.Tensor:
    """The statistics of the (B, G) responses over the variants, packed
    (``_pack_stats``); ``valid`` (B,) or (B, G), a variant counting as
    valid where it is at every grid point."""
    n_valid = valid.all(dim=-1).sum() if valid.ndim == 2 else valid.sum()
    return _pack_stats(_stats_of(resp, valid, qs, q_method=q_method),
                       n_valid)


@dataclass
class _Route:
    """A Monte-Carlo call once prepared: the route's function ``run`` and
    its ``args`` (placed over a mesh by ``specs``), the variant count, the
    grid and what the statistics ask for."""

    run: Callable
    args: dict
    specs: dict
    n_variants: int
    grid: np.ndarray
    quantiles: tuple
    quantile_method: str
    device_put: object


def _solve_reduce_fetch(route: _Route) -> MCStats:
    """The shared tail of the four entries, one span each: ``solve`` (the
    route, over the mesh's blocks), ``reduce`` (the statistics on the
    device) and ``fetch`` (one transfer to the host)."""
    with span("solve"):
        resp, valid = map_blocks(route.device_put, route.run, route.args,
                                 route.specs, ({"batch": 0}, {"batch": 0}),
                                 route.n_variants)
    with span("reduce"):
        packed = _reduce(resp, valid,
                         tuple(float(q) for q in route.quantiles),
                         route.quantile_method)
    with span("fetch"):
        count("sync.fetch")
        res = _unpack_stats(packed.cpu().numpy(), route.quantiles,
                            route.grid)
    res.n_total = route.n_variants
    return res


def _batch_mesh(device_put, B: int) -> bool:
    """Whether the fused kernels may run per device on the mesh behind a
    ``sharder`` callable (the JAX package's rule, mc.py:467-481): a
    'batch' axis that is the mesh's only axis larger than 1 (the fused
    kernels have no frequency axis to give a 2D mesh) and a variant count
    divisible by it. Otherwise every piece takes the non-fused route, as
    the JAX package's sharded runs do."""
    shape = mesh_of(device_put).shape
    n_b = shape.get("batch", 0)
    return (n_b > 0 and B % n_b == 0
            and all(n == 1 for ax, n in shape.items() if ax != "batch"))


def _mc_ac_responses(freqs: torch.Tensor, idx: dict,
                     r_vals: torch.Tensor, c_vals: torch.Tensor,
                     l_vals: torch.Tensor, v_re: torch.Tensor,
                     v_im: torch.Tensor, ext: dict, i_re: torch.Tensor,
                     i_im: torch.Tensor, nvar: int, node_idx: int,
                     method: str, chunk: int | None = None,
                     pattern: PackedPattern | None = None,
                     lk: dict | None = None, tl: dict | None = None,
                     plan: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve every (variant, frequency) system: |V(node)| and ``valid``,
    each (B, F).

    Values lead with the variants axis B; ``idx`` holds the r/c/l/v index
    tensors; ``lk`` the couplings (unbatched k) and ``tl`` the T lines
    (Z0/Td (B, nT)) when the deck has them; ``plan`` (a
    ``SchurPlan.arrays()``) routes the solves through the structured tier
    (a variant whose block pivots fail counts as invalid, as in the JAX
    package: no dense retry here). ``chunk`` solves the batch in
    blocks of that many variants, bounding the solve buffers; only the
    (B, F) response accumulates."""

    def solve_block(sl: slice) -> tuple[torch.Tensor, torch.Tensor]:
        ext_b = {k: (v if k.endswith("idx") else v[sl])
                 for k, v in ext.items()}
        tl_b = (None if tl is None else
                {"t_idx": tl["t_idx"], "z0": tl["z0"][sl],
                 "td": tl["td"][sl]})
        if pattern is not None:
            vals = combine_values(r_vals[sl], c_vals[sl], l_vals[sl],
                                  v_re[sl], v_im[sl], ext=ext_b, i_re=i_re,
                                  i_im=i_im, dtype=r_vals.dtype)
            return mc_ac_fused(freqs, vals, pattern, node_idx)
        x_re, x_im, valid = _ac_sweep_core(
            freqs, idx["r"], r_vals[sl], idx["c"], c_vals[sl], idx["l"],
            l_vals[sl], idx["v"], v_re[sl], v_im[sl], nvar, method=method,
            ext=ext_b, i_re=i_re, i_im=i_im, lk=lk, tl=tl_b, plan=plan)
        xr, xi = x_re[..., node_idx], x_im[..., node_idx]
        return torch.sqrt(xr * xr + xi * xi), valid

    B = r_vals.shape[0]
    step = B if chunk is None or chunk >= B else chunk
    blocks = [solve_block(slice(s, s + step)) for s in range(0, B, step)]
    if len(blocks) == 1:
        return blocks[0]
    return (torch.cat([m for m, _ in blocks], dim=0),
            torch.cat([v for _, v in blocks], dim=0))


def _check_args(precision: str, quantile_method: str) -> torch.dtype:
    if precision not in _DTYPES:
        raise ValueError("precision must be 'f64' or 'f32'")
    if quantile_method not in ("exact", "approx"):
        raise ValueError("quantile_method must be 'exact' or 'approx'")
    return _DTYPES[precision]


def _ac_route(ckt: ParsedCircuit, tensors, r_vals: torch.Tensor,
              c_vals: torch.Tensor, l_vals: torch.Tensor, ext: dict,
              node: str, quantiles, method: str, fdt: torch.dtype,
              chunk: int | None, quantile_method: str,
              device: torch.device | str, tl: dict | None = None,
              device_put=None) -> _Route:
    """The rest of mc_ac_stats' and mc_ac_sampled's preparation: drive
    phasors, index tensors, the structured plan and the route. ``tl``:
    the T lines, Z0/Td tiled to the variants. ``device_put``: the
    variants split over a mesh whose first device is ``device``, the
    responses gathered there and reduced once."""
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
    # the structured tier: forced by "schur", auto past N = 128 for "gj"
    plan = plan_for(method, ckt, tensors, tensors.nvar, device)
    if method == "schur":
        method = "gj"
    # on a mesh, the fused kernel runs per device only on a plain 1D
    # batch mesh with an unchunked sweep (the JAX package's rule)
    fused = device_put is None or (
        (chunk is None or chunk >= B) and _batch_mesh(device_put, B))
    args = dict(
        freqs=torch.as_tensor(freqs, dtype=fdt, device=device), idx=idx,
        r_vals=r_vals.to(fdt), c_vals=c_vals.to(fdt), l_vals=l_vals.to(fdt),
        v_re=v_re, v_im=v_im, ext=ext, i_re=i_re, i_im=i_im,
        pattern=(_fused_pattern(ckt, tensors, method, device) if fused
                 else None),
        lk=lk_arrays(tensors, device, fdt), tl=tl, plan=plan)
    run = functools.partial(_mc_ac_responses, nvar=tensors.nvar,
                            node_idx=node_idx, method=method, chunk=chunk)
    return _Route(run, args,
                  dict.fromkeys(("r_vals", "c_vals", "l_vals", "v_re",
                                 "v_im", "ext", "tl"), VARIANTS),
                  B, freqs, tuple(quantiles), quantile_method, device_put)


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
    device_put=None,
    device: torch.device | str | None = None,
) -> MCStats:
    """Distribution of |V(node)| per frequency across parameter variants.

    ``overrides`` maps element names to (B,) value arrays. ``chunk``
    solves the batch in blocks of that size, bounding device memory; only
    the (B, F) response stays resident. ``precision="f32"`` runs assembly,
    solve and reduction in float32 (yield statistics under percent-level
    spreads lose nothing at f32); the 6-sig-fig golden contract needs the
    default f64. ``method="pallas"`` takes the fused kernel K5 where the
    circuit qualifies (N <= 16), ``"gj"`` always assembles and solves
    with K1; on the CPU (``device="cpu"``) both run their plain versions.

    ``device_put``: a ``sharder(mesh)`` callable (parallel/mesh.py) that
    shards the variants axis over the mesh. Each device's piece runs the
    route above on its own (chunked within the piece); the fused kernel
    K5 runs per device only on a plain 1D 'batch' mesh dividing B and an
    unchunked sweep, else every piece takes K1. The responses gather on
    the mesh's first device (``device=None`` means it; another device
    raises ``ValueError``), where the statistics reduce once.
    """
    with span("mc_ac_stats"):
        with span("prepare"):
            device = resolve_device(device, device_put)
            ckt = _resolve(circuit, dialect=dialect)
            if ckt.ac is None:
                raise ValueError("netlist has no .ac analysis")
            if tensors is None:
                tensors = build_tensors(ckt)
            fdt = _check_args(precision, quantile_method)
            B = _batch_size(overrides)
            _consumed([tensors.r_names, tensors.c_names, tensors.l_names,
                       _tl_names(tensors),
                       tensors.v_names, tensors.i_names, tensors.g_names,
                       tensors.e_names, tensors.f_names, tensors.h_names],
                      overrides)
            r_vals = _batch_values(tensors.r_vals, tensors.r_names,
                                   overrides, B)
            c_vals = _batch_values(tensors.c_vals, tensors.c_names,
                                   overrides, B)
            l_vals = _batch_values(tensors.l_vals, tensors.l_names,
                                   overrides, B)
            if np.any(r_vals <= 0):
                raise ValueError("R values must be > 0")

            def dev(a: np.ndarray) -> torch.Tensor:
                return torch.as_tensor(a, dtype=fdt, device=device)

            route = _ac_route(
                ckt, tensors, dev(r_vals), dev(c_vals), dev(l_vals),
                _batched_ext(tensors, overrides, B, device, fdt), node,
                quantiles, method, fdt, chunk, quantile_method, device,
                tl=_batched_tl(tensors, overrides, B, device, fdt),
                device_put=device_put)
        return _solve_reduce_fetch(route)


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
    device: torch.device | str | None = None,
) -> MCStats:
    """Yield analysis with ON-DEVICE parameter sampling: ``spreads`` maps
    R/C/L element names to relative sigmas; B variants are drawn from a
    lognormal (or relative-normal) distribution around the netlist values
    by a ``torch.Generator`` on ``device`` seeded with ``key``, so no
    (B, nE) host arrays ever exist. The draws differ from the JAX
    package's ``jax.random`` stream for the same key. Everything else
    matches mc_ac_stats."""
    with span("mc_ac_sampled"):
        with span("prepare"):
            device = resolve_device(device)
            ckt = _resolve(circuit, dialect=dialect)
            if ckt.ac is None:
                raise ValueError("netlist has no .ac analysis")
            if tensors is None:
                tensors = build_tensors(ckt)
            fdt = _check_args(precision, quantile_method)
            targets = _sample_targets(tensors, spreads)
            gen = torch.Generator(device=device)
            gen.manual_seed(int(key))
            z = torch.randn((B, len(targets)), generator=gen,
                            dtype=torch.float64, device=device)
            vals = _spread_values(tensors, targets, z, dist)
            route = _ac_route(
                ckt, tensors, vals["r"], vals["c"], vals["l"],
                _batched_ext(tensors, {}, B, device, fdt), node, quantiles,
                method, fdt, chunk, quantile_method, device,
                tl=_batched_tl(tensors, {}, B, device, fdt))
        return _solve_reduce_fetch(route)


def _fused_tran_pattern(ckt: ParsedCircuit, tensors, method: str,
                        precision: str, integration: str, vs_batched: bool,
                        device: torch.device) -> mtf.TranPattern | None:
    """Packed pattern for the fused whole-transient tier, or None when the
    JAX package's eligibility (mc.py:484-522) fails: the pallas method at
    f32, BE, no per-variant source values, no K coupling, T line or B
    source (the kernels know no coupled inductance, no line history and
    no expression), 0 < N <= 16. A linear pattern runs K8, one with
    switches, diodes, MOSFETs or BJTs (and their junction charge) K9.
    The TPU's SMEM source-grid budget has no counterpart: the kernels
    read the grid from device memory."""
    if (method != "pallas" or precision != "f32" or vs_batched
            or integration != "be"
            or tensors.n_k or tensors.n_t or ckt.B
            or not 0 < tensors.nvar <= mtf.FUSED_MAX_N):
        return None
    ext_idx = {"i_idx": tensors.i_idx, "g_idx": tensors.g_idx,
               "e_idx": tensors.e_idx, "f_idx": tensors.f_idx,
               "h_idx": tensors.h_idx}
    pattern = mtf.build_tran_pattern(
        tensors.nvar, tensors.r_idx, tensors.c_idx, tensors.l_idx,
        tensors.v_idx, tensors.n_i, ext_idx, s_idx=tensors.s_idx,
        d_idx=tensors.d_idx, m_idx=tensors.m_idx, m_pol=tensors.m_polarity,
        q_idx=tensors.q_idx, q_pol=tensors.q_polarity,
        d_chg=tensors.has_d_charge, q_chg=tensors.has_q_charge)
    return mtf.pack_tran_pattern(pattern, tensors.nvar, device)


def tran_value_slab(tensors, r_vals: torch.Tensor, c_vals: torch.Tensor,
                    l_vals: torch.Tensor, ext: dict, nl: dict,
                    dt: float) -> torch.Tensor:
    """The fused tier's (n_rows, B) float32 value slab, contiguous: the
    transpose of ``_value_rows``."""
    return _value_rows(tensors, r_vals, c_vals, l_vals, ext, nl,
                       dt).T.contiguous()


def _value_rows(tensors, r_vals: torch.Tensor, c_vals: torch.Tensor,
                l_vals: torch.Tensor, ext: dict, nl: dict,
                dt: float) -> torch.Tensor:
    """The fused tier's float32 values, (B, n_rows), one column per row of
    build_tran_pattern's row order: [R | gc = C/dt | gl = dt/L | g | e |
    f | h | switch 1/max(|Ron|, EPS) | 1/max(|Roff|, EPS) | Von | Voff |
    diode Is | N * VT_300K | MOSFET beta | Vto | lambda | BJT Is | Bf |
    Br | diode TT, CJO, VJ, M, FC | BJT TF, CJE, VJE, MJE, TR, CJC, VJC,
    MJC, FC | 1/dt], from the deck's ``tensors`` and its (batched)
    MOSFET/BJT arrays ``nl``. A device kind the deck lacks gives no rows;
    the charge rows come only with that charge and the 1/dt row with
    either (a linear deck's slab is K8's). Every row is formed in f64 and
    rounded once, so dt never enters the kernels except through that row.
    Unbatched (nX,) values broadcast."""
    t = tensors
    B = r_vals.shape[0]
    dt_c = max(dt, EPS)
    f64 = torch.float64
    dev = r_vals.device

    def to2d(a: torch.Tensor | np.ndarray) -> torch.Tensor:
        a = torch.as_tensor(a, dtype=f64, device=dev)
        return a.expand(B, a.shape[0]) if a.ndim == 1 else a

    cols = [r_vals.to(f64), c_vals.to(f64) / dt_c, dt_c / l_vals.to(f64)]
    cols += [to2d(ext[k]) for k in ("g_gm", "e_gain", "f_gain", "h_r")]
    cols += [to2d(1.0 / np.maximum(np.abs(t.s_ron), EPS)),
             to2d(1.0 / np.maximum(np.abs(t.s_roff), EPS)),
             to2d(t.s_von), to2d(t.s_voff), to2d(t.d_is),
             to2d(np.asarray(t.d_n) * VT_300K)]
    cols += [to2d(nl[k]) for k in ("m_beta", "m_vto", "m_lambda", "q_is",
                                   "q_bf", "q_br")]
    if t.has_d_charge:
        cols += [to2d(a) for a in (t.d_tt, t.d_cjo, t.d_vj, t.d_m, t.d_fc)]
    if t.has_q_charge:
        # b-e block then b-c block (q_chg columns: tf, tr, cje, vje, mje,
        # cjc, vjc, mjc, fc)
        cols += [to2d(t.q_chg[:, j]) for j in (0, 2, 3, 4, 1, 5, 6, 7, 8)]
    if t.has_d_charge or t.has_q_charge:
        cols += [to2d(np.full(1, 1.0 / dt_c))]
    return torch.cat(cols, dim=1).to(torch.float32)


def _nr_mode(tensors, ckt: ParsedCircuit | None = None
             ) -> tuple[str, int]:
    """The Newton exit and pass limit the JAX package gives a deck:
    MOSFETs/BJTs and B sources (those of ``ckt``) iterate to convergence
    (50 passes), the reference's set exits on switch stability (20
    passes, simulateTRAN.ts:151)."""
    if tensors.n_m or tensors.n_q or (ckt is not None and ckt.B):
        return "converged", 50
    return "spicey", MAX_NR_ITERS


def _mc_tran_fused_responses(vs_grid: torch.Tensor, values: torch.Tensor,
                             pattern: mtf.TranPattern, node_idx: int,
                             vd_scale: float = 1.0, nr: str = "spicey",
                             max_nr: int = MAX_NR_ITERS
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 or K9 on the variants' values (``_value_rows``, (B, n_rows)),
    laid out as the kernels' (n_rows, B) slab: V(node) (B, S+1) and
    ``valid`` (B,)."""
    return mtf.mc_tran_fused(
        vs_grid.to(torch.float32).contiguous(), values.T.contiguous(),
        pattern, node_idx, vd_scale=vd_scale, nr=nr, max_nr=max_nr)


def _slice_arrays(tree: object, sl: slice, B: int) -> object:
    """``tree`` (tran_arrays' dict, nested dicts, None) with every value
    tensor that leads with the B variants cut to ``sl``; index tensors and
    unbatched values pass whole."""
    if isinstance(tree, dict):
        return {k: (v if k.endswith(("idx", "pairs"))
                    else _slice_arrays(v, sl, B))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.ndim >= 2 \
            and tree.shape[0] == B:
        return tree[sl]
    return tree


def _mc_tran_loop_responses(vs_grid: torch.Tensor, arr: dict,
                            vt_scale: torch.Tensor | float, plan: dict | None,
                            dt: float, nvar: int, node_idx: int, method: str,
                            integration: str = "be",
                            chunk: int | None = None, nr: str = "spicey"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched time loop (analysis/tran._tran_core with lead (B,)),
    recording only the probed node: V(node) (B, S+1) and ``valid`` (B,).
    ``chunk`` runs the variants in blocks of that many, bounding the
    loop's buffers; only the (B, S+1) response accumulates. ``plan``: the
    structured tier (a lane whose block pivots fail counts as invalid, as
    in the JAX package)."""
    B = arr["r_vals"].shape[0]

    def run_block(sl: slice) -> tuple[torch.Tensor, torch.Tensor]:
        arr_b = _slice_arrays(arr, sl, B)
        vs = vs_grid[:, sl] if vs_grid.ndim == 3 else vs_grid
        xs, _sw, valid, _carry = _tran_core(
            vs, dt, arr_b, nvar, method=method, integration=integration,
            nr=nr, lead=(arr_b["r_vals"].shape[0],), record=node_idx,
            vt_scale=vt_scale, plan=plan)
        return xs.T, valid  # (b, S+1), (b,)

    step = B if chunk is None or chunk >= B else chunk
    blocks = [run_block(slice(s, s + step)) for s in range(0, B, step)]
    if len(blocks) == 1:
        return blocks[0]
    return (torch.cat([v for v, _ in blocks], dim=0),
            torch.cat([v for _, v in blocks], dim=0))


def _tp_solutions(vs_grid: torch.Tensor, dt: float, arr: dict, nvar: int,
                  node_idx: int | None, integration: str = "be"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel-in-time linear transient (analysis/timeparallel.py): one
    affine-map assembly per variant, then every step's state by log-depth
    doubling over the time axis, not S sequential steps.

    ``vs_grid``: (S+1, m) shared or (S+1, B, m) per-variant sources;
    ``arr``: tran_arrays' dict with (B, nE) values, its couplings ``lk``
    (the matrix companion Gamma = c M^{-1} rides the maps). ``integration``
    "be" or "trap" (the doubled state and the BE bootstrap step). A^-1 is
    ``linsolve.inverse``, kernel K3 on the card at every N (the JAX
    package's guard at mc.py:1225-1248 exists because its TPU inverse
    kernel runs out of VMEM past a size; K3 has no N cap, so that guard
    has no counterpart here). Returns (xs, valid): xs (S+1, B) for the
    probed row ``node_idx``, or the full (S+1, B, N) when it is None."""
    r_vals, c_vals, l_vals = arr["r_vals"], arr["c_vals"], arr["l_vals"]
    B = r_vals.shape[0]
    dtype = r_vals.dtype
    dt_c = max(dt, EPS)
    minv = minv_ok = None
    if arr.get("lk") is not None:
        minv, minv_ok = _mutual_inv(l_vals, arr["lk"])   # (B, nL, nL), (B,)
    arr_m = dict(arr, minv=minv)

    # the assembly of the sequential factor-once path (tran.py)
    def assemble(g_c_scale: float, c_l: float) -> torch.Tensor:
        return linear_system_matrix(nvar, (B,), dtype, arr_m,
                                    c_vals * g_c_scale, c_l)

    u = (vs_grid if vs_grid.ndim == 3
         else vs_grid[:, None, :].expand(vs_grid.shape[0], B,
                                         vs_grid.shape[1])).to(dtype)
    i_idx = arr["ext"]["i_idx"]
    if integration == "trap":
        Ainv_start, ok_s = linsolve.inverse(assemble(1.0 / dt_c, dt_c))
        Ainv_main, ok_m = linsolve.inverse(assemble(2.0 / dt_c,
                                                    dt_c / 2.0))
        valid = ok_s & ok_m
        T, R, X, Y, R_start, Y_start = linear_tran_maps_trap(
            Ainv_start, Ainv_main, arr["c_idx"], c_vals, arr["l_idx"],
            l_vals, arr["v_idx"], i_idx, dt_c, nvar, minv=minv)
        xs = linear_tran_solutions(T, R, X, Y, u, record_row=node_idx,
                                   R_start=R_start, Y_start=Y_start)
    else:
        Ainv, valid = linsolve.inverse(assemble(1.0 / dt_c, dt_c))
        T, R, X, Y = linear_tran_maps(
            Ainv, arr["c_idx"], c_vals, arr["l_idx"], l_vals, arr["v_idx"],
            i_idx, dt_c, nvar, minv=minv)
        xs = linear_tran_solutions(T, R, X, Y, u, record_row=node_idx)
    if minv_ok is not None:
        valid = valid & minv_ok
    return xs, valid


def _mc_tran_tp_responses(vs_grid: torch.Tensor, arr: dict, dt: float,
                          nvar: int, node_idx: int, integration: str = "be"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_tp_solutions`` of the probed node: V(node) (B, S+1) and
    ``valid`` (B,), as the sequential loop gives them."""
    xs, valid = _tp_solutions(vs_grid, dt, arr, nvar, node_idx,
                              integration=integration)
    return xs.T, valid


def _check_tran_args(ckt: ParsedCircuit, method: str,
                     precision: str, quantile_method: str,
                     time_parallel: str, integration: str) -> torch.dtype:
    if ckt.tran is None:
        raise ValueError("netlist has no .tran analysis")
    if time_parallel not in ("auto", "never"):
        raise ValueError("time_parallel must be 'auto' or 'never'")
    if integration not in ("be", "trap", "gear2"):
        raise ValueError("integration must be 'be', 'trap' or 'gear2'")
    return _check_args(precision, quantile_method)


def _tran_route(ckt: ParsedCircuit, tensors, r_vals: torch.Tensor,
                c_vals: torch.Tensor, l_vals: torch.Tensor, ext: dict,
                nl: dict, vs_grid: np.ndarray, times: np.ndarray, dt: float,
                v_over: dict, node: str, quantiles, method: str,
                precision: str, integration: str, chunk: int | None,
                quantile_method: str, device: torch.device,
                tl: dict | None = None, time_parallel: str = "auto",
                tp_crossover: float | None = None,
                tp_mem_budget: float | None = None,
                device_put=None) -> _Route:
    """The rest of mc_tran_stats' and mc_tran_sampled's preparation:
    per-variant source values and the route with its inputs (the fused
    kernels' pattern and value rows, or the loop's arrays). ``tl``: the T
    lines (Z0/Td batched or not), None without. The routes in the JAX
    package's order: the fused kernels, then the Schur plan, then the
    time-parallel core, else the loop, each chosen for the whole batch.
    ``device_put``: the variants split over a mesh whose first device is
    ``device``, each piece run on that route, the responses gathered there
    and reduced once."""
    fdt = _DTYPES[precision]
    B = r_vals.shape[0]
    node_idx = [n.upper() for n in tensors.node_names].index(node.upper())
    vs = torch.as_tensor(vs_grid, dtype=fdt, device=device)
    if v_over:
        # time-major (S+1, B, nSrc): one DC value per variant and source
        vs = vs[:, None, :].expand(vs.shape[0], B, vs.shape[1]).clone()
        v_lower = {n.lower(): i for i, n in enumerate(tensors.v_names)}
        for key, vals in v_over.items():
            i = v_lower[key.lower()]
            if tensors.v_has_waveform[i]:
                raise ValueError(
                    f"cannot override waveform-driven source {key!r}")
            vs[:, :, i] = torch.as_tensor(np.asarray(vals, np.float64),
                                          dtype=fdt, device=device)
    nr, max_nr = _nr_mode(tensors, ckt)
    pattern = _fused_tran_pattern(ckt, tensors, method, precision,
                                  integration, bool(v_over), device)
    if device_put is not None and not _batch_mesh(device_put, B):
        pattern = None
    if pattern is not None:
        run = functools.partial(
            _mc_tran_fused_responses, node_idx=node_idx,
            vd_scale=float(tensors.vt) / VT_300K, nr=nr, max_nr=max_nr)
        args = dict(vs_grid=vs, pattern=pattern, values=_value_rows(
            tensors, r_vals, c_vals, l_vals, ext, nl, dt))
    else:
        def cast(d: dict) -> dict:
            return {k: (v if k.endswith("idx") else v.to(fdt))
                    for k, v in d.items()}

        arr = tran_arrays(tensors, device, fdt, r_vals=r_vals.to(fdt),
                          c_vals=c_vals.to(fdt), l_vals=l_vals.to(fdt),
                          ext=cast(ext), nl=cast(nl), tl=tl, ckt=ckt,
                          dt=dt)
        # the structured tier: forced by "schur", auto past N = 128 for
        # "gj"; invalid lanes leave the stats like any other failure
        plan = plan_for(method, ckt, tensors, tensors.nvar, device)
        steps = vs.shape[0] - 1
        if (time_parallel == "auto" and method != "schur" and chunk is None
                and tp_eligible(tensors, ckt, nr, integration)
                and tp_worthwhile(tensors, steps, B, fdt.itemsize,
                                  tp_mem_budget, tp_crossover, integration,
                                  device=device)):
            # a linear circuit in the regime where the whole time axis
            # in O(log S) depth beats the sequential loop
            run = functools.partial(
                _mc_tran_tp_responses, dt=dt, nvar=tensors.nvar,
                node_idx=node_idx, integration=integration)
            args = dict(vs_grid=vs, arr=arr)
        else:
            run = functools.partial(
                _mc_tran_loop_responses, dt=dt, nvar=tensors.nvar,
                node_idx=node_idx,
                method="gj" if method == "schur" else method,
                integration=integration, chunk=chunk, nr=nr)
            args = dict(vs_grid=vs, arr=arr,
                        vt_scale=vt_scale_of(tensors, device, fdt),
                        plan=plan)
    specs = dict.fromkeys(("values", "arr"), VARIANTS)
    specs["vs_grid"] = (None, "batch", None) if vs.ndim == 3 else None
    return _Route(run, args, specs, B, times, tuple(quantiles),
                  quantile_method, device_put)


def mc_tran_stats(
    circuit: ParsedCircuit | str,
    overrides: dict[str, np.ndarray],
    node: str,
    quantiles: tuple[float, ...] = (5.0, 50.0, 95.0),
    tensors=None,
    method: str = "gj",
    precision: str = "f64",
    dialect: str = "spicey",
    quantile_method: str = "exact",
    time_parallel: str = "auto",
    integration: str = "be",
    chunk: int | None = None,
    device: torch.device | str | None = None,
    tp_crossover: float | None = None,
    tp_mem_budget: float | None = None,
    device_put=None,
) -> MCStats:
    """Distribution of V(node) per timestep across parameter variants.

    ``overrides`` maps element names (R/C/L, extended G/E/F/H gains, DC V
    sources, MOSFET/JFET names for their beta, BJT names for their Is)
    to (B,) value arrays. ``precision="f32"`` with ``method="pallas"``
    takes the fused whole-transient kernels (BE, N <= 16): K8 for a
    linear deck, K9 for a nonlinear one; otherwise the batched time loop
    runs (K2 per Newton pass, or K3 once for a linear deck). Decks with
    MOSFETs or BJTs iterate Newton to convergence. ``integration``:
    "be" (reference semantics), "trap" or "gear2". ``chunk`` runs the
    variants in blocks of that size.

    ``time_parallel``: "auto" (default) evaluates a LINEAR circuit
    (BE or trap) with the parallel-in-time core
    (analysis/timeparallel.py, the time axis in O(log S) depth) where
    ``timeparallel.worthwhile`` says the regime fits and no ``chunk`` is
    asked; "never" forces the sequential loop. ``tp_crossover`` and
    ``tp_mem_budget`` tune that guard (or ``SPICEY_TPU_TP_CROSSOVER`` /
    ``SPICEY_TPU_TP_MEM_BUDGET``). ``method="schur"`` forces the
    structured tier (and the loop); ``"gj"`` takes it past N = 128 on a
    subcircuit board.

    ``device_put``: a ``sharder(mesh)`` callable placing the variants axis
    over a device mesh (see mc_ac_stats). The route is chosen for the
    whole batch (the time-parallel guard at the global B); each piece
    runs it (chunked within the piece), except that the fused kernels K8
    and K9 run per device only on a plain 1D 'batch' mesh dividing B, and
    the pieces take the loop or the time-parallel core otherwise."""
    with span("mc_tran_stats"):
        with span("prepare"):
            device = resolve_device(device, device_put)
            ckt = _resolve(circuit, dialect=dialect)
            if tensors is None:
                tensors = build_tensors(ckt)
            fdt = _check_tran_args(ckt, method, precision, quantile_method,
                                   time_parallel, integration)
            B = _batch_size(overrides)
            _consumed([tensors.r_names, tensors.c_names, tensors.l_names,
                       _tl_names(tensors),
                       tensors.v_names, tensors.i_names, tensors.g_names,
                       tensors.e_names, tensors.f_names, tensors.h_names,
                       tensors.m_names, tensors.q_names], overrides)

            def vals(base: np.ndarray, names: tuple) -> torch.Tensor:
                return torch.as_tensor(
                    _batch_values(base, names, overrides, B), dtype=fdt,
                    device=device)

            dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
            times = np.arange(steps + 1, dtype=np.float64) * dt
            v_lower = {n.lower() for n in tensors.v_names}
            route = _tran_route(
                ckt, tensors, vals(tensors.r_vals, tensors.r_names),
                vals(tensors.c_vals, tensors.c_names),
                vals(tensors.l_vals, tensors.l_names),
                _batched_ext(tensors, overrides, B, device, fdt),
                _batched_nl(tensors, overrides, B, device, fdt),
                sample_source_values(ckt, times), times, dt,
                {k: v for k, v in overrides.items() if k.lower() in v_lower},
                node, quantiles, method, precision, integration, chunk,
                quantile_method, device,
                tl=_batched_tl(tensors, overrides, B, device, fdt),
                time_parallel=time_parallel, tp_crossover=tp_crossover,
                tp_mem_budget=tp_mem_budget, device_put=device_put)
        return _solve_reduce_fetch(route)


def mc_tran_sampled(
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
    time_parallel: str = "auto",
    integration: str = "be",
    device: torch.device | str | None = None,
    tp_crossover: float | None = None,
    tp_mem_budget: float | None = None,
) -> MCStats:
    """Transient yield analysis with ON-DEVICE parameter sampling, the
    time-domain twin of mc_ac_sampled: ``spreads`` maps R/C/L element
    names to relative sigmas, B variants are drawn by a
    ``torch.Generator`` on ``device`` seeded with ``key`` (other draws
    than the JAX package's ``jax.random`` for the same key), then the
    routes and options of mc_tran_stats."""
    with span("mc_tran_sampled"):
        with span("prepare"):
            device = resolve_device(device)
            ckt = _resolve(circuit, dialect=dialect)
            if tensors is None:
                tensors = build_tensors(ckt)
            fdt = _check_tran_args(ckt, method, precision, quantile_method,
                                   time_parallel, integration)
            targets = _sample_targets(tensors, spreads)
            gen = torch.Generator(device=device)
            gen.manual_seed(int(key))
            z = torch.randn((B, len(targets)), generator=gen,
                            dtype=torch.float64, device=device)
            vals = _spread_values(tensors, targets, z, dist)
            dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
            times = np.arange(steps + 1, dtype=np.float64) * dt
            route = _tran_route(
                ckt, tensors, vals["r"], vals["c"], vals["l"],
                ext_arrays(tensors, device, fdt),
                nl_arrays(tensors, device, fdt),
                sample_source_values(ckt, times), times, dt, {}, node,
                quantiles, method, precision, integration, chunk,
                quantile_method, device, tl=tl_arrays(tensors, device, fdt),
                time_parallel=time_parallel, tp_crossover=tp_crossover,
                tp_mem_budget=tp_mem_budget)
        return _solve_reduce_fetch(route)
