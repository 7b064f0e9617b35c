"""Parallel-in-time linear transient: the whole time axis in O(log S) depth.

A port of ``spicey_tpu/analysis/timeparallel.py``. For a LINEAR circuit
under backward Euler the engine's per-step recurrence (tran.py's
factor-once path) is an affine map on the companion state
s = [v_prev_C | i_prev_L]:

    x_t     = X s_t + Y u_t          (solution at step t)
    s_{t+1} = T s_t + R u_t          (companion-state commit)

with T, R, X, Y assembled ONCE per variant from A^{-1} (kernel K3 on the
card) and the stamp selection matrices. The sequential loop walks this
chain in S dependent steps; affine maps compose associatively, so every
prefix can be evaluated in O(log S) depth instead. The JAX package does
that with ``lax.associative_scan``; torch has no associative scan, and
``affine_prefix_states`` writes it out as log-depth doubling (below).
The state dimension k = nC + nL is tiny, so the (B, k, k) products are
cheap; exactness is the same recurrence, reassociated (differences from
the sequential path are rounding, ~sqrt(S) eps).

Eligibility (callers run the sequential core otherwise): linear elements
only (no switches, diodes, MOSFETs, BJTs, B sources), no transmission
lines, backward Euler or trapezoidal integration, the reference's
inner-loop semantics. K-coupled inductors are eligible: the state-update
rows use Gamma = dt M^{-1} (tran._mutual_inv) instead of dt / L.

Trapezoidal runs carry the doubled state s = [v_C | i_C | i_L | v_L] and
the engine's backward-Euler bootstrap step: since s_0 = 0 only the step-0
offset R_start u_0 and output Y_start u_0 come from the BE matrix, every
later step composes the trap maps.

The regime guard ``worthwhile`` and its knobs are the JAX package's: the
crossover (``SPICEY_TPU_TP_CROSSOVER``, default 32, a figure measured on
the JAX package's TPU) and the memory budget (``SPICEY_TPU_TP_MEM_BUDGET``;
otherwise a quarter of the card's memory, or the JAX package's 2e9 bytes
on the CPU, so the CPU routes match the JAX package's). The guard's
memory model is the JAX scan's, kept so the two packages route alike;
this port's doubling holds far less (one (..., k, S+1) offset array).
"""

from __future__ import annotations

import os

import torch


def _sel(rows_idx: torch.Tensor, n_items: int, nvar: int,
         dtype: torch.dtype) -> torch.Tensor:
    """(N, n_items) selection: column j = e_{i1(j)} - e_{i2(j)} with the
    ground dump slot dropped."""
    S = torch.zeros((nvar + 1, n_items), dtype=dtype, device=rows_idx.device)
    cols = torch.arange(n_items, device=rows_idx.device)
    one = torch.ones(n_items, dtype=dtype, device=rows_idx.device)
    S.index_put_((rows_idx[:, 0], cols), one, accumulate=True)
    S.index_put_((rows_idx[:, 1], cols), -one, accumulate=True)
    return S[:nvar]


def _source_matrix(v_idx: torch.Tensor, i_idx: torch.Tensor, nvar: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Bu: (N, m) mapping u = [V volts | I amps] to RHS injections: V on
    its branch row, I through stamp_current (b[i1] -= u, b[i2] += u)."""
    n_v = v_idx.shape[0]
    Bu_v = torch.zeros((nvar + 1, n_v), dtype=dtype, device=v_idx.device)
    Bu_v.index_put_((v_idx[:, 2], torch.arange(n_v, device=v_idx.device)),
                    torch.ones(n_v, dtype=dtype, device=v_idx.device),
                    accumulate=True)
    Bu_i = -_sel(i_idx, i_idx.shape[0], nvar, dtype)
    return torch.cat([Bu_v[:nvar], Bu_i], dim=-1)


def _gamma_rows(Dl: torch.Tensor, c_l: float, l_vals: torch.Tensor,
                minv: torch.Tensor | None) -> torch.Tensor:
    """c_l M^{-1} @ Dl, the inductor state-update rows (..., nL, N):
    scalar c_l / L per element, or the matrix companion with K coupling."""
    if minv is None:
        return (c_l / l_vals)[..., :, None] * Dl
    return c_l * (minv @ Dl)


def linear_tran_maps(Ainv: torch.Tensor, c_idx: torch.Tensor,
                     c_vals: torch.Tensor, l_idx: torch.Tensor,
                     l_vals: torch.Tensor, v_idx: torch.Tensor,
                     i_idx: torch.Tensor, dt: float, nvar: int,
                     minv: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, ...]:
    """(T, R, X, Y) of the BE affine recurrence.

    Ainv: (..., N, N) inverse of the BE system matrix; c_vals/l_vals
    (..., nC)/(..., nL); u = [V-source volts | I-source amps] ordered as
    the engine's source grid; ``minv`` (..., nL, nL) with K couplings.
    Returns T (..., k, k), R (..., k, m), X (..., N, k), Y (..., N, m),
    k = nC + nL, m = nV + nI."""
    dtype = Ainv.dtype
    lead = Ainv.shape[:-2]
    n_c, n_l = c_idx.shape[0], l_idx.shape[0]
    k = n_c + n_l

    # b(s, u) = Bs s + Bu u: C injects (C/dt) v_prev on its pattern, L
    # injects -i_prev
    g_c = c_vals / dt
    Bs_c = _sel(c_idx, n_c, nvar, dtype) * g_c[..., None, :]
    Bs_l = -_sel(l_idx, n_l, nvar, dtype)
    Bs = torch.cat([Bs_c.expand(lead + (nvar, n_c)),
                    Bs_l.expand(lead + (nvar, n_l))], dim=-1)
    Bu = _source_matrix(v_idx, i_idx, nvar, dtype)

    X = Ainv @ Bs                                         # (..., N, k)
    Y = Ainv @ Bu                                         # (..., N, m)

    # s' = Sx x + Ss s: v_prev' = vdrop_C(x); i_prev' = i_prev + dt M^-1
    # vdrop_L(x)
    Dc = _sel(c_idx, n_c, nvar, dtype).T                  # (nC, N)
    Dl = _sel(l_idx, n_l, nvar, dtype).T                  # (nL, N)
    Sx_l = _gamma_rows(Dl, dt, l_vals, minv)              # (..., nL, N)
    Sx = torch.cat([Dc.expand(lead + (n_c, nvar)),
                    Sx_l.expand(lead + (n_l, nvar))], dim=-2)
    Ss = torch.zeros((k, k), dtype=dtype, device=Ainv.device)
    rl = torch.arange(n_c, k, device=Ainv.device)
    Ss[rl, rl] = 1.0

    T = Sx @ X + Ss                                       # (..., k, k)
    R = Sx @ Y                                            # (..., k, m)
    return T, R, X, Y


def linear_tran_maps_trap(Ainv_start: torch.Tensor, Ainv_main: torch.Tensor,
                          c_idx: torch.Tensor, c_vals: torch.Tensor,
                          l_idx: torch.Tensor, l_vals: torch.Tensor,
                          v_idx: torch.Tensor, i_idx: torch.Tensor,
                          dt: float, nvar: int,
                          minv: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, ...]:
    """Affine maps for TRAPEZOIDAL integration with the engine's BE
    bootstrap step (tran._stamp_system, integration="trap").

    State s = [v_C | i_C | i_L | v_L], k = 2 (nC + nL). Steps >= 1 use
    the trap companions
        C: G = 2C/dt,  b += sel_C (G v_C + i_C)
        L: G = (dt/2) M^{-1},  b -= sel_L (i_L + (dt/2) M^{-1} v_L)
    and commit
        v_C' = Dc x;  i_C' = G (Dc x - v_C) - i_C
        i_L' = i_L + (dt/2) M^{-1} (v_L + Dl x);  v_L' = Dl x.
    Step 0 solves the BE matrix (Ainv_start) and commits with the
    bootstrap branches (i_C' = (C/dt) Dc x, i_L' = i_L + dt M^{-1} Dl x);
    since s_0 = 0 only its input map matters, R_start = Sx_start Y_start.

    Returns (T, R, X, Y, R_start, Y_start)."""
    dtype = Ainv_main.dtype
    dev = Ainv_main.device
    lead = Ainv_main.shape[:-2]
    n_c, n_l = c_idx.shape[0], l_idx.shape[0]
    k = 2 * (n_c + n_l)
    half = dt / 2.0

    sel_c = _sel(c_idx, n_c, nvar, dtype)                 # (N, nC)
    sel_l = _sel(l_idx, n_l, nvar, dtype)                 # (N, nL)
    Dc, Dl = sel_c.T, sel_l.T
    g_c = 2.0 * c_vals / dt                               # (..., nC)

    Bs_vc = sel_c * g_c[..., None, :]
    # b -= sel_L (dt/2) M^{-1} v_L
    if minv is None:
        Bs_vl = -sel_l * (half / l_vals)[..., None, :]
    else:
        Bs_vl = -(sel_l @ (half * minv))
    Bs = torch.cat([Bs_vc.expand(lead + (nvar, n_c)),
                    sel_c.expand(lead + (nvar, n_c)),
                    (-sel_l).expand(lead + (nvar, n_l)),
                    Bs_vl.expand(lead + (nvar, n_l))], dim=-1)
    Bu = _source_matrix(v_idx, i_idx, nvar, dtype)

    X = Ainv_main @ Bs                                    # (..., N, k)
    Y = Ainv_main @ Bu                                    # (..., N, m)
    Y_start = Ainv_start @ Bu

    # Sx: coefficient of x in s' (rows ordered as the state)
    gamma_half = _gamma_rows(Dl, half, l_vals, minv)      # (..., nL, N)
    Sx = torch.cat([Dc.expand(lead + (n_c, nvar)),
                    (g_c[..., :, None] * Dc).expand(lead + (n_c, nvar)),
                    gamma_half.expand(lead + (n_l, nvar)),
                    Dl.expand(lead + (n_l, nvar))], dim=-2)
    # Ss: coefficient of s in s'
    Ss = torch.zeros(lead + (k, k), dtype=dtype, device=dev)
    rc = torch.arange(n_c, device=dev)
    rl = torch.arange(n_l, device=dev)
    # i_C' rows: -G on v_C, -1 on i_C
    Ss[..., n_c + rc, rc] -= g_c.expand(lead + (n_c,))
    Ss[..., n_c + rc, n_c + rc] -= 1.0
    # i_L' rows: +1 on i_L, (dt/2) M^{-1} on v_L
    Ss[..., 2 * n_c + rl, 2 * n_c + rl] += 1.0
    if minv is None:
        Ss[..., 2 * n_c + rl, 2 * n_c + n_l + rl] += \
            (half / l_vals).expand(lead + (n_l,))
    else:
        Ss[..., 2 * n_c:2 * n_c + n_l, 2 * n_c + n_l:] += \
            (half * minv).expand(lead + (n_l, n_l))

    T = Sx @ X + Ss                                       # (..., k, k)
    R = Sx @ Y                                            # (..., k, m)

    # step-0 commit: the BE bootstrap branches applied to x_0 = Y_start u_0
    gamma_full = _gamma_rows(Dl, dt, l_vals, minv)
    Sx_start = torch.cat([Dc.expand(lead + (n_c, nvar)),
                          ((c_vals / dt)[..., :, None] * Dc).expand(
                              lead + (n_c, nvar)),
                          gamma_full.expand(lead + (n_l, nvar)),
                          Dl.expand(lead + (n_l, nvar))], dim=-2)
    R_start = Sx_start @ Y_start                          # (..., k, m)
    return T, R, X, Y, R_start, Y_start


def affine_prefix_states(T: torch.Tensor, Ru_tl: torch.Tensor
                         ) -> torch.Tensor:
    """All companion states s_t for t = 0..S from s_0 = 0, time last.

    T: (..., k, k), one map per variant; Ru_tl: (..., k, S+1), the
    per-step offsets R u_t. Returns s (..., k, S+1) with s_0 = 0 and
    s_{t+1} = T s_t + Ru_t.

    The composition of the affine maps (T, c_t) is associative, and the
    JAX package evaluates every prefix with ``lax.associative_scan``.
    Here it is log-depth doubling (Hillis-Steele) written out: after the
    pass at offset o, entry t holds the composition of entries
    max(0, t - 2o + 1)..t, c_t <- c_t + T^o c_{t-o}. Because T is one map
    for every step, the composed matrix of a full span of o steps is T^o
    at every t >= o, so only that power is kept (squared once a pass),
    not a (..., k, k, S+1) array of prefix matrices: ceil(log2(S+1))
    passes, each one batched (k, k) x (k, S+1-o) product per variant.
    Time stays the last (contiguous) axis, so each pass streams it.
    Differences from the sequential loop are rounding only."""
    c = Ru_tl.clone()
    n_steps = c.shape[-1]
    P = T
    o = 1
    while o < n_steps:
        c[..., o:] = c[..., o:] + P @ c[..., :-o]
        o *= 2
        if o < n_steps:
            P = P @ P
    # c[..., t] = s_{t+1} (the cumulative affine map applied to s_0 = 0)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def linear_tran_solutions(T: torch.Tensor, R: torch.Tensor, X: torch.Tensor,
                          Y: torch.Tensor, u_grid: torch.Tensor,
                          record_row: int | None = None,
                          R_start: torch.Tensor | None = None,
                          Y_start: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """x_t for every step. u_grid: (S+1, ..., m). With ``record_row`` (an
    int) returns that solution row only, (S+1, ...); otherwise the full
    (S+1, ..., N).

    ``R_start``/``Y_start`` (trap): step 0 is the engine's BE bootstrap
    solve, its offset into s_1 from R_start and its output from Y_start
    (s_0 = 0, so no X_start term exists)."""
    u_tl = torch.movedim(u_grid, 0, -1)                   # (..., m, S+1)
    Ru = R @ u_tl                                         # (..., k, S+1)
    if R_start is not None:
        Ru[..., 0] = (R_start @ u_grid[0][..., None])[..., 0]
    s = affine_prefix_states(T, Ru)                       # (..., k, S+1)
    if record_row is not None:
        Xr = X[..., record_row:record_row + 1, :]         # (..., 1, k)
        Yr = Y[..., record_row:record_row + 1, :]
        x = (Xr @ s + Yr @ u_tl)[..., 0, :]               # (..., S+1)
        if Y_start is not None:
            x[..., 0] = (Y_start[..., record_row, :] * u_grid[0]).sum(-1)
        return torch.movedim(x, -1, 0)                    # (S+1, ...)
    x = X @ s + Y @ u_tl                                  # (..., N, S+1)
    if Y_start is not None:
        x[..., 0] = (Y_start @ u_grid[0][..., None])[..., 0]
    return torch.movedim(x, -1, 0)                        # (S+1, ..., N)


def eligible(tensors: object, ckt: object, nr: str,
             integration: str) -> bool:
    """Can this run take the parallel-in-time path? Linear circuits only
    (K-coupled inductors are linear: their matrix companion rides the
    affine map), BE or trapezoidal integration, the reference's inner-loop
    semantics. gear2's two-step history stays on the sequential core."""
    return (tensors.n_s == 0 and tensors.n_d == 0 and tensors.n_m == 0
            and tensors.n_q == 0 and tensors.n_t == 0
            and not ckt.B and integration in ("be", "trap")
            and nr == "spicey")


def default_mem_budget(device: torch.device | str | None = None) -> float:
    """Memory budget of the time-parallel path's intermediates.

    ``SPICEY_TPU_TP_MEM_BUDGET`` (bytes) when set; else a quarter of the
    CUDA ``device``'s memory; else (the CPU) the JAX package's 2e9-byte
    fallback, so the CPU routes match the JAX package's."""
    env = os.environ.get("SPICEY_TPU_TP_MEM_BUDGET")
    if env:
        return float(env)
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).total_memory / 4.0
    return 2e9


def default_crossover() -> float:
    """The sequential loop's under-utilization crossover (see
    ``worthwhile``): ``SPICEY_TPU_TP_CROSSOVER`` when set, else the JAX
    package's 32."""
    env = os.environ.get("SPICEY_TPU_TP_CROSSOVER")
    return float(env) if env else 32.0


def worthwhile(tensors: object, steps: int, B: int, itemsize: int,
               mem_budget_bytes: float | None = None,
               crossover: float | None = None,
               integration: str = "be",
               device: torch.device | str | None = None) -> bool:
    """Is the parallel-in-time path the right regime for this workload?
    The JAX package's two conditions, unchanged: (a) the sequential loop
    under-utilizes the device, (S+1) * crossover > B; (b) the scan's
    intermediates fit, 3 (S+1) B (k+1) k_pad itemsize bytes (k_pad: k
    rounded up to 8) under the budget. ``device`` picks the default
    budget (``default_mem_budget``)."""
    if mem_budget_bytes is None:
        mem_budget_bytes = default_mem_budget(device)
    if crossover is None:
        crossover = default_crossover()
    k = tensors.n_c + tensors.n_l
    if integration == "trap":
        k *= 2  # s = [v_C | i_C | i_L | v_L] (linear_tran_maps_trap)
    k_pad = -(-k // 8) * 8
    mem = 3.0 * (steps + 1) * B * (k + 1.0) * k_pad * itemsize
    return (steps + 1) * crossover > B and mem < mem_budget_bytes
