"""Fused Monte-Carlo whole transients: kernels K8 (csrc/mc_tran_fused.cu)
and K9 (csrc/mc_tran_nr.cu).

K8 replaces ``spicey_tpu/ops/pallas_mc_tran.py:_fused_tran_kernel``, the
linear branch of ``mc_tran_fused_f32``. For a linear circuit under
backward-Euler companions the MNA matrix is the same at every step, so
per variant the kernel builds A from the static stamp pattern and the
(n_rows, B) value slab, reduces [A | I] once, and runs all S+1 steps
with only the RHS changing; only the values go in and the (S+1, B)
trajectory of V(node) comes out.

K9 replaces ``_fused_tran_nr_kernel``, the nonlinear branch: switches,
diodes (with TT/CJO charge), MOSFETs/JFETs and BJTs (with junction
charge). The matrix depends on the state, so per step and variant it
runs up to ``max_nr`` passes of rebuild (the cached state-independent
part plus the device companions) and solve, with the reference's exit on
switch stability (``nr="spicey"``) or Newton to convergence
(``nr="converged"``, M/Q decks). Both kernels are f32 only, as the JAX
tier.

``build_tran_pattern`` is the JAX function; its value rows are [R | gc =
C/dt | gl = dt/L | g | e | f | h] and then K9's device rows.
``pack_tran_pattern`` flattens it into int32 tables the way K5's pattern
is packed (``mc_ac_fused.pack_entries``), with A's entries placed in the
[A | I] layout K8 reduces or in K9's (n, n) state-independent part, and
the device lists as tables the kernel reads at run time.
``mc_tran_fused_plain`` and ``mc_tran_fused_nr_plain`` are the plain
PyTorch versions, with the kernels' sum and stamp orders.

Each kernel runs in one of two forms, chosen by N (``k8_form_for``,
``k9_form_for``): "register" (the system's elimination in the thread's
registers, N a template constant up to ``K8_REG_MAX_N`` / ``K9_REG_MAX_N``)
and "shared" (the system in shared memory, indexed at run time, up to
``FUSED_MAX_N``); ``K8_FORMS`` / ``K9_FORMS`` count each form's launches,
and a ``form=`` argument forces one (tests, ``chip_smoke.py`` and the
profiles only). Both kernels take their block size from ``launch_plan``,
made from the variants, the card's SMs and the resident blocks per SM the
kernel's library reports for each block size.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import DIODE_VD_MAX, DIODE_VD_MIN, EPS, GMIN, VT_300K
from ..models.devices import bjt_ebers_moll, diode_charge_cap, mos_level1
from ._build import SMEM_MAX, Kernel, check, load, ptr, stream_ptr
from .linsolve import gj_inverse, gj_solve
from .mc_ac_fused import KINDS, int32_table, pack_entries

# the fused tier's eligibility bound, as in the JAX package
FUSED_MAX_N = 16

# the forms of K8 and K9 (the C side's form codes, in order): the system's
# elimination in the thread's registers, N a template constant; the system
# in shared memory, N at run time
FORMS = ("register", "shared")
# the largest N of a register instance of either kernel
# (mc_tran_fused.cu:REG_MAX_N, mc_tran_nr.cu:REG_MAX_N)
REG_MAX_N = 8
# The crossovers: the register form up to these N, the shared form above.
# Measured by tools/profile_torch_k9.py (RC ladders of N = 3-10 under a
# pulse, a diode at the end for K9, 65,536 variants x 201 steps) on an
# NVIDIA H100 80GB HBM3 at 700.00 W: the register form won at every N it
# has an instance for, in both kernels (N = 8: K9 5.53 against 13.81 ms,
# K8 0.52 against 1.25 ms), so both take it to its last instance.
K8_REG_MAX_N = 8
K9_REG_MAX_N = 8
# the block sizes a launch plan weighs
BLOCK_SIZES = (256, 128, 64, 32)

K8 = {torch.float32: Kernel(name="mc_tran_fused_f32",
                            source="spicey_tpu_torch/csrc/mc_tran_fused.cu",
                            replaces="spicey_tpu/ops/pallas_mc_tran.py:789")}
K9 = {torch.float32: Kernel(name="mc_tran_nr_f32",
                            source="spicey_tpu_torch/csrc/mc_tran_nr.cu",
                            replaces="spicey_tpu/ops/pallas_mc_tran.py:345")}
# launches of each form (K8 and K9 count their sums)
K8_FORMS = dict.fromkeys(FORMS, 0)
K9_FORMS = dict.fromkeys(FORMS, 0)


def _form_for(n: int, reg_max_n: int, what: str) -> str:
    if not 1 <= n <= FUSED_MAX_N:
        raise ValueError(f"{what} takes 1 <= N <= {FUSED_MAX_N}, got N={n}")
    return "register" if n <= reg_max_n else "shared"


def k8_form_for(n: int) -> str:
    """K8's form for systems of n unknowns: "register" up to
    ``K8_REG_MAX_N``, else "shared"."""
    return _form_for(n, K8_REG_MAX_N, "K8")


def k9_form_for(n: int) -> str:
    """K9's form for systems of n unknowns: "register" up to
    ``K9_REG_MAX_N``, else "shared"."""
    return _form_for(n, K9_REG_MAX_N, "K9")


def k8_bytes_per_variant(form: str, n: int, n_c: int, n_l: int) -> int:
    """Shared-memory bytes of one variant in K8's ``form``, the copy of
    ``mc_tran_fused.cu:region_floats``: [A | I] (n x 2n); the shared
    form's rhs and x (n each) and per C (per L) v_prev (i_prev); the
    register form's rhs (n) and per C (per L) gc (gl), read once, and
    v_prev (i_prev), its x in A's place."""
    if form == "register":
        return 4 * (2 * n * n + n + 2 * (n_c + n_l))
    return 4 * (2 * n * n + 2 * n + n_c + n_l)


def fits_32_variants(per_variant: int) -> bool:
    """Whether 32 variants of ``per_variant`` shared-memory bytes (one
    warp's slice) fit one block; the wrappers refuse a deck that does
    not."""
    return 32 * per_variant <= SMEM_MAX


def warp_slots(tpb: int) -> int:
    """Variant regions a block of ``tpb`` threads takes in K8 and K9: a
    warp's 32 variants interleave in its slice of shared memory, so a
    block holds whole warps' slices (mc_tran_*.cu:warp_slots)."""
    return -(-tpb // 32) * 32


def k9_bytes_per_variant(form: str, n: int, n_c: int, n_l: int, n_s: int,
                         n_d: int, n_m: int, n_q: int, has_dchg: bool,
                         has_qchg: bool) -> int:
    """Shared-memory bytes of one variant in K9's ``form``, the copy of
    ``mc_tran_nr.cu:region_floats``: the shared form's state-independent
    part (n x n; the register form keeps it in registers), [A | b] (n x
    (n + 1)), x, b_lin and the device terms (n each), then the carried
    state: v_prev, i_prev, the diode, MOSFET (2) and BJT (2) seeds, the
    junction charges and the switch states."""
    floats = ((n * n if form == "shared" else 0) + n * (n + 1) + 3 * n
              + n_c + n_l + n_d + 2 * n_m + 2 * n_q
              + (n_d if has_dchg else 0) + (2 * n_q if has_qchg else 0) + n_s)
    return 4 * floats


@dataclass(frozen=True)
class LaunchPlan:
    """A one-thread-per-variant launch: ``tpb`` threads a block,
    ``blocks`` blocks, ``resident`` of them at once on an SM (the
    occupancy API's figure at ``tpb``), ``n_sm`` SMs; ``waves`` = blocks
    over the card's resident slots."""

    tpb: int
    blocks: int
    resident: int
    n_sm: int

    @property
    def waves(self) -> float:
        return self.blocks / (self.n_sm * self.resident)

    @property
    def last_wave_blocks(self) -> int:
        """Blocks of the last wave (all of them in a launch of one)."""
        slots = self.n_sm * self.resident
        return self.blocks - (math.ceil(self.blocks / slots) - 1) * slots


def launch_plan(B: int, n_sm: int, resident: dict[int, int]) -> LaunchPlan:
    """The block size of a one-thread-per-variant launch of B variants on
    ``n_sm`` SMs, from ``resident`` (block size -> resident blocks per SM,
    the occupancy API's figures for ``BLOCK_SIZES``).

    Of the sizes with the most resident threads per SM, the largest whose
    last wave reaches every SM (or that needs one wave), else the
    smallest: a launch of several waves whose last wave holds fewer blocks
    than there are SMs leaves SMs idle while the others finish it. When B
    variants cannot give every SM a block of that size, the block shrinks
    to the largest size that can, down to B // n_sm threads (one warp,
    partly used, holding the residency of the smallest size), so that
    every SM gets one."""
    fits = {t: r for t, r in resident.items() if r >= 1}
    if not fits:
        raise ValueError("no block size fits a block on an SM")
    most = max(t * r for t, r in fits.items())
    best = sorted(t for t, r in fits.items() if t * r == most)

    def plan(tpb: int) -> LaunchPlan:
        return LaunchPlan(tpb=tpb, blocks=max(1, -(-B // tpb)),
                          resident=fits.get(tpb, fits[min(fits)]),
                          n_sm=n_sm)

    spread = [t for t in best
              if plan(t).waves <= 1 or plan(t).last_wave_blocks >= n_sm]
    tpb = max(spread) if spread else best[0]
    if 0 < B < n_sm * tpb:
        smaller = [t for t in fits if t <= B // n_sm]
        tpb = max(smaller) if smaller else max(1, B // n_sm)
    return plan(tpb)


_N_SM: dict[int, int] = {}
_RESIDENT: dict[tuple, dict[int, int]] = {}


def _plan(fn, key: tuple, form: str, n: int, per_variant: int, B: int,
          device: torch.device) -> LaunchPlan:
    """The launch plan of a kernel whose library function ``fn`` reports
    the resident blocks per SM of (form, n, tpb, smem bytes); the figures
    are cached per (``key``, device)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _N_SM:
        _N_SM[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    key = key + (form, n, per_variant, index)
    if key not in _RESIDENT:
        res = {}
        with torch.cuda.device(index):
            for tpb in BLOCK_SIZES:
                smem = warp_slots(tpb) * per_variant
                if smem > SMEM_MAX:
                    continue
                got = fn(FORMS.index(form), n, tpb, smem)
                if got < 0:
                    check(-got, f"{key[0]} occupancy")
                res[tpb] = got
        _RESIDENT[key] = res
    return launch_plan(B, _N_SM[index], _RESIDENT[key])


def build_tran_pattern(n: int, r_idx: object, c_idx: object, l_idx: object,
                       v_idx: object, n_src_i: int,
                       ext_idx: dict | None = None, s_idx: object = None,
                       d_idx: object = None, m_idx: object = None,
                       m_pol: object = None, q_idx: object = None,
                       q_pol: object = None, d_chg: bool = False,
                       q_chg: bool = False) -> tuple:
    """Static pattern of a deck, the JAX package's ``build_tran_pattern``
    (pallas_mc_tran.py:74-242): (n_rows, a_entries, b_src, c_state,
    l_state, s_list, d_list, m_list, q_list, dchg_list, qchg_list,
    row_invdt).

    Value rows: [R | gc = C/dt | gl = dt/L | g | e | f | h | s_gon |
    s_goff | s_von | s_voff | d_is | d_vth | m_beta | m_vto | m_lam | q_is
    | q_bf | q_br | (d_tt | d_cjo | d_vj | d_m | d_fc) | (q_tf | q_cje |
    q_vje | q_mje | q_tr | q_cjc | q_vjc | q_mjc | q_fc) | (inv_dt)], the
    charge rows only with ``d_chg``/``q_chg`` and the 1/dt row with
    either. ``a_entries`` is ((i, j), terms) with term kinds
    "one"/"inv"/"lin"; ``b_src`` is (row, src_col, sign) into the (S+1,
    nSrc) source grid (V branch values first, then I injections);
    ``c_state``/``l_state`` are (elem, i1, i2, value_row) with dump-slot
    indices kept (>= n is ground). The state-dependent stamps: ``s_list``
    (i1, i2, icp, icn, row_gon, row_goff, row_von, row_voff), ``d_list``
    (ip, im, row_is, row_vth), ``m_list`` (d, g, s, row_beta, row_vto,
    row_lam, pol), ``q_list`` (c, b, e, row_is, row_bf, row_br, pol),
    ``dchg_list`` per diode (row_tt, row_cjo, row_vj, row_m, row_fc),
    ``qchg_list`` per BJT (row_tf, row_cje, row_vje, row_mje, row_tr,
    row_cjc, row_vjc, row_mjc, row_fc), and ``row_invdt`` (-1 without
    charge)."""
    a_t: dict = {}

    def add(i: int, j: int, term: tuple) -> None:
        if i < n and j < n:
            a_t.setdefault((int(i), int(j)), []).append(term)

    def adm(idx: object, kind: str, base: int) -> None:
        for k, (i1, i2) in enumerate(np.asarray(idx).reshape(-1, 2)):
            for (a, b, s) in ((i1, i1, 1.0), (i2, i2, 1.0),
                              (i1, i2, -1.0), (i2, i1, -1.0)):
                add(a, b, (kind, base + k, s))

    def rows_of(idx: object, width: int) -> np.ndarray:
        return (np.asarray(idx).reshape(-1, width) if idx is not None
                else np.zeros((0, width), np.int64))

    c = np.asarray(c_idx).reshape(-1, 2)
    l_arr = np.asarray(l_idx).reshape(-1, 2)
    v = np.asarray(v_idx).reshape(-1, 3)
    n_r, n_c, n_l, n_v = (np.asarray(r_idx).reshape(-1, 2).shape[0],
                          c.shape[0], l_arr.shape[0], v.shape[0])
    off_gc, off_gl = n_r, n_r + n_c
    adm(r_idx, "inv", 0)
    adm(c_idx, "lin", off_gc)
    adm(l_idx, "lin", off_gl)
    b_src = []
    for k, (i1, i2, j) in enumerate(v):
        for (a, b, s) in ((i1, j, 1.0), (j, i1, 1.0),
                          (i2, j, -1.0), (j, i2, -1.0)):
            add(a, b, ("one", 0, s))
        b_src.append((int(j), k, 1.0))
    # extended I sources: columns n_v.. of the source grid
    # (stampCurrent*.ts: b[i1] -= I, b[i2] += I)
    base = n_r + n_c + n_l
    ii = (np.asarray(ext_idx["i_idx"]).reshape(-1, 2)
          if ext_idx else np.zeros((0, 2), np.int64))
    for k in range(n_src_i):
        i1, i2 = (int(ii[k, 0]), int(ii[k, 1]))
        if i1 < n:
            b_src.append((i1, n_v + k, -1.0))
        if i2 < n:
            b_src.append((i2, n_v + k, 1.0))
    if ext_idx:
        gi = np.asarray(ext_idx["g_idx"]).reshape(-1, 4)
        for k, (i1, i2, cp, cn) in enumerate(gi):
            for (a, b, s) in ((i1, cp, 1.0), (i1, cn, -1.0),
                              (i2, cp, -1.0), (i2, cn, 1.0)):
                add(a, b, ("lin", base + k, s))
        base += gi.shape[0]
        ei = np.asarray(ext_idx["e_idx"]).reshape(-1, 5)
        for k, (i1, i2, j, cp, cn) in enumerate(ei):
            for (a, b, s) in ((i1, j, 1.0), (i2, j, -1.0),
                              (j, i1, 1.0), (j, i2, -1.0)):
                add(a, b, ("one", 0, s))
            for (a, b, s) in ((j, cp, -1.0), (j, cn, 1.0)):
                add(a, b, ("lin", base + k, s))
        base += ei.shape[0]
        fi = np.asarray(ext_idx["f_idx"]).reshape(-1, 3)
        for k, (i1, i2, j) in enumerate(fi):
            for (a, b, s) in ((i1, j, 1.0), (i2, j, -1.0)):
                add(a, b, ("lin", base + k, s))
        base += fi.shape[0]
        hi = np.asarray(ext_idx["h_idx"]).reshape(-1, 4)
        for k, (i1, i2, j, jc) in enumerate(hi):
            for (a, b, s) in ((i1, j, 1.0), (i2, j, -1.0),
                              (j, i1, 1.0), (j, i2, -1.0)):
                add(a, b, ("one", 0, s))
            add(j, jc, ("lin", base + k, -1.0))
        base += hi.shape[0]
    s_arr, d_arr = rows_of(s_idx, 4), rows_of(d_idx, 2)
    n_s, n_d = s_arr.shape[0], d_arr.shape[0]
    s_list = tuple(
        (int(s_arr[k, 0]), int(s_arr[k, 1]), int(s_arr[k, 2]),
         int(s_arr[k, 3]), base + k, base + n_s + k, base + 2 * n_s + k,
         base + 3 * n_s + k)
        for k in range(n_s))
    base += 4 * n_s
    d_list = tuple((int(d_arr[k, 0]), int(d_arr[k, 1]), base + k,
                    base + n_d + k) for k in range(n_d))
    base += 2 * n_d
    m_arr, q_arr = rows_of(m_idx, 3), rows_of(q_idx, 3)
    n_m, n_q = m_arr.shape[0], q_arr.shape[0]
    m_pols = np.asarray(m_pol if m_pol is not None else []).reshape(-1)
    q_pols = np.asarray(q_pol if q_pol is not None else []).reshape(-1)
    m_list = tuple(
        (int(m_arr[k, 0]), int(m_arr[k, 1]), int(m_arr[k, 2]), base + k,
         base + n_m + k, base + 2 * n_m + k, float(m_pols[k]))
        for k in range(n_m))
    base += 3 * n_m
    q_list = tuple(
        (int(q_arr[k, 0]), int(q_arr[k, 1]), int(q_arr[k, 2]), base + k,
         base + n_q + k, base + 2 * n_q + k, float(q_pols[k]))
        for k in range(n_q))
    base += 3 * n_q
    dchg_list: tuple = ()
    if d_chg:
        dchg_list = tuple(tuple(base + j * n_d + k for j in range(5))
                          for k in range(n_d))
        base += 5 * n_d
    qchg_list: tuple = ()
    if q_chg:
        qchg_list = tuple(tuple(base + j * n_q + k for j in range(9))
                          for k in range(n_q))
        base += 9 * n_q
    row_invdt = -1
    if d_chg or q_chg:
        row_invdt = base
        base += 1
    c_state = tuple((k, int(c[k, 0]), int(c[k, 1]), off_gc + k)
                    for k in range(n_c))
    l_state = tuple((k, int(l_arr[k, 0]), int(l_arr[k, 1]), off_gl + k)
                    for k in range(n_l))
    a_entries = tuple(sorted((ij, tuple(terms)) for ij, terms in a_t.items()))
    return (base, a_entries, tuple(b_src), c_state, l_state, s_list, d_list,
            m_list, q_list, dchg_list, qchg_list, row_invdt)


@dataclass(frozen=True)
class TranPattern:
    """A transient pattern as int32 tables on one device.

    ``ent``/``terms``/``zeros`` place A's entries at ``i * width + j``
    (``mc_ac_fused.pack_entries``): in the [A | I] planes of K8 (width 2n)
    for a linear deck, in the (n, n) state-independent part of K9 (width
    n) for a nonlinear one. ``bsrc`` (n_b, 3) = [row, source column,
    sign]; ``cst``/``lst`` (n_c|n_l, 3) = [i1, i2, value row] of the C
    and L companions; ``b_rows`` the bitmask of RHS rows that any term
    reaches (K8's matvec skips the others). K9's device tables, rows as
    ``build_tran_pattern``'s lists: ``slist`` (n_s, 8), ``dlist`` (n_d,
    4), ``mlist``/``qlist`` (n_m|n_q, 6) without the polarity, which is
    in the float32 ``pol`` (n_m + n_q), ``dchg`` (n_d, 5) and ``qchg``
    (n_q, 9) when the deck stores junction charge (else empty), and
    ``row_invdt``."""

    n: int
    n_rows: int
    ent: torch.Tensor
    terms: torch.Tensor
    zeros: torch.Tensor
    bsrc: torch.Tensor
    cst: torch.Tensor
    lst: torch.Tensor
    b_rows: int
    slist: torch.Tensor
    dlist: torch.Tensor
    mlist: torch.Tensor
    qlist: torch.Tensor
    pol: torch.Tensor
    dchg: torch.Tensor
    qchg: torch.Tensor
    row_invdt: int

    @property
    def nonlinear(self) -> bool:
        """A deck with switches, diodes, MOSFETs or BJTs: K9's route."""
        return any(t.shape[0] for t in (self.slist, self.dlist, self.mlist,
                                        self.qlist))

    def tables(self) -> tuple[torch.Tensor, ...]:
        return (self.ent, self.terms, self.zeros, self.bsrc, self.cst,
                self.lst, self.slist, self.dlist, self.mlist, self.qlist,
                self.dchg, self.qchg)


def pack_tran_pattern(pattern: tuple, n: int,
                      device: torch.device | str) -> TranPattern:
    (n_rows, a_entries, b_src, c_state, l_state, s_list, d_list, m_list,
     q_list, dchg_list, qchg_list, row_invdt) = pattern
    nonlinear = bool(s_list or d_list or m_list or q_list)
    ent, terms, zeros = pack_entries((a_entries,), n,
                                     n if nonlinear else 2 * n, device)
    rows = {i for i, _c, _s in b_src}
    for _k, i1, i2, _row in c_state + l_state:
        rows.update(i for i in (i1, i2) if i < n)
    pols = [m[6] for m in m_list] + [q[6] for q in q_list]
    return TranPattern(
        n=n, n_rows=int(n_rows), ent=ent, terms=terms, zeros=zeros,
        bsrc=int32_table([(i, col, int(s)) for i, col, s in b_src], 3,
                         device),
        cst=int32_table([(i1, i2, row) for _k, i1, i2, row in c_state], 3,
                        device),
        lst=int32_table([(i1, i2, row) for _k, i1, i2, row in l_state], 3,
                        device),
        b_rows=sum(1 << i for i in rows),
        slist=int32_table(list(s_list), 8, device),
        dlist=int32_table(list(d_list), 4, device),
        mlist=int32_table([m[:6] for m in m_list], 6, device),
        qlist=int32_table([q[:6] for q in q_list], 6, device),
        pol=torch.as_tensor(np.asarray(pols, np.float32).reshape(-1),
                            device=device),
        dchg=int32_table(list(dchg_list), 5, device),
        qchg=int32_table(list(qchg_list), 9, device),
        row_invdt=int(row_invdt))


def _entries(pattern: TranPattern, values: torch.Tensor,
             width: int) -> torch.Tensor:
    """The (n * width, B) planes the pattern's A entries fill: each entry
    the sum of its terms in table order, every other position 0."""
    B, dtype = values.shape[1], values.dtype
    row = pattern.terms[:, 1].long()
    kind = pattern.terms[:, 0][:, None]
    sign = pattern.terms[:, 2].to(dtype)[:, None]
    v = values[row]                                         # (n_terms, B)
    tv = torch.where(kind == KINDS["inv"], sign / v, sign * v)
    tv = torch.where(kind == KINDS["one"], sign.expand_as(tv), tv)
    planes = torch.zeros((pattern.n * width, B), dtype=dtype,
                         device=values.device)
    for pos, t0, t1 in pattern.ent.cpu().tolist():
        acc = tv[t0]
        for t in range(t0 + 1, t1):
            acc = acc + tv[t]
        planes[pos] = acc
    return planes


def mc_tran_fused_plain(vs_grid: torch.Tensor, values: torch.Tensor,
                        pattern: TranPattern, node_idx: int,
                        eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8. vs_grid (S+1, nSrc), values (n_rows, B) ->
    (v_node (B, S+1), valid (B,)), in the dtype of ``values``."""
    n, B = pattern.n, values.shape[1]
    dtype, dev = values.dtype, values.device
    # 1. A from the tables, then factor once
    A = _entries(pattern, values, 2 * n).reshape(n, 2 * n, B)[:, :n]
    A = A.permute(2, 0, 1)
    Ainv, valid = gj_inverse(A, eps=eps)
    # 3. the time loop
    bsrc = pattern.bsrc.cpu().tolist()
    cst = pattern.cst.cpu().tolist()
    lst = pattern.lst.cpu().tolist()
    cols = [j for j in range(n) if (pattern.b_rows >> j) & 1]
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    vp = [zero] * len(cst)
    ip = [zero] * len(lst)
    out = torch.empty((vs_grid.shape[0], B), dtype=dtype, device=dev)
    vs = vs_grid.to(dtype)
    for s in range(vs.shape[0]):
        rhs = [zero] * n
        for i, col, sgn in bsrc:
            rhs[i] = rhs[i] + vs[s, col] * sgn
        for k, (i1, i2, r) in enumerate(cst):
            t = values[r] * vp[k]
            if i1 < n:
                rhs[i1] = rhs[i1] + t
            if i2 < n:
                rhs[i2] = rhs[i2] - t
        for k, (i1, i2, _r) in enumerate(lst):
            if i1 < n:
                rhs[i1] = rhs[i1] - ip[k]
            if i2 < n:
                rhs[i2] = rhs[i2] + ip[k]
        x = torch.zeros((B, n), dtype=dtype, device=dev)
        for j in cols:
            x = x + Ainv[:, :, j] * rhs[j][:, None]
        out[s] = x[:, node_idx]

        def xv(i: int) -> torch.Tensor:
            return x[:, i] if i < n else zero

        vp = [xv(i1) - xv(i2) for i1, i2, _r in cst]
        ip = [ip[k] + values[r] * (xv(i1) - xv(i2))
              for k, (i1, i2, r) in enumerate(lst)]
    return out.T, valid


def nr_constants(vd_scale: float) -> dict[str, float]:
    """K9's float32 constants, rounded as the TPU kernel rounds them: the
    diode clamp window [-1.0, 0.8] x vd_scale, the BJT thermal voltage
    VT_300K x vd_scale and its clamp window (from the float32 ratio
    vt / VT_300K), and the converged-mode tolerance, 16 float32 ulps
    (pallas_mc_tran.py:411-412, 460-464: the JAX package floors its
    ``nr_tol`` there, and its default of 1e-9 never exceeds the floor)."""
    f32 = np.float32
    vt_q = f32(VT_300K * vd_scale)
    tscale = vt_q / f32(VT_300K)
    return {"vd_lo": float(f32(DIODE_VD_MIN * vd_scale)),
            "vd_hi": float(f32(DIODE_VD_MAX * vd_scale)),
            "vt_q": float(vt_q),
            "q_lo": float(f32(DIODE_VD_MIN) * tscale),
            "q_hi": float(f32(DIODE_VD_MAX) * tscale),
            "tol": float(16 * np.finfo(np.float32).eps)}


def mc_tran_fused_nr_plain(vs_grid: torch.Tensor, values: torch.Tensor,
                           pattern: TranPattern, node_idx: int,
                           eps: float = EPS, vd_scale: float = 1.0,
                           nr: str = "spicey", max_nr: int = 20,
                           return_passes: bool = False
                           ) -> tuple[torch.Tensor, ...]:
    """Plain version of K9. vs_grid (S+1, nSrc), values (n_rows, B) ->
    (v_node (B, S+1), valid (B,)), in the dtype of ``values``; with
    ``return_passes`` also each lane's count of Newton passes (int64
    (B,)), the work K9's bound counts.

    Vectorised over the variants with a per-lane done mask: a lane that
    is done keeps its solution, switch states and validity, which is the
    per-thread loop of the kernel breaking when its lane is done. Every
    value is formed in the kernel's order: the RHS rows sum sources, C,
    then L terms; each pass stamps switches, diodes (+ charge), MOSFETs,
    BJTs (+ charge) onto the state-independent part, entry by entry."""
    n, B = pattern.n, values.shape[1]
    dtype, dev = values.dtype, values.device
    k = nr_constants(vd_scale)
    vd_lo, vd_hi, vt_q = k["vd_lo"], k["vd_hi"], k["vt_q"]
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    lin_planes = _entries(pattern, values, n)
    lin = {(i, j): lin_planes[i * n + j] for i in range(n) for j in range(n)}
    bsrc = pattern.bsrc.cpu().tolist()
    cst = pattern.cst.cpu().tolist()
    lst = pattern.lst.cpu().tolist()
    slist = pattern.slist.cpu().tolist()
    dlist = pattern.dlist.cpu().tolist()
    mlist = pattern.mlist.cpu().tolist()
    qlist = pattern.qlist.cpu().tolist()
    pols = pattern.pol.cpu().tolist()
    m_pol, q_pol = pols[:len(mlist)], pols[len(mlist):]
    dchg = pattern.dchg.cpu().tolist()
    qchg = pattern.qchg.cpu().tolist()
    inv_dt = values[pattern.row_invdt] if pattern.row_invdt >= 0 else None
    val = values.__getitem__
    # the state of one pass, rebound per step and pass: x (B, n), the
    # [A | b] entries ab {(i, j): (B,)} and the device terms of the RHS
    x = ab = dterm = None

    def xv(i: int) -> torch.Tensor:
        return x[:, i] if i < n else zero

    def adm4(i1: int, i2: int, g: torch.Tensor) -> None:
        for a, b2, sgn in ((i1, i1, 1.0), (i2, i2, 1.0), (i1, i2, -1.0),
                           (i2, i1, -1.0)):
            if a < n and b2 < n:
                ab[a, b2] = ab[a, b2] + sgn * g

    def vccs4(i1: int, i2: int, icp: int, icn: int, g: torch.Tensor) -> None:
        for a, b2, sgn in ((i1, icp, 1.0), (i1, icn, -1.0), (i2, icp, -1.0),
                           (i2, icn, 1.0)):
            if a < n and b2 < n:
                ab[a, b2] = ab[a, b2] + sgn * g

    def dadd(i: int, t: torch.Tensor) -> None:
        if i < n:
            dterm[i] = dterm[i] + t

    def bjt_chg(v: torch.Tensor, i_s: torch.Tensor, rows: list,
                junction: int, pol: float) -> tuple:
        """One BJT junction's (q, C, cv) in the stamped frame
        (pallas_mc_tran.py:466-485)."""
        u = pol * v
        u_lim = torch.clamp(u, vd_lo, vd_hi)
        ev = torch.exp(u_lim / vt_q)
        g_diff = (i_s / vt_q * ev).clamp_min(GMIN)
        off = 0 if junction == 0 else 4
        tt = val(rows[off])
        q_r, c = diode_charge_cap(u, i_s * (ev - 1.0), g_diff, tt,
                                  val(rows[off + 1]), val(rows[off + 2]),
                                  val(rows[off + 3]), val(rows[8]))
        cv = tt * g_diff * (pol * u_lim) + (c - tt * g_diff) * (pol * u)
        return pol * q_r, c, cv

    v_prev = [zero] * len(cst)
    i_prev = [zero] * len(lst)
    vd_prev = [zero] * len(dlist)
    vm_gs = [zero] * len(mlist)
    vm_ds = [zero] * len(mlist)
    vq_be = [zero] * len(qlist)
    vq_bc = [zero] * len(qlist)
    qd_prev = [zero] * len(dchg)
    qq_be = [zero] * len(qchg)
    qq_bc = [zero] * len(qchg)
    sw = [torch.zeros((B,), dtype=torch.bool, device=dev)] * len(slist)
    valid = torch.ones((B,), dtype=torch.bool, device=dev)
    passes = torch.zeros((B,), dtype=torch.int64, device=dev)
    vs = vs_grid.to(dtype)
    out = torch.empty((vs.shape[0], B), dtype=dtype, device=dev)
    for s in range(vs.shape[0]):
        b_lin = [zero] * n
        for i, col, sgn in bsrc:
            b_lin[i] = b_lin[i] + vs[s, col] * sgn
        for kk, (i1, i2, r) in enumerate(cst):
            t = val(r) * v_prev[kk]
            if i1 < n:
                b_lin[i1] = b_lin[i1] + t
            if i2 < n:
                b_lin[i2] = b_lin[i2] - t
        for kk, (i1, i2, _r) in enumerate(lst):
            if i1 < n:
                b_lin[i1] = b_lin[i1] - i_prev[kk]
            if i2 < n:
                b_lin[i2] = b_lin[i2] + i_prev[kk]
        x = torch.zeros((B, n), dtype=dtype, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        vnr = torch.ones((B,), dtype=torch.bool, device=dev)
        for it in range(max_nr):
            passes += (~done).long()
            ab = dict(lin)
            dterm = [zero] * n
            for kk, (i1, i2, _p, _m, rg1, rg0, _von, _voff) in \
                    enumerate(slist):
                g0 = val(rg0)
                adm4(i1, i2, g0 + sw[kk].to(dtype) * (val(rg1) - g0))
            for kk, (ip, im, r_is, r_vth) in enumerate(dlist):
                vd = vd_prev[kk] if it == 0 else xv(ip) - xv(im)
                vd_l = torch.clamp(vd, vd_lo, vd_hi)
                i_s, vth = val(r_is), val(r_vth)
                ev = torch.exp(vd_l / vth)
                idd = i_s * (ev - 1.0)
                gd = (i_s / vth * ev).clamp_min(GMIN)
                adm4(ip, im, gd)
                cur = idd - gd * vd_l
                dadd(ip, -cur)
                dadd(im, cur)
                if dchg:
                    rtt, rcjo, rvj, rm, rfc = dchg[kk]
                    q_d, c_d = diode_charge_cap(vd, idd, gd, val(rtt),
                                                val(rcjo), val(rvj), val(rm),
                                                val(rfc))
                    adm4(ip, im, c_d * inv_dt)
                    tt_gd = val(rtt) * gd
                    cur_q = (q_d - qd_prev[kk] - tt_gd * vd_l
                             - (c_d - tt_gd) * vd) * inv_dt
                    dadd(ip, -cur_q)
                    dadd(im, cur_q)
            for kk, (dd, gg, ss, rb, rv, rl) in enumerate(mlist):
                vgs = vm_gs[kk] if it == 0 else xv(gg) - xv(ss)
                vds = vm_ds[kk] if it == 0 else xv(dd) - xv(ss)
                gm, gds, i_eq, _ = mos_level1(vgs, vds, val(rb), val(rv),
                                              val(rl), m_pol[kk])
                adm4(dd, ss, gds)
                vccs4(dd, ss, gg, ss, gm)
                dadd(dd, -i_eq)
                dadd(ss, i_eq)
            for kk, (cc, bb, ee, ris, rbf, rbr) in enumerate(qlist):
                pol = q_pol[kk]
                vbe_it = xv(bb) - xv(ee)
                vbc_it = xv(bb) - xv(cc)
                vbe = vq_be[kk] if it == 0 else vbe_it
                vbc = vq_bc[kk] if it == 0 else vbc_it
                gbe, gbc, gmf, gmr, ibe_eq, ibc_eq, ict_eq, _, _ = \
                    bjt_ebers_moll(vbe, vbc, val(ris), val(rbf), val(rbr),
                                   pol, vt=vt_q,
                                   vbe_lim=torch.clamp(pol * vbe, k["q_lo"],
                                                       k["q_hi"]),
                                   vbc_lim=torch.clamp(pol * vbc, k["q_lo"],
                                                       k["q_hi"]))
                adm4(bb, ee, gbe)
                adm4(bb, cc, gbc)
                vccs4(cc, ee, bb, ee, gmf)
                vccs4(cc, ee, bb, cc, -gmr)
                dadd(bb, -ibe_eq)
                dadd(ee, ibe_eq)
                dadd(bb, -ibc_eq)
                dadd(cc, ibc_eq)
                dadd(cc, -ict_eq)
                dadd(ee, ict_eq)
                if qchg:
                    # at the current iterate, never the pass-0 seed
                    q_be, c_be, cv_be = bjt_chg(vbe_it, val(ris), qchg[kk],
                                                0, pol)
                    q_bc, c_bc, cv_bc = bjt_chg(vbc_it, val(ris), qchg[kk],
                                                1, pol)
                    adm4(bb, ee, c_be * inv_dt)
                    cur_be = (q_be - qq_be[kk] - cv_be) * inv_dt
                    dadd(bb, -cur_be)
                    dadd(ee, cur_be)
                    adm4(bb, cc, c_bc * inv_dt)
                    cur_bc = (q_bc - qq_bc[kk] - cv_bc) * inv_dt
                    dadd(bb, -cur_bc)
                    dadd(cc, cur_bc)
            A = torch.stack([ab[i, j] for i in range(n) for j in range(n)],
                            dim=1).reshape(B, n, n)
            rhs = torch.stack([b_lin[i] + dterm[i] for i in range(n)], dim=1)
            x_new, ok = gj_solve(A, rhs, eps=eps)
            # a live lane commits as the TPU kernel blends: x0 + (x_new - x0)
            x0 = x
            x = torch.where(done[:, None], x0, x0 + (x_new - x0))
            vnr = vnr & (ok | done)
            toggled = torch.zeros((B,), dtype=torch.bool, device=dev)
            for kk, (_i1, _i2, icp, icn, _g1, _g0, rvon, rvoff) in \
                    enumerate(slist):
                vctrl = xv(icp) - xv(icn)
                on = sw[kk]
                nxt = torch.where(on, ~(vctrl < val(rvoff)), vctrl > val(rvon))
                nxt = torch.where(done, on, nxt)
                toggled = toggled | (nxt != on)
                sw[kk] = nxt
            settled = ~toggled
            if nr == "converged":
                delta = (x_new - x0).abs().amax(dim=1)
                scale = 1.0 + x_new.abs().amax(dim=1)
                settled = settled & (delta <= k["tol"] * scale)
            done = done | settled
            if bool(done.all()):
                break
        out[s] = x[:, node_idx]
        v_prev = [xv(i1) - xv(i2) for i1, i2, _r in cst]
        i_prev = [i_prev[kk] + val(r) * (xv(i1) - xv(i2))
                  for kk, (i1, i2, r) in enumerate(lst)]
        vd_prev = [xv(ip) - xv(im) for ip, im, _ri, _rv in dlist]
        vm_gs = [xv(gg) - xv(ss) for _d, gg, ss, _b, _v, _l in mlist]
        vm_ds = [xv(dd) - xv(ss) for dd, _g, ss, _b, _v, _l in mlist]
        vq_be = [xv(bb) - xv(ee) for _c, bb, ee, _i, _f, _r in qlist]
        vq_bc = [xv(bb) - xv(cc) for cc, bb, _e, _i, _f, _r in qlist]
        if dchg:
            # diffusion at the clamped voltage, depletion at the true one
            qd_prev = []
            for kk, (_ip, _im, r_is, r_vth) in enumerate(dlist):
                rtt, rcjo, rvj, rm, rfc = dchg[kk]
                i_s, vth = val(r_is), val(r_vth)
                ev_c = torch.exp(torch.clamp(vd_prev[kk], vd_lo, vd_hi) / vth)
                qd_prev.append(diode_charge_cap(
                    vd_prev[kk], i_s * (ev_c - 1.0),
                    (i_s / vth * ev_c).clamp_min(GMIN), val(rtt), val(rcjo),
                    val(rvj), val(rm), val(rfc))[0])
        if qchg:
            qq_be = [bjt_chg(vq_be[kk], val(q[3]), qchg[kk], 0, q_pol[kk])[0]
                     for kk, q in enumerate(qlist)]
            qq_bc = [bjt_chg(vq_bc[kk], val(q[3]), qchg[kk], 1, q_pol[kk])[0]
                     for kk, q in enumerate(qlist)]
        valid = valid & vnr
    if return_passes:
        return out.T, valid, passes
    return out.T, valid


_LAUNCH_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                 ctypes.c_double, ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 3)
_RESIDENT_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_size_t], ctypes.c_int)
_SIGNATURES = {
    "mc_tran_fused_bytes_per_variant": ([ctypes.c_int] * 4,
                                        ctypes.c_size_t),
    "mc_tran_fused_resident": _RESIDENT_ARGS,
    "mc_tran_fused_f32": (_LAUNCH_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("mc_tran_fused", _SIGNATURES)


def _check_form(form: str | None, n: int, chosen: str, what: str) -> str:
    form = chosen if form is None else form
    if form not in FORMS or (form == "register" and n > REG_MAX_N):
        raise ValueError(f"{what} has no form {form!r} at N={n}")
    return form


def k8_launch_plan(values: torch.Tensor, pattern: TranPattern,
                   form: str | None = None) -> LaunchPlan:
    """The launch plan of K8 on (n_rows, B) CUDA ``values`` in ``form``
    (None: ``k8_form_for``'s)."""
    n = pattern.n
    form = _check_form(form, n, k8_form_for(n), "K8")
    per = k8_bytes_per_variant(form, n, pattern.cst.shape[0],
                               pattern.lst.shape[0])
    return _plan(load_library().mc_tran_fused_resident, ("K8",), form, n,
                 per, values.shape[1], values.device)


def mc_tran_fused_cuda(vs_grid: torch.Tensor, values: torch.Tensor,
                       pattern: TranPattern, node_idx: int,
                       eps: float = EPS, form: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8. vs_grid (S+1, nSrc) and values (n_rows, B), both CUDA,
    contiguous float32; the pattern's tables on the same device. Returns
    (v_node, valid) as a (B, S+1) view of the (S+1, B) trajectory and
    (B,). ``form`` forces one of ``FORMS`` (for the comparisons and the
    profiles); None takes ``k8_form_for``'s."""
    n = pattern.n
    if not 1 <= n <= FUSED_MAX_N:
        raise ValueError(f"K8 takes 1 <= N <= {FUSED_MAX_N}, got N={n}")
    if values.ndim != 2 or values.shape[0] != pattern.n_rows \
            or vs_grid.ndim != 2:
        raise ValueError("values must be (n_rows, B) and vs_grid (S+1, nSrc)")
    if values.dtype != torch.float32 or vs_grid.dtype != torch.float32:
        raise TypeError("K8 takes float32 values and source grid")
    tables = (pattern.ent, pattern.terms, pattern.zeros, pattern.bsrc,
              pattern.cst, pattern.lst)
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("K8 takes int32 pattern tables")
    ts = (vs_grid, values) + tables
    if any(not t.is_cuda or t.device != values.device for t in ts):
        raise ValueError("K8 takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("K8 takes contiguous tensors")
    if not 0 <= node_idx < n:
        raise ValueError(f"node index {node_idx} outside the system")
    n_steps, B = vs_grid.shape[0], values.shape[1]
    if B >= 2**31:
        raise ValueError("K8 takes fewer than 2^31 variants")
    form = _check_form(form, n, k8_form_for(n), "K8")
    n_c, n_l = pattern.cst.shape[0], pattern.lst.shape[0]
    if not fits_32_variants(k8_bytes_per_variant(form, n, n_c, n_l)):
        raise ValueError("K8: the deck's per-variant state does not fit "
                         "32 variants in one block's shared memory")
    lib = load_library()
    out = torch.empty((n_steps, B), dtype=torch.float32, device=values.device)
    valid = torch.empty((B,), dtype=torch.bool, device=values.device)
    with torch.cuda.device(values.device):
        plan = k8_launch_plan(values, pattern, form)
        code = lib.mc_tran_fused_f32(
            ptr(vs_grid), vs_grid.shape[1], n_steps, ptr(values), B,
            ptr(pattern.ent), pattern.ent.shape[0], ptr(pattern.terms),
            ptr(pattern.zeros), pattern.zeros.shape[0], ptr(pattern.bsrc),
            pattern.bsrc.shape[0], ptr(pattern.cst), n_c, ptr(pattern.lst),
            n_l, pattern.b_rows, n, node_idx, float(eps), FORMS.index(form),
            plan.tpb, ptr(out), ptr(valid), stream_ptr(values.device))
        check(code, f"mc_tran_fused {form} launch")
    K8[torch.float32].launches += 1
    K8_FORMS[form] += 1
    return out.T, valid


_NR_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int]
            + [ctypes.c_double] * 7
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 3)
_NR_SIGNATURES = {
    "mc_tran_nr_bytes_per_variant": ([ctypes.c_int] * 10, ctypes.c_size_t),
    "mc_tran_nr_resident": _RESIDENT_ARGS,
    "mc_tran_nr_f32": (_NR_ARGS, ctypes.c_int),
}


def load_nr_library() -> ctypes.CDLL:
    """Build (at first use) and load K9's library."""
    return load("mc_tran_nr", _NR_SIGNATURES)


def k9_counts(pattern: TranPattern) -> tuple[int, ...]:
    """(n_c, n_l, n_s, n_d, n_m, n_q, has_dchg, has_qchg) of a pattern,
    the per-variant state K9 carries."""
    return (pattern.cst.shape[0], pattern.lst.shape[0],
            pattern.slist.shape[0], pattern.dlist.shape[0],
            pattern.mlist.shape[0], pattern.qlist.shape[0],
            int(pattern.dchg.shape[0] > 0), int(pattern.qchg.shape[0] > 0))


def k9_launch_plan(values: torch.Tensor, pattern: TranPattern,
                   form: str | None = None) -> LaunchPlan:
    """The launch plan of K9 on (n_rows, B) CUDA ``values`` in ``form``
    (None: ``k9_form_for``'s)."""
    n = pattern.n
    form = _check_form(form, n, k9_form_for(n), "K9")
    per = k9_bytes_per_variant(form, n, *k9_counts(pattern))
    return _plan(load_nr_library().mc_tran_nr_resident, ("K9",), form, n,
                 per, values.shape[1], values.device)


def mc_tran_fused_nr_cuda(vs_grid: torch.Tensor, values: torch.Tensor,
                          pattern: TranPattern, node_idx: int,
                          eps: float = EPS, vd_scale: float = 1.0,
                          nr: str = "spicey", max_nr: int = 20,
                          form: str | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K9. vs_grid (S+1, nSrc) and values (n_rows, B), both CUDA,
    contiguous float32; the pattern's tables on the same device. Returns
    (v_node, valid) as a (B, S+1) view of the (S+1, B) trajectory and
    (B,). ``form`` forces one of ``FORMS`` (for the comparisons and the
    profiles); None takes ``k9_form_for``'s."""
    n = pattern.n
    if not 1 <= n <= FUSED_MAX_N:
        raise ValueError(f"K9 takes 1 <= N <= {FUSED_MAX_N}, got N={n}")
    if not pattern.nonlinear:
        raise ValueError("K9 takes a nonlinear pattern (S/W/D/M/Q); a "
                         "linear deck is K8's")
    if nr not in ("spicey", "converged"):
        raise ValueError("nr must be 'spicey' or 'converged'")
    if values.ndim != 2 or values.shape[0] != pattern.n_rows \
            or vs_grid.ndim != 2:
        raise ValueError("values must be (n_rows, B) and vs_grid (S+1, nSrc)")
    if values.dtype != torch.float32 or vs_grid.dtype != torch.float32:
        raise TypeError("K9 takes float32 values and source grid")
    tables = pattern.tables()
    if any(t.dtype != torch.int32 for t in tables) \
            or pattern.pol.dtype != torch.float32:
        raise TypeError("K9 takes int32 pattern tables and float32 "
                        "polarities")
    ts = (vs_grid, values, pattern.pol) + tables
    if any(not t.is_cuda or t.device != values.device for t in ts):
        raise ValueError("K9 takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("K9 takes contiguous tensors")
    if not 0 <= node_idx < n:
        raise ValueError(f"node index {node_idx} outside the system")
    n_steps, B = vs_grid.shape[0], values.shape[1]
    if B >= 2**31:
        raise ValueError("K9 takes fewer than 2^31 variants")
    form = _check_form(form, n, k9_form_for(n), "K9")
    counts = k9_counts(pattern)
    if not fits_32_variants(k9_bytes_per_variant(form, n, *counts)):
        raise ValueError("K9: the deck's per-variant state does not fit "
                         "32 variants in one block's shared memory")
    lib = load_nr_library()
    k = nr_constants(vd_scale)
    out = torch.empty((n_steps, B), dtype=torch.float32, device=values.device)
    valid = torch.empty((B,), dtype=torch.bool, device=values.device)
    n_c, n_l, n_s, n_d, n_m, n_q, has_d, has_q = counts
    with torch.cuda.device(values.device):
        plan = k9_launch_plan(values, pattern, form)
        code = lib.mc_tran_nr_f32(
            ptr(vs_grid), vs_grid.shape[1], n_steps, ptr(values),
            pattern.n_rows, B, ptr(pattern.ent), pattern.ent.shape[0],
            ptr(pattern.terms), ptr(pattern.zeros), pattern.zeros.shape[0],
            ptr(pattern.bsrc), pattern.bsrc.shape[0], ptr(pattern.cst), n_c,
            ptr(pattern.lst), n_l, ptr(pattern.slist), n_s,
            ptr(pattern.dlist), n_d, ptr(pattern.mlist), n_m,
            ptr(pattern.qlist), n_q, ptr(pattern.pol), ptr(pattern.dchg),
            has_d, ptr(pattern.qchg), has_q, pattern.row_invdt, n, node_idx,
            float(eps), k["vd_lo"], k["vd_hi"], k["vt_q"], k["q_lo"],
            k["q_hi"], k["tol"], int(nr == "converged"), int(max_nr),
            FORMS.index(form), plan.tpb, ptr(out), ptr(valid),
            stream_ptr(values.device))
        check(code, f"mc_tran_nr {form} launch")
    K9[torch.float32].launches += 1
    K9_FORMS[form] += 1
    return out.T, valid


def mc_tran_fused(vs_grid: torch.Tensor, values: torch.Tensor,
                  pattern: TranPattern, node_idx: int, eps: float = EPS,
                  vd_scale: float = 1.0, nr: str = "spicey",
                  max_nr: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused whole transient, as the JAX package's
    ``mc_tran_fused_f32`` routes it: a linear pattern takes K8, a
    nonlinear one K9 (``vd_scale``, ``nr`` and ``max_nr`` are K9's);
    CUDA tensors launch the kernel, CPU tensors run its plain version.
    -> (v_node (B, S+1), valid (B,))."""
    if pattern.nonlinear:
        nl_kw = dict(vd_scale=vd_scale, nr=nr, max_nr=max_nr)
        if values.is_cuda:
            return mc_tran_fused_nr_cuda(vs_grid, values, pattern, node_idx,
                                         eps, **nl_kw)
        return mc_tran_fused_nr_plain(vs_grid, values, pattern, node_idx,
                                      eps, **nl_kw)
    if values.is_cuda:
        return mc_tran_fused_cuda(vs_grid, values, pattern, node_idx, eps)
    return mc_tran_fused_plain(vs_grid, values, pattern, node_idx, eps)
