"""Fused AC assemble-and-solve: kernels K5 and K7 (csrc/mc_ac_fused.cu).

K5 replaces ``spicey_tpu/ops/pallas_mc_ac.py:_fused_kernel`` (and, by
role, its f64-fidelity twin ``_fused_dd_kernel``: Hopper has native f64,
so the f64 instance of this kernel is the fidelity tier and needs no df32
refinement loop). Per (variant, frequency) system it builds the augmented
(N, N+1) complex planes on chip from the static stamp pattern and the
(n_rows, B) element values, runs the complex one-hot-pivot Gauss-Jordan,
and writes only |V(node)| and ``valid``: the planes never exist in device
memory. K7 replaces ``_fused_x_kernel``: the same systems and pivots,
writing the whole solution (F, N, B) and ``valid`` (F, B); with an
external RHS (rr, ri) (F, N, B) the pattern's RHS column is replaced,
from tables packed without it (``pack_pattern(ext_rhs=True)``).
``simulate_ac_batch(method="pallas")`` runs it in f64. K7 is a group of
``fused_group_for(n)`` lanes per system, one row per lane in registers,
assembled from the pattern's row-ordered table
(``PackedPattern.row_ent``/``row_ptr``), the pivot row shared through
shared memory. K5 runs in one of two forms, chosen by ``k5_form_for``
from N and the dtype: "register" (one thread per system, its system in
registers with N a template constant, up to ``K5_REG_MAX_N``) and
"group" (K7's body, writing |x[node]| and ``valid`` only); ``K5_FORMS``
counts each form's launches. ``csrc/mc_ac_fused.cu`` says what bounds
each.

The stamp pattern is the same static-index information the scatter
assembly uses, precomputed on the host as per-entry term lists; each term
is (kind, value_row, sign) with kind encoding the frequency dependence:

  one   +-1 constants (V/E/H branch couplings)        -> real plane
  inv   1/v (resistors)                               -> real plane
  lin   v (VCCS gm, CCCS/VCVS/CCVS gains, phasor b)   -> real plane / b
  w     2*pi*f * v (capacitors)                       -> imag plane
  winv  -1/(2*pi*f * v), open when |2*pi*f*v| < EPS
        (inductors, simulateAC.ts:47-52)              -> imag plane

The TPU kernel unrolls the pattern at trace time; here ``pack_pattern``
flattens it into int32 tables that the kernel reads at run time, so one
nvcc build serves every deck. ``mc_ac_fused_plain`` and
``mc_ac_fused_x_plain`` are the plain PyTorch versions: dense assembly
from the same tables, then the plain ``gj_solve_planes`` (then |x[node]|
for K5).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS
from ._build import Kernel, check, load, ptr, stream_ptr
from .linsolve import gj_solve_planes

# the fused tier's eligibility bound, as in the JAX package: beyond it the
# per-system planes outgrow a thread's share of shared memory and the K1
# route is the right shape
FUSED_MAX_N = 16

KINDS = {"one": 0, "inv": 1, "lin": 2, "w": 3, "winv": 4}

# K7's group widths: lanes per system, each a power of two that divides a
# warp; N must not exceed the group's
K7_GROUPS = (4, 8, 16)
# K5's forms (the C side's form codes, in order): one thread per system
# with its system in registers, for N <= K5_REG_MAX_N; K7's group of lanes
# per system beyond
FORMS = ("register", "group")
# the largest N of a register instance (mc_ac_fused.cu:REG_MAX_N)
REG_MAX_N = 6
# K5's crossover: the register form up to this N, the group form above.
# Measured by tools/profile_torch_k5.py (every form at N = 1-8 on dense
# random systems, 2^20 variants x 3 frequencies) on an NVIDIA H100 80GB
# HBM3 at 700.00 W: the register form won at every N it has an instance
# for, in both dtypes (N = 6: 4.89 against 5.32 ms in f64, 2.32 against
# 3.21 in f32), its time doubling from N = 5 to 6 where the group form's
# grows by a seventh per N, so the group form takes N = 7 on.
K5_REG_MAX_N = {torch.float32: 6, torch.float64: 6}
# one launch counter per instantiation
K5 = {dt: Kernel(name=f"mc_ac_fused_{tag}",
                 source="spicey_tpu_torch/csrc/mc_ac_fused.cu",
                 replaces="spicey_tpu/ops/pallas_mc_ac.py:982")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}
# launches of each form, per instantiation (K5 counts their sum)
K5_FORMS = {dt: dict.fromkeys(FORMS, 0)
            for dt in (torch.float32, torch.float64)}
K7 = {dt: Kernel(name=f"mc_ac_fused_x_{tag}",
                 source="spicey_tpu_torch/csrc/mc_ac_fused.cu",
                 replaces="spicey_tpu/ops/pallas_mc_ac.py:384")
      for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}


def build_stamp_pattern(n: int, r_idx: object, c_idx: object,
                        l_idx: object, v_idx: object,
                        ext_idx: dict | None = None) -> tuple:
    """Host-side static stamp pattern for the fused kernel.

    Returns (n_rows, re_entries, im_entries) where each entries item is
    ((i, j), terms) with j == n meaning the RHS column and terms a tuple
    of (kind, value_row, sign). Value rows index the combined value
    matrix in the order [R | C | L | v_re | v_im | i_re | i_im | g | e |
    f | h] (see combine_values)."""
    re_t: dict = {}
    im_t: dict = {}

    def add(d: dict, i: int, j: int, term: tuple) -> None:
        if i >= n or j > n:
            return
        d.setdefault((int(i), int(j)), []).append(term)

    def adm(d: dict, idx: object, kind: str, base: int) -> None:
        for k, (i1, i2) in enumerate(np.asarray(idx).reshape(-1, 2)):
            row = base + k
            for (a, b, s) in ((i1, i1, 1.0), (i2, i2, 1.0),
                              (i1, i2, -1.0), (i2, i1, -1.0)):
                if a < n and b < n:
                    add(d, a, b, (kind, row, s))

    n_r = np.asarray(r_idx).reshape(-1, 2).shape[0]
    n_c = np.asarray(c_idx).reshape(-1, 2).shape[0]
    n_l = np.asarray(l_idx).reshape(-1, 2).shape[0]
    n_v = np.asarray(v_idx).reshape(-1, 3).shape[0]
    off_r, off_c, off_l = 0, n_r, n_r + n_c
    off_vre = n_r + n_c + n_l
    off_vim = off_vre + n_v
    adm(re_t, r_idx, "inv", off_r)
    adm(im_t, c_idx, "w", off_c)
    adm(im_t, l_idx, "winv", off_l)
    for k, (i1, i2, j) in enumerate(np.asarray(v_idx).reshape(-1, 3)):
        for (a, b, s) in ((i1, j, 1.0), (j, i1, 1.0),
                          (i2, j, -1.0), (j, i2, -1.0)):
            if a < n and b < n:
                add(re_t, a, b, ("one", 0, s))
        add(re_t, j, n, ("lin", off_vre + k, 1.0))
        add(im_t, j, n, ("lin", off_vim + k, 1.0))
    base = off_vim + n_v
    if ext_idx:
        ii = np.asarray(ext_idx["i_idx"]).reshape(-1, 2)
        n_i = ii.shape[0]
        off_ire, off_iim = base, base + n_i
        for k, (i1, i2) in enumerate(ii):
            # b[i1] -= I, b[i2] += I (stampCurrent*.ts)
            add(re_t, i1, n, ("lin", off_ire + k, -1.0))
            add(re_t, i2, n, ("lin", off_ire + k, 1.0))
            add(im_t, i1, n, ("lin", off_iim + k, -1.0))
            add(im_t, i2, n, ("lin", off_iim + k, 1.0))
        base = off_iim + n_i
        gi = np.asarray(ext_idx["g_idx"]).reshape(-1, 4)
        for k, (i1, i2, cp, cn) in enumerate(gi):
            row = base + k
            for (a, b, s) in ((i1, cp, 1.0), (i1, cn, -1.0),
                              (i2, cp, -1.0), (i2, cn, 1.0)):
                if a < n and b < n:
                    add(re_t, a, b, ("lin", row, s))
        base += gi.shape[0]
        ei = np.asarray(ext_idx["e_idx"]).reshape(-1, 5)
        for k, (i1, i2, j, cp, cn) in enumerate(ei):
            row = base + k
            for (a, b, s) in ((i1, j, 1.0), (i2, j, -1.0),
                              (j, i1, 1.0), (j, i2, -1.0)):
                if a < n and b < n:
                    add(re_t, a, b, ("one", 0, s))
            for (a, b, s) in ((j, cp, -1.0), (j, cn, 1.0)):
                if a < n and b < n:
                    add(re_t, a, b, ("lin", row, s))
        base += ei.shape[0]
        fi = np.asarray(ext_idx["f_idx"]).reshape(-1, 3)
        for k, (i1, i2, j) in enumerate(fi):
            row = base + k
            for (a, b, s) in ((i1, j, 1.0), (i2, j, -1.0)):
                if a < n and b < n:
                    add(re_t, a, b, ("lin", row, s))
        base += fi.shape[0]
        hi = np.asarray(ext_idx["h_idx"]).reshape(-1, 4)
        for k, (i1, i2, j, jc) in enumerate(hi):
            row = base + k
            for (a, b, s) in ((i1, j, 1.0), (i2, j, -1.0),
                              (j, i1, 1.0), (j, i2, -1.0)):
                if a < n and b < n:
                    add(re_t, a, b, ("one", 0, s))
            if j < n and jc < n:
                add(re_t, j, jc, ("lin", row, -1.0))
        base += hi.shape[0]

    def freeze(d: dict) -> tuple:
        return tuple(sorted(
            (ij, tuple(terms)) for ij, terms in d.items()
        ))

    return base, freeze(re_t), freeze(im_t)


@dataclass(frozen=True)
class PackedPattern:
    """A stamp pattern as flat int32 tables on one device.

    Positions are flat indices into the two planes of one augmented
    system: ``plane * n*(n+1) + i*(n+1) + j`` (plane 0 real, 1 imag).
    ``ent`` (n_ent, 3) = [position, first term, end term]; ``terms``
    (n_terms, 3) = [kind, value row, sign]; ``zeros`` (n_zero,) = the
    positions no entry writes, which K5 zeroes. ``row_ent`` (n_ent, 3) =
    [column, first term, end term], the same entries sorted by (plane, row,
    column), and ``row_ptr`` (2, n + 1): entries ``row_ptr[c, i]`` up to
    ``row_ptr[c, i + 1]`` are row i of plane c. K7 assembles each row from
    them, so each element is the same sum in the same order. ``flat``
    (n_terms, 4) = [position, kind | 8 (first term of its entry) | 16
    (last), value row, sign], every term in ``ent``'s order: K5's register
    form walks it once per system. ``ext_rhs``:
    the tables leave the RHS column out (no entries there, none of its
    positions zeroed), for K7 with external RHS planes."""

    n: int
    n_rows: int
    ent: torch.Tensor
    terms: torch.Tensor
    zeros: torch.Tensor
    row_ent: torch.Tensor
    row_ptr: torch.Tensor
    flat: torch.Tensor
    ext_rhs: bool = False

    def to(self, device: torch.device | str) -> "PackedPattern":
        """The same tables on ``device``."""
        return PackedPattern(
            n=self.n, n_rows=self.n_rows, ent=self.ent.to(device),
            terms=self.terms.to(device), zeros=self.zeros.to(device),
            row_ent=self.row_ent.to(device), row_ptr=self.row_ptr.to(device),
            flat=self.flat.to(device), ext_rhs=self.ext_rhs)


def pack_entries(planes: tuple, n: int, width: int,
                 device: torch.device | str) -> tuple:
    """Flatten per-plane entry lists ((i, j), ((kind, row, sign), ...))
    into int32 tables: ``ent`` [position, first term, end term] with
    position ``plane * n*width + i*width + j``, ``terms`` [kind, row,
    sign], and ``zeros``, every position of the planes no entry writes.
    Shared by K5's and K8's patterns (ops/mc_tran_fused.py)."""
    nw = n * width
    ent, terms, written = [], [], set()
    for plane, entries in enumerate(planes):
        for (i, j), ts in entries:
            pos = plane * nw + i * width + j
            ent.append((pos, len(terms), len(terms) + len(ts)))
            terms.extend((KINDS[kind], row, int(sign))
                         for kind, row, sign in ts)
            written.add(pos)
    zeros = [p for p in range(len(planes) * nw) if p not in written]
    return (int32_table(ent, 3, device), int32_table(terms, 3, device),
            int32_table(zeros, 1, device).reshape(-1))


def int32_table(rows: list, width: int,
                device: torch.device | str) -> torch.Tensor:
    a = np.asarray(rows, np.int32).reshape(-1, width)
    return torch.as_tensor(a, device=device)


def pack_pattern(pattern: tuple, n: int, device: torch.device | str,
                 ext_rhs: bool = False) -> PackedPattern:
    """Pack ``build_stamp_pattern``'s output. ``ext_rhs=True`` packs the
    tables of K7's external-RHS mode: the caller's planes fill column n,
    so the pattern's RHS entries are dropped and column n is left out of
    the zeroed positions, as ``_fused_x_kernel`` filters them
    (pallas_mc_ac.py:273-288)."""
    n_rows, re_entries, im_entries = pattern
    if ext_rhs:
        re_entries, im_entries = (tuple(e for e in entries if e[0][1] < n)
                                  for entries in (re_entries, im_entries))
    ent, terms, zeros = pack_entries((re_entries, im_entries), n, n + 1,
                                     device)
    if ext_rhs:
        zeros = zeros[zeros % (n + 1) != n].contiguous()
    row_ent, row_ptr = row_table(ent.cpu(), n)
    flat = flat_table(ent.cpu(), terms.cpu())
    return PackedPattern(n=n, n_rows=int(n_rows), ent=ent, terms=terms,
                         zeros=zeros, row_ent=row_ent.to(device),
                         row_ptr=row_ptr.to(device), flat=flat.to(device),
                         ext_rhs=ext_rhs)


def flat_table(ent: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """K5's flat copy of an entry table ``ent`` [position, first term, end
    term] and its ``terms`` [kind, value row, sign]: one row per term in
    table order, [position, kind | 8 (the entry's first term) | 16 (its
    last), value row, sign] (n_terms, 4) int32, so that a walk of it forms
    each entry as the same sum in the same order."""
    rows = []
    for pos, t0, t1 in ent.tolist():
        for q in range(t0, t1):
            kind, row, sign = terms[q].tolist()
            rows.append((pos, kind | (8 if q == t0 else 0)
                         | (16 if q == t1 - 1 else 0), row, sign))
    return torch.as_tensor(np.asarray(rows, np.int32).reshape(-1, 4))


def row_table(ent: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's row-ordered copy of an entry table ``ent`` [position, first
    term, end term] over (2, n, n + 1) planes: ``row_ent`` [column, first
    term, end term] sorted by position, i.e. by (plane, row, column), each
    entry keeping its terms; ``row_ptr`` (2, n + 1) int32, the first entry
    of each row of each plane and, last, the end of the plane's entries."""
    e = ent.numpy().reshape(-1, 3)
    e = e[np.argsort(e[:, 0], kind="stable")]
    w = n + 1
    plane, row = e[:, 0] // (n * w), (e[:, 0] % (n * w)) // w
    row_ent = np.stack([e[:, 0] % w, e[:, 1], e[:, 2]], axis=1)
    # entries before row i of plane c: those of lower (plane, row)
    key = plane * n + row
    starts = np.searchsorted(key, np.arange(2 * n + 1))
    row_ptr = np.stack([starts[c * n:c * n + n + 1] for c in range(2)])
    return (torch.as_tensor(row_ent.astype(np.int32)),
            torch.as_tensor(row_ptr.astype(np.int32)))


def fused_group_for(n: int) -> int:
    """Lanes of a K7 group for systems of n unknowns: the smallest of
    ``K7_GROUPS`` that holds n rows."""
    for g in K7_GROUPS:
        if 1 <= n <= g:
            return g
    raise ValueError(f"K7 takes 1 <= N <= {K7_GROUPS[-1]}, got N={n}")


def k5_form_for(n: int, dtype: torch.dtype) -> tuple[str, int]:
    """K5's form for systems of n unknowns in ``dtype``: ("register", n)
    up to ``K5_REG_MAX_N``, else ("group", the lanes per system)."""
    if not 1 <= n <= FUSED_MAX_N:
        raise ValueError(f"K5 takes 1 <= N <= {FUSED_MAX_N}, got N={n}")
    if n <= K5_REG_MAX_N[dtype]:
        return "register", n
    return "group", fused_group_for(n)


def combine_values(r_vals: torch.Tensor, c_vals: torch.Tensor,
                   l_vals: torch.Tensor, v_re: torch.Tensor,
                   v_im: torch.Tensor, ext: dict | None = None,
                   i_re: torch.Tensor | None = None,
                   i_im: torch.Tensor | None = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stack every per-variant value array into one (n_rows, B) matrix in
    the row order build_stamp_pattern assigns. (B, 0) groups contribute
    no rows; unbatched (nI,) current phasors broadcast."""
    B = r_vals.shape[0]
    cols = [r_vals, c_vals, l_vals, v_re, v_im]
    if ext is not None:
        cols.append(i_re[None, :].expand(B, i_re.shape[0]))
        cols.append(i_im[None, :].expand(B, i_im.shape[0]))
        cols.extend([ext["g_gm"], ext["e_gain"], ext["f_gain"],
                     ext["h_r"]])
    vals = torch.cat([c.to(dtype) for c in cols], dim=1)
    return vals.T.contiguous()  # (n_rows, B)


def _term_values(packed: PackedPattern, values: torch.Tensor,
                 w: torch.Tensor, eps: float) -> torch.Tensor:
    """Every term's value for every (frequency, variant): (n_terms, F, B)."""
    row = packed.terms[:, 1].long()
    sign = packed.terms[:, 2].to(values.dtype)[:, None, None]
    v = values[row][:, None, :]                       # (n_terms, 1, B)
    wv = w[None, :, None] * v                         # (n_terms, F, B)
    shape = wv.shape
    k = packed.terms[:, 0][:, None, None].expand(shape)
    out = sign.expand(shape)                          # kind "one"
    out = torch.where(k == KINDS["inv"], (sign / v).expand(shape), out)
    out = torch.where(k == KINDS["lin"], (sign * v).expand(shape), out)
    out = torch.where(k == KINDS["w"], sign * w[None, :, None] * v, out)
    # winv: open circuit below EPS (simulateAC.ts:47-52)
    small = wv.abs() < eps
    one = torch.ones((), dtype=values.dtype, device=values.device)
    winv = torch.where(small, torch.zeros_like(wv),
                       -sign / torch.where(small, one, wv))
    return torch.where(k == KINDS["winv"], winv, out)


def _plain_planes(freqs: torch.Tensor, values: torch.Tensor,
                  packed: PackedPattern, eps: float) -> torch.Tensor:
    """The dense assembly of the plain versions: (2, n, n+1, F, B) planes,
    zero where no entry writes, each entry the sum of its terms in table
    order."""
    n = packed.n
    F, B = freqs.shape[0], values.shape[1]
    w = (2.0 * math.pi) * freqs.to(values.dtype)
    tv = _term_values(packed, values, w, eps)
    planes = torch.zeros((2 * n * (n + 1), F, B), dtype=values.dtype,
                         device=values.device)
    for pos, t0, t1 in packed.ent.cpu().tolist():
        acc = tv[t0]
        for t in range(t0 + 1, t1):
            acc = acc + tv[t]
        planes[pos] = acc
    return planes.reshape(2, n, n + 1, F, B)


def _solve(planes: torch.Tensor, eps: float
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain ``gj_solve_planes`` of (2, n, n+1, F, B) planes: (x_re,
    x_im (F, B, n), valid (F, B))."""
    n = planes.shape[1]
    planes = planes.permute(0, 3, 4, 1, 2)
    return gj_solve_planes(planes[0, ..., :n], planes[1, ..., :n],
                           planes[0, ..., n], planes[1, ..., n], eps=eps)


def mc_ac_fused_plain(freqs: torch.Tensor, values: torch.Tensor,
                      packed: PackedPattern, node_idx: int,
                      eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5. freqs (F,), values (n_rows, B) -> (mag (B, F),
    valid (B, F)), in the dtype of ``values``."""
    x_re, x_im, valid = _solve(_plain_planes(freqs, values, packed, eps),
                               eps)
    xr, xi = x_re[..., node_idx], x_im[..., node_idx]
    return torch.sqrt(xr * xr + xi * xi).T, valid.T


def _check_rhs_mode(packed: PackedPattern, rhs: tuple | None) -> None:
    if (rhs is None) == packed.ext_rhs:
        raise ValueError(
            "K7 takes an external RHS exactly with tables packed for it "
            "(pack_pattern(..., ext_rhs=True))")


def mc_ac_fused_x_plain(freqs: torch.Tensor, values: torch.Tensor,
                        packed: PackedPattern,
                        rhs: tuple[torch.Tensor, torch.Tensor] | None = None,
                        eps: float = EPS
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7. freqs (F,), values (n_rows, B), optional rhs =
    (rr, ri) (F, N, B) replacing the pattern's RHS column -> (xr, xi
    (F, N, B), valid (F, B) bool), in the dtype of ``values``."""
    _check_rhs_mode(packed, rhs)
    planes = _plain_planes(freqs, values, packed, eps)
    if rhs is not None:
        n = packed.n
        for c in range(2):
            planes[c, :, n] = rhs[c].to(values.dtype).permute(1, 0, 2)
    x_re, x_im, valid = _solve(planes, eps)
    return (x_re.permute(0, 2, 1).contiguous(),
            x_im.permute(0, 2, 1).contiguous(), valid)


_LAUNCH_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_void_p] * 3
_LAUNCH_X_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_double] + [
    ctypes.c_void_p] * 6
_SIGNATURES = {
    "mc_ac_fused_f32": (_LAUNCH_ARGS, ctypes.c_int),
    "mc_ac_fused_f64": (_LAUNCH_ARGS, ctypes.c_int),
    "mc_ac_fused_x_f32": (_LAUNCH_X_ARGS, ctypes.c_int),
    "mc_ac_fused_x_f64": (_LAUNCH_X_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("mc_ac_fused", _SIGNATURES)


def _check_launch(freqs: torch.Tensor, values: torch.Tensor,
                  packed: PackedPattern, what: str,
                  extra: tuple = ()) -> None:
    """The argument checks K5 and K7 share; ``extra`` tensors must also be
    CUDA, contiguous and on the values' device."""
    n = packed.n
    if not 1 <= n <= FUSED_MAX_N:
        raise ValueError(f"{what} takes 1 <= N <= {FUSED_MAX_N}, got N={n}")
    if values.ndim != 2 or values.shape[0] != packed.n_rows \
            or freqs.ndim != 1:
        raise ValueError("values must be (n_rows, B) and freqs (F,)")
    if values.dtype not in (torch.float32, torch.float64) \
            or freqs.dtype != values.dtype:
        raise TypeError(f"{what} takes float32 or float64 freqs and values")
    tables = (packed.ent, packed.terms, packed.zeros, packed.row_ent,
              packed.row_ptr, packed.flat)
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"{what} takes int32 pattern tables")
    ts = (freqs, values) + tables + extra
    if any(not t.is_cuda or t.device != values.device for t in ts):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")
    if freqs.shape[0] > 65535 or values.shape[1] >= 2**31:
        raise ValueError(f"{what} takes at most 65535 frequencies (one grid "
                         "row each) and fewer than 2^31 variants")


def mc_ac_fused_cuda(freqs: torch.Tensor, values: torch.Tensor,
                     packed: PackedPattern, node_idx: int,
                     eps: float = EPS, form: str | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K5. freqs (F,), values (n_rows, B), both CUDA, contiguous and
    of one dtype (float32 or float64); the pattern's tables on the same
    device. Returns (mag, valid) as (B, F) views of (F, B) outputs.
    ``form`` forces one of ``FORMS`` (for the comparisons and the
    profiles); None takes ``k5_form_for``'s."""
    if packed.ext_rhs:
        raise ValueError("K5 takes tables with the pattern's RHS column")
    _check_launch(freqs, values, packed, "K5")
    n = packed.n
    if not 0 <= node_idx < n:
        raise ValueError(f"node index {node_idx} outside the system")
    form = k5_form_for(n, values.dtype)[0] if form is None else form
    if form not in FORMS or (form == "register" and n > REG_MAX_N):
        raise ValueError(f"K5 has no form {form!r} at N={n}")
    lib = load_library()
    F, B = freqs.shape[0], values.shape[1]
    mag = torch.empty((F, B), dtype=values.dtype, device=values.device)
    valid = torch.empty((F, B), dtype=torch.bool, device=values.device)
    fn = lib.mc_ac_fused_f64 if values.dtype == torch.float64 \
        else lib.mc_ac_fused_f32
    with torch.cuda.device(values.device):
        code = fn(ptr(freqs), ptr(values), F, B, ptr(packed.flat),
                  packed.flat.shape[0], ptr(packed.terms), ptr(packed.zeros),
                  packed.zeros.shape[0], ptr(packed.row_ent),
                  ptr(packed.row_ptr), n, node_idx, float(eps),
                  FORMS.index(form), fused_group_for(n), ptr(mag), ptr(valid),
                  stream_ptr(values.device))
        check(code, f"mc_ac_fused {form} launch")
    K5[values.dtype].launches += 1
    K5_FORMS[values.dtype][form] += 1
    return mag.T, valid.T


def mc_ac_fused_x_cuda(freqs: torch.Tensor, values: torch.Tensor,
                       packed: PackedPattern,
                       rhs: tuple[torch.Tensor, torch.Tensor] | None = None,
                       eps: float = EPS
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7. freqs (F,), values (n_rows, B) as for K5; ``rhs`` =
    (rr, ri), each (F, N, B) CUDA, contiguous, of the values' dtype, with
    tables packed for it. Returns (xr, xi (F, N, B), valid (F, B) bool)."""
    _check_rhs_mode(packed, rhs)
    extra = () if rhs is None else tuple(rhs)
    _check_launch(freqs, values, packed, "K7", extra)
    n = packed.n
    F, B = freqs.shape[0], values.shape[1]
    if any(r.shape != (F, n, B) or r.dtype != values.dtype for r in extra):
        raise ValueError("K7 takes rhs planes (F, N, B) of the values' "
                         "dtype")
    lib = load_library()
    xr = torch.empty((F, n, B), dtype=values.dtype, device=values.device)
    xi = torch.empty_like(xr)
    valid = torch.empty((F, B), dtype=torch.bool, device=values.device)
    fn = lib.mc_ac_fused_x_f64 if values.dtype == torch.float64 \
        else lib.mc_ac_fused_x_f32
    rr, ri = (None, None) if rhs is None else (ptr(rhs[0]), ptr(rhs[1]))
    with torch.cuda.device(values.device):
        code = fn(ptr(freqs), ptr(values), F, B, ptr(packed.row_ent),
                  ptr(packed.row_ptr), ptr(packed.terms), n,
                  fused_group_for(n), float(eps), rr, ri, ptr(xr), ptr(xi),
                  ptr(valid),
                  stream_ptr(values.device))
        check(code, "mc_ac_fused_x launch")
    K7[values.dtype].launches += 1
    return xr, xi, valid


def mc_ac_fused_x(freqs: torch.Tensor, values: torch.Tensor,
                  packed: PackedPattern,
                  rhs: tuple[torch.Tensor, torch.Tensor] | None = None,
                  eps: float = EPS
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assemble+solve with full solutions: K7 on CUDA tensors, the
    plain version on the CPU. freqs (F,), values (n_rows, B), optional rhs
    (rr, ri) (F, N, B) -> (xr, xi (F, N, B), valid (F, B))."""
    if values.is_cuda:
        return mc_ac_fused_x_cuda(freqs, values, packed, rhs, eps)
    return mc_ac_fused_x_plain(freqs, values, packed, rhs, eps)


def mc_ac_fused(freqs: torch.Tensor, values: torch.Tensor,
                packed: PackedPattern, node_idx: int,
                eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused assemble+solve: K5 on CUDA tensors, the plain version on the
    CPU. freqs (F,), values (n_rows, B) -> (mag (B, F), valid (B, F))."""
    if values.is_cuda:
        return mc_ac_fused_cuda(freqs, values, packed, node_idx, eps)
    return mc_ac_fused_plain(freqs, values, packed, node_idx, eps)
