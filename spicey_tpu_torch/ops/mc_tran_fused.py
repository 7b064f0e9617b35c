"""Fused Monte-Carlo linear transient: kernel K8 (csrc/mc_tran_fused.cu).

Replaces ``spicey_tpu/ops/pallas_mc_tran.py:_fused_tran_kernel``, the
linear branch of ``mc_tran_fused_f32``. For a linear circuit under
backward-Euler companions the MNA matrix is the same at every step, so
per variant the kernel builds A from the static stamp pattern and the
(n_rows, B) value slab, reduces [A | I] once, and runs all S+1 steps
with only the RHS changing; only the values go in and the (S+1, B)
trajectory of V(node) comes out. f32 only, as the JAX tier.

``build_tran_pattern`` is the JAX function for the linear device set
(R/C/L/V plus extended I/G/E/F/H); its value rows are [R | gc = C/dt |
gl = dt/L | g | e | f | h]. ``pack_tran_pattern`` flattens it into int32
tables the way K5's pattern is packed (``mc_ac_fused.pack_entries``),
with A's entries placed in the [A | I] layout the kernel reduces.
``mc_tran_fused_plain`` is the plain PyTorch version: the same
assembly, the plain ``gj_inverse``, and the step loop with the same sum
order (sources, then C terms, then L terms per RHS row; the matvec over
the RHS rows in ascending order).

The nonlinear twin (K9, ``_fused_tran_nr_kernel``) is not ported yet
(ROADMAP §1 item 1).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import EPS
from ._build import SMEM_MAX, Kernel, check, load, ptr, stream_ptr
from .linsolve import gj_inverse
from .mc_ac_fused import KINDS, int32_table, pack_entries

# the fused tier's eligibility bound, as in the JAX package
FUSED_MAX_N = 16

K8 = {torch.float32: Kernel(name="mc_tran_fused_f32",
                            source="spicey_tpu_torch/csrc/mc_tran_fused.cu",
                            replaces="spicey_tpu/ops/pallas_mc_tran.py:789")}


def build_tran_pattern(n: int, r_idx: object, c_idx: object, l_idx: object,
                       v_idx: object, n_src_i: int,
                       ext_idx: dict | None = None) -> tuple:
    """Static pattern of a linear deck: (n_rows, a_entries, b_src,
    c_state, l_state), the first five fields of the JAX package's
    ``build_tran_pattern`` (pallas_mc_tran.py:74-242) for the same deck.

    ``a_entries`` is ((i, j), terms) with term kinds "one"/"inv"/"lin";
    ``b_src`` is (row, src_col, sign) into the (S+1, nSrc) source grid (V
    branch values first, then I injections); ``c_state``/``l_state`` are
    (elem, i1, i2, value_row) with dump-slot indices kept (>= n is
    ground)."""
    a_t: dict = {}

    def add(i: int, j: int, term: tuple) -> None:
        if i < n and j < n:
            a_t.setdefault((int(i), int(j)), []).append(term)

    def adm(idx: object, kind: str, base: int) -> None:
        for k, (i1, i2) in enumerate(np.asarray(idx).reshape(-1, 2)):
            for (a, b, s) in ((i1, i1, 1.0), (i2, i2, 1.0),
                              (i1, i2, -1.0), (i2, i1, -1.0)):
                add(a, b, (kind, base + k, s))

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
    c_state = tuple((k, int(c[k, 0]), int(c[k, 1]), off_gc + k)
                    for k in range(n_c))
    l_state = tuple((k, int(l_arr[k, 0]), int(l_arr[k, 1]), off_gl + k)
                    for k in range(n_l))
    a_entries = tuple(sorted((ij, tuple(terms)) for ij, terms in a_t.items()))
    return base, a_entries, tuple(b_src), c_state, l_state


@dataclass(frozen=True)
class TranPattern:
    """A linear transient pattern as int32 tables on one device.

    ``ent``/``terms``/``zeros`` place A's entries at ``i * 2n + j`` of
    the [A | I] planes (``mc_ac_fused.pack_entries``); ``bsrc`` (n_b, 3) =
    [row, source column, sign]; ``cst``/``lst`` (n_c|n_l, 3) = [i1, i2,
    value row] of the C and L companions; ``b_rows`` the bitmask of RHS
    rows that any term reaches (the matvec skips the others, as the TPU
    kernel does at trace time)."""

    n: int
    n_rows: int
    ent: torch.Tensor
    terms: torch.Tensor
    zeros: torch.Tensor
    bsrc: torch.Tensor
    cst: torch.Tensor
    lst: torch.Tensor
    b_rows: int


def pack_tran_pattern(pattern: tuple, n: int,
                      device: torch.device | str) -> TranPattern:
    n_rows, a_entries, b_src, c_state, l_state = pattern
    ent, terms, zeros = pack_entries((a_entries,), n, 2 * n, device)
    rows = {i for i, _c, _s in b_src}
    for _k, i1, i2, _row in c_state + l_state:
        rows.update(i for i in (i1, i2) if i < n)
    return TranPattern(
        n=n, n_rows=int(n_rows), ent=ent, terms=terms, zeros=zeros,
        bsrc=int32_table([(i, col, int(s)) for i, col, s in b_src], 3,
                         device),
        cst=int32_table([(i1, i2, row) for _k, i1, i2, row in c_state], 3,
                        device),
        lst=int32_table([(i1, i2, row) for _k, i1, i2, row in l_state], 3,
                        device),
        b_rows=sum(1 << i for i in rows))


def mc_tran_fused_plain(vs_grid: torch.Tensor, values: torch.Tensor,
                        pattern: TranPattern, node_idx: int,
                        eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8. vs_grid (S+1, nSrc), values (n_rows, B) ->
    (v_node (B, S+1), valid (B,)), in the dtype of ``values``."""
    n, B = pattern.n, values.shape[1]
    dtype, dev = values.dtype, values.device
    # 1. A from the tables: each entry the sum of its terms in table order
    row = pattern.terms[:, 1].long()
    kind = pattern.terms[:, 0][:, None]
    sign = pattern.terms[:, 2].to(dtype)[:, None]
    v = values[row]                                         # (n_terms, B)
    tv = torch.where(kind == KINDS["inv"], sign / v, sign * v)
    tv = torch.where(kind == KINDS["one"], sign.expand_as(tv), tv)
    planes = torch.zeros((n * 2 * n, B), dtype=dtype, device=dev)
    for pos, t0, t1 in pattern.ent.cpu().tolist():
        acc = tv[t0]
        for t in range(t0 + 1, t1):
            acc = acc + tv[t]
        planes[pos] = acc
    A = planes.reshape(n, 2 * n, B)[:, :n].permute(2, 0, 1)
    # 2. factor once
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


_LAUNCH_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                 ctypes.c_double] + [ctypes.c_void_p] * 3)
_SIGNATURES = {
    "mc_tran_fused_bytes_per_variant": ([ctypes.c_int] * 3,
                                        ctypes.c_size_t),
    "mc_tran_fused_f32": (_LAUNCH_ARGS, ctypes.c_int),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("mc_tran_fused", _SIGNATURES)


def mc_tran_fused_cuda(vs_grid: torch.Tensor, values: torch.Tensor,
                       pattern: TranPattern, node_idx: int,
                       eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8. vs_grid (S+1, nSrc) and values (n_rows, B), both CUDA,
    contiguous float32; the pattern's tables on the same device. Returns
    (v_node, valid) as a (B, S+1) view of the (S+1, B) trajectory and
    (B,)."""
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
    lib = load_library()
    n_c, n_l = pattern.cst.shape[0], pattern.lst.shape[0]
    if 32 * lib.mc_tran_fused_bytes_per_variant(n, n_c, n_l) > SMEM_MAX:
        raise ValueError("K8: the deck's per-variant state does not fit "
                         "32 variants in one block's shared memory")
    out = torch.empty((n_steps, B), dtype=torch.float32, device=values.device)
    valid = torch.empty((B,), dtype=torch.bool, device=values.device)
    code = lib.mc_tran_fused_f32(
        ptr(vs_grid), vs_grid.shape[1], n_steps, ptr(values), B,
        ptr(pattern.ent), pattern.ent.shape[0], ptr(pattern.terms),
        ptr(pattern.zeros), pattern.zeros.shape[0], ptr(pattern.bsrc),
        pattern.bsrc.shape[0], ptr(pattern.cst), n_c, ptr(pattern.lst), n_l,
        pattern.b_rows, n, node_idx, float(eps), ptr(out), ptr(valid),
        stream_ptr(values.device))
    check(code, "mc_tran_fused launch")
    K8[torch.float32].launches += 1
    return out.T, valid


def mc_tran_fused(vs_grid: torch.Tensor, values: torch.Tensor,
                  pattern: TranPattern, node_idx: int,
                  eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused linear transient: K8 on CUDA tensors, the plain version on
    the CPU. -> (v_node (B, S+1), valid (B,))."""
    if values.is_cuda:
        return mc_tran_fused_cuda(vs_grid, values, pattern, node_idx, eps)
    return mc_tran_fused_plain(vs_grid, values, pattern, node_idx, eps)
