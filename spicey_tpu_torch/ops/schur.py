"""Structured bordered-block-diagonal (Schur-complement) solver tier.

A port of ``spicey_tpu/ops/schur.py``. The dense Gauss-Jordan of the
other tiers is O(N^3) per system; real boards are bigger but
*structured*: the extended dialect's ``.subckt`` flattener names every
instance element ``<el>.<instance-path>`` (parsing/netlist.py), so the MNA
matrix is bordered block diagonal. Each instance's interior unknowns
couple only among themselves and to a thin interface border (ports,
top-level nets).

  1. ``plan_partition`` and ``plan_partition_op`` (host, NumPy) derive the
     partition from element connectivity, as the JAX package does, line
     for line, so the two packages' plans are equal array for array. An
     unknown is interior to block g iff every element that stamps it
     belongs to instance group g; a fixpoint pass promotes structurally
     singular block rows and columns to the interface.
  2. ``schur_solve`` / ``schur_solve_planes`` (device, batch-first): gather
     the K padded (n_max, n_max) diagonal blocks and their borders from the
     dense assembled systems, solve every block with its full right block
     [b_k | B_k] in ONE batched multi-right-hand-side Gauss-Jordan
     (``linsolve.solve_multi`` / ``solve_planes_multi``: kernels K2 and K1,
     their "multi" entry on the card), form the interface Schur complement
     S = D - sum_k C_k A_kk^{-1} B_k as one (N_I x K n) by (K n x N_I)
     product per system (four real ones per complex product), solve S with
     its right-hand sides (the same multi entry: the panel tier at
     N_I > 32) and back-substitute. Flops drop from N^3 to about
     K n^2 (n + N_I) + N_I^3.

Pivoting is partial within blocks and within the Schur system, the
classic BBD compromise. A system's ``valid`` flag is all its block flags
AND the flag of its S solve; callers retry dense where it is False, as the
JAX package's do.

Two recorded faults of the JAX package's planner are kept for parity
(ROADMAP §3): ``plan_partition_op`` appends inductor branches to the
interface after the cap and the flop model were checked, so it can
exceed its interface cap; and the interface the JAX docstring calls
"N_I <= ~128" is capped at ``max(256, nvar // 2)``.

A CUDA tensor runs the kernels, a CPU tensor their plain versions; the
gathers, the products and the scatter are torch operations either way.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import EPS
from .linsolve import solve_multi, solve_planes_multi


# ---------------------------------------------------------------------------
# Host-side partition planning (the JAX package's, unchanged)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SchurPlan:
    """Static partition of the MNA unknowns for the structured tier.

    blk_ix[k, i] is the global unknown index of block k's i-th interior
    slot (0-padded where blk_mask is False); if_ix lists the interface
    unknowns. Together they cover every unknown exactly once.
    """

    blk_ix: np.ndarray    # (K, n_max) int32
    blk_mask: np.ndarray  # (K, n_max) bool
    if_ix: np.ndarray     # (N_I,) int32
    nvar: int
    group_names: tuple[str, ...] = field(default=())

    @property
    def n_blocks(self) -> int:
        return self.blk_ix.shape[0]

    @property
    def n_max(self) -> int:
        return self.blk_ix.shape[1]

    @property
    def n_interface(self) -> int:
        return self.if_ix.shape[0]

    def arrays(self, device: torch.device | str = "cpu") -> dict:
        """The plan as tensors on ``device``, as the solvers take it."""
        return {
            "blk_ix": torch.as_tensor(self.blk_ix.astype(np.int64),
                                      device=device),
            "blk_mask": torch.as_tensor(self.blk_mask, device=device),
            "if_ix": torch.as_tensor(self.if_ix.astype(np.int64),
                                     device=device),
        }


def _group_of(name: str) -> str | None:
    """Top-level instance group of a flattened element name.

    The flattener suffixes names with the instance path (``r1.x3.x1`` = r1
    inside x3 inside x1), so the LAST dot component is the top-level
    instance. Top-level elements have no suffix -> None. Correctness never
    depends on this being subckt-derived: the partition is validated by
    connectivity, so an accidental dot in a user name can only change the
    blocking, not the solution.
    """
    if "." in name:
        return name.rsplit(".", 1)[1].lower()
    return None


def _element_structs(tensors: object) -> list[tuple[str | None, list[int],
                                            list[tuple[int, int]]]]:
    """(group, touched-unknowns, structural (row, col) entries) per element.

    Mirrors the stamp patterns of ops/stamps.py; dump-slot (ground)
    indices are filtered out. Touch sets drive interface detection; the
    (row, col) pairs drive the structural-singularity promotion pass.
    """
    out: list[tuple[str | None, list[int], list[tuple[int, int]]]] = []
    dump = tensors.nvar

    def adm(idx_arr: np.ndarray, names: tuple) -> None:
        for (i1, i2), nm in zip(idx_arr, names):
            i1, i2 = int(i1), int(i2)
            touch = [u for u in (i1, i2) if u != dump]
            pairs = [(r, c) for r in (i1, i2) for c in (i1, i2)
                     if r != dump and c != dump]
            out.append((_group_of(nm), touch, pairs))

    adm(tensors.r_idx, tensors.r_names)
    adm(tensors.c_idx, tensors.c_names)
    adm(tensors.l_idx, tensors.l_names)
    adm(tensors.d_idx, tensors.d_names)
    # switches stamp Ron/Roff admittance between i1, i2 in TRAN; control
    # nodes are read from x only (no matrix entry)
    adm(tensors.s_idx[:, :2] if tensors.s_idx.size else tensors.s_idx,
        tensors.s_names)

    for (i1, i2, br), nm in zip(tensors.v_idx, tensors.v_names):
        i1, i2, br = int(i1), int(i2), int(br)
        touch = [u for u in (i1, i2, br) if u != dump]
        pairs = []
        for n in (i1, i2):
            if n != dump:
                pairs += [(n, br), (br, n)]
        out.append((_group_of(nm), touch, pairs))

    for row, nm in zip(tensors.g_idx, tensors.g_names):
        i1, i2, cp, cn = (int(v) for v in row)
        touch = [u for u in (i1, i2, cp, cn) if u != dump]
        pairs = [(r, c) for r in (i1, i2) for c in (cp, cn)
                 if r != dump and c != dump]
        out.append((_group_of(nm), touch, pairs))

    for row, nm in zip(tensors.e_idx, tensors.e_names):
        i1, i2, br, cp, cn = (int(v) for v in row)
        touch = [u for u in (i1, i2, br, cp, cn) if u != dump]
        pairs = []
        for n in (i1, i2):
            if n != dump:
                pairs += [(n, br), (br, n)]
        for c in (cp, cn):
            if c != dump:
                pairs.append((br, c))
        out.append((_group_of(nm), touch, pairs))

    for row, nm in zip(tensors.f_idx, tensors.f_names):
        i1, i2, cb = (int(v) for v in row)
        touch = [u for u in (i1, i2, cb) if u != dump]
        pairs = [(r, cb) for r in (i1, i2) if r != dump]
        out.append((_group_of(nm), touch, pairs))

    for row, nm in zip(tensors.h_idx, tensors.h_names):
        i1, i2, br, cb = (int(v) for v in row)
        touch = [u for u in (i1, i2, br, cb) if u != dump]
        pairs = [(br, cb)]
        for n in (i1, i2):
            if n != dump:
                pairs += [(n, br), (br, n)]
        out.append((_group_of(nm), touch, pairs))

    def three_term(idx_arr: np.ndarray, names: tuple) -> None:
        # the Newton linearization cross-couples all terminal pairs (an
        # over-approximation is safe: extra structural entries can only
        # ADD interface nodes or keep a row the valid flag would catch)
        for row, nm in zip(idx_arr, names):
            ids = [int(v) for v in row]
            touch = [u for u in ids if u != dump]
            pairs = [(r, c) for r in touch for c in touch]
            out.append((_group_of(nm), touch, pairs))

    three_term(tensors.m_idx, tensors.m_names)
    three_term(tensors.q_idx, tensors.q_names)

    for row, nm in zip(tensors.t_idx, tensors.t_names):
        i1, i2, i3, i4, b1, b2 = (int(v) for v in row)
        touch = [u for u in (i1, i2, i3, i4, b1, b2) if u != dump]
        pairs = [(b1, b1), (b2, b2), (b1, b2), (b2, b1)]
        for (p, q, br, op_, oq) in ((i1, i2, b1, i3, i4),
                                    (i3, i4, b2, i1, i2)):
            for n in (p, q):
                if n != dump:
                    pairs += [(n, br), (br, n)]
            for n in (op_, oq):
                if n != dump:
                    pairs.append((br, n))
        out.append((_group_of(nm), touch, pairs))

    # current sources are RHS-only: no matrix entries, no touch needed
    return out


def plan_partition(ckt: object, tensors: object,
                   max_interface: int | None = None,
                   min_blocks: int = 2,
                   min_speedup: float = 2.0) -> SchurPlan | None:
    """Derive a BBD partition from the circuit, or None if not worthwhile.

    Returns None when: behavioral sources exist (their v()/i() references
    couple arbitrary unknowns), mutual couplings exist (the dense M^{-1}
    companion couples every inductor), fewer than ``min_blocks`` non-empty
    blocks emerge, the interface exceeds ``max_interface``, or the
    estimated flop ratio vs dense elimination is below ``min_speedup``.

    ``max_interface`` defaults to ``max(256, nvar // 2)``: the
    profitability guard is the flop model, not the absolute border size.
    """
    if ckt is not None and getattr(ckt, "B", None):
        return None
    if tensors.n_k:
        return None
    nvar = tensors.nvar
    if nvar < 32:
        return None
    if max_interface is None:
        max_interface = max(256, nvar // 2)

    elems = _element_structs(tensors)

    touch_groups: dict[int, set] = {}
    for g, touch, _ in elems:
        for u in touch:
            touch_groups.setdefault(u, set()).add(g)

    block_of: dict[int, str] = {}
    interface: set[int] = set()
    for u in range(nvar):
        gs = touch_groups.get(u, set())
        if len(gs) == 1 and None not in gs:
            block_of[u] = next(iter(gs))
        else:
            # untouched unknowns and multi-group / top-level unknowns go to
            # the border
            interface.add(u)

    # structural adjacency (rows -> cols and the reverse)
    adj: dict[int, set] = {}
    radj: dict[int, set] = {}
    for _, _, pairs in elems:
        for r, c in pairs:
            adj.setdefault(r, set()).add(c)
            radj.setdefault(c, set()).add(r)

    # fixpoint: a block row/column that has no structural entry inside its
    # own block would make A_kk singular (e.g. a V branch between two
    # ports); promote such unknowns to the interface
    changed = True
    while changed:
        changed = False
        for u in list(block_of):
            g = block_of[u]
            row_ok = any(c == u or block_of.get(c) == g
                         for c in adj.get(u, ()))
            col_ok = any(r == u or block_of.get(r) == g
                         for r in radj.get(u, ()))
            if not (row_ok and col_ok):
                del block_of[u]
                interface.add(u)
                changed = True

    groups: dict[str, list[int]] = {}
    for u, g in block_of.items():
        groups.setdefault(g, []).append(u)
    groups = {g: sorted(us) for g, us in groups.items() if us}
    if len(groups) < min_blocks:
        return None
    n_i = len(interface)
    if n_i == 0 or n_i > max_interface:
        return None

    K = len(groups)
    n_max = max(len(us) for us in groups.values())
    # flop model: block eliminations (multi-RHS width n_max + N_I + 1),
    # Schur products, interface solve, against one dense elimination
    flops_schur = (K * n_max * n_max * (n_max + n_i + 1)
                   + 2 * K * n_max * n_i * (n_max + n_i)
                   + n_i ** 3)
    flops_dense = nvar ** 3
    if flops_dense < min_speedup * flops_schur:
        return None

    names = tuple(sorted(groups))
    blk_ix = np.zeros((K, n_max), np.int32)
    blk_mask = np.zeros((K, n_max), bool)
    for k, g in enumerate(names):
        us = groups[g]
        blk_ix[k, :len(us)] = us
        blk_mask[k, :len(us)] = True
    if_ix = np.asarray(sorted(interface), np.int32)
    return SchurPlan(blk_ix=blk_ix, blk_mask=blk_mask, if_ix=if_ix,
                     nvar=nvar, group_names=names)


def plan_partition_op(ckt: object, tensors: object,
                      **kw: object) -> SchurPlan | None:
    """Partition for the DC operating-point system (analysis/op.py).

    Op unknowns 0..nvar-1 are exactly the tran/AC unknowns; one extra
    0 V-short branch per inductor is appended at nvar+k (``_op_indices``),
    so the base plan transfers with two deltas:

      - capacitors stamp NOTHING at DC: structural entries only disappear,
        which can never put an entry outside the partition; a block made
        structurally singular by a vanished C is caught by the per-system
        valid flag and the caller's dense retry;
      - each inductor's admittance pattern becomes the V-short pattern.
        The branch joins its inductor's block when one of the nodes is
        interior there, and borders otherwise (an L between two ports).
        The branches join after the interface cap was checked, so this
        plan can exceed it (a fault of the JAX package's, kept for parity).
    """
    base = plan_partition(ckt, tensors, **kw)
    if base is None:
        return None
    nvar = tensors.nvar
    n_l = tensors.n_l
    if n_l == 0:
        return base
    block_of: dict[int, int] = {}
    for k in range(base.n_blocks):
        for i in range(base.n_max):
            if base.blk_mask[k, i]:
                block_of[int(base.blk_ix[k, i])] = k
    groups: dict[int, list[int]] = {k: [] for k in range(base.n_blocks)}
    for u, k in block_of.items():
        groups[k].append(u)
    interface = [int(u) for u in base.if_ix]
    gname = {g: k for k, g in enumerate(base.group_names)}
    for j, ((i1, i2), nm) in enumerate(zip(tensors.l_idx, tensors.l_names)):
        br = nvar + j
        g = _group_of(nm)
        k = gname.get(g) if g is not None else None
        if k is not None and (block_of.get(int(i1)) == k
                              or block_of.get(int(i2)) == k):
            groups[k].append(br)
        else:
            interface.append(br)
    K = base.n_blocks
    n_max = max(len(us) for us in groups.values())
    blk_ix = np.zeros((K, n_max), np.int32)
    blk_mask = np.zeros((K, n_max), bool)
    for k in range(K):
        us = sorted(groups[k])
        blk_ix[k, :len(us)] = us
        blk_mask[k, :len(us)] = True
    return SchurPlan(blk_ix=blk_ix, blk_mask=blk_mask,
                     if_ix=np.asarray(sorted(interface), np.int32),
                     nvar=nvar + n_l, group_names=base.group_names)


NO_PLAN = ("method='schur' requires block structure "
           "(subcircuit instances) the circuit does not have")


def plan_for(method: str, ckt: object, tensors: object, nvar: int,
             device: torch.device | str, op: bool = False) -> dict | None:
    """The JAX package's dispatch rule at every analysis that has one: a
    plan is sought when ``method="schur"`` forces it or when the default
    ``method="gj"`` meets a system of more than 128 unknowns (``nvar``:
    the analysis's own, nodes + branches, + the L shorts for ``op``);
    ``method="pallas"`` stays dense. Returns the plan's tensors on
    ``device``, or None; raises its ``ValueError`` when ``"schur"`` is
    forced on a circuit with no block structure."""
    if not (method == "schur" or (method == "gj" and nvar > 128)):
        return None
    plan = (plan_partition_op if op else plan_partition)(ckt, tensors)
    if plan is None:
        if method == "schur":
            raise ValueError(NO_PLAN)
        return None
    return plan.arrays(device)


# ---------------------------------------------------------------------------
# Device-side solves, batch-first
# ---------------------------------------------------------------------------


def _gather_blocks(A: torch.Tensor, blk_ix: torch.Tensor,
                   blk_mask: torch.Tensor, if_ix: torch.Tensor,
                   pad_diag: float
                   ) -> tuple[torch.Tensor, ...]:
    """Slice the diagonal blocks, their borders and the interface block
    out of the dense systems A (nb, N, N): Abb (nb, K, n, n), Bb (nb, K,
    n, N_I), Cb (nb, K, N_I, n), D (nb, N_I, N_I). A pad slot's row and
    column are zero but for ``pad_diag`` on its diagonal (1 on the real
    plane, so the pad solves to 0; 0 on the imaginary plane)."""
    n_max = blk_ix.shape[1]
    m2 = blk_mask[:, :, None] & blk_mask[:, None, :]
    eye = torch.eye(n_max, dtype=A.dtype, device=A.device) * pad_diag
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    Abb = torch.where(m2, A[:, blk_ix[:, :, None], blk_ix[:, None, :]], eye)
    Bb = torch.where(blk_mask[:, :, None],
                     A[:, blk_ix[:, :, None], if_ix[None, None, :]], zero)
    Cb = torch.where(blk_mask[:, None, :],
                     A[:, if_ix[None, :, None], blk_ix[:, None, :]], zero)
    D = A[:, if_ix[:, None], if_ix[None, :]]
    return Abb, Bb, Cb, D


def _rhs_parts(b: torch.Tensor, blk_ix: torch.Tensor,
               blk_mask: torch.Tensor, if_ix: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The right-hand sides b (nb, N, R) cut into the blocks' rows (nb, K,
    n, R), zero on pads, and the interface rows (nb, N_I, R)."""
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    bk = torch.where(blk_mask[:, :, None], b[:, blk_ix], zero)
    return bk, b[:, if_ix]


def _flat(Cb: torch.Tensor) -> torch.Tensor:
    """(nb, K, N_I, n) borders as one (nb, N_I, K n) matrix, so that
    sum_k C_k W_k is one product with W as (nb, K n, ...)."""
    nb, K, n_i, n = Cb.shape
    return Cb.permute(0, 2, 1, 3).reshape(nb, n_i, K * n)


def _scatter_back(xk: torch.Tensor, xI: torch.Tensor, blk_ix: torch.Tensor,
                  blk_mask: torch.Tensor, if_ix: torch.Tensor,
                  nvar: int) -> torch.Tensor:
    """Blocks' (nb, K, n, R) and interface (nb, N_I, R) answers into
    (nb, N, R); pads land in a dump slot that is cut off."""
    nb, K, n, R = xk.shape
    x = torch.zeros((nb, nvar + 1, R), dtype=xk.dtype, device=xk.device)
    safe_ix = torch.where(blk_mask, blk_ix, nvar).reshape(-1)
    x[:, safe_ix] = xk.reshape(nb, K * n, R)
    x[:, if_ix] = xI
    return x[:, :nvar]


def schur_solve(A: torch.Tensor, b: torch.Tensor, blk_ix: torch.Tensor,
                blk_mask: torch.Tensor, if_ix: torch.Tensor,
                eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Real structured solve of dense-assembled systems.

    A (..., N, N) straight from the assembly (the tier changes the solve,
    not the stamping); b (..., N); blk_ix/blk_mask/if_ix: a
    ``SchurPlan.arrays()``. Returns (x (..., N), valid (...))."""
    x, valid = schur_solve_multi(A, b[..., None], blk_ix, blk_mask, if_ix,
                                 eps)
    return x[..., 0], valid


def schur_solve_multi(A: torch.Tensor, B: torch.Tensor,
                      blk_ix: torch.Tensor, blk_mask: torch.Tensor,
                      if_ix: torch.Tensor, eps: float = EPS
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A X = B for R right-hand sides B (..., N, R): each column the
    arithmetic of ``schur_solve`` on it (the pivots depend on A alone), so
    the factor-once transient's A^-1 is one call with B = I."""
    lead, n_all, R = A.shape[:-2], A.shape[-1], B.shape[-1]
    A = A.reshape(-1, n_all, n_all)
    B = B.reshape(-1, n_all, R)
    nb = A.shape[0]
    Abb, Bb, Cb, D = _gather_blocks(A, blk_ix, blk_mask, if_ix, 1.0)
    bk, bI = _rhs_parts(B, blk_ix, blk_mask, if_ix)
    K, n = blk_ix.shape
    n_i = if_ix.shape[0]
    # every block's [b_k | B_k] in one batched multi-RHS elimination
    rhs = torch.cat([bk, Bb], dim=-1)                        # (nb,K,n,R+NI)
    Y, blk_valid = solve_multi(Abb.reshape(-1, n, n),
                               rhs.reshape(-1, n, R + n_i), eps=eps)
    Y = Y.reshape(nb, K * n, R + n_i)
    y, W = Y[..., :R], Y[..., R:]
    C = _flat(Cb)
    S = D - C @ W
    rS = bI - C @ y
    xI, s_valid = solve_multi(S, rS, eps=eps)
    xk = y - W @ xI
    valid = blk_valid.reshape(nb, K).all(dim=1) & s_valid
    x = _scatter_back(xk.reshape(nb, K, n, R), xI, blk_ix, blk_mask, if_ix,
                      n_all)
    return x.reshape(lead + (n_all, R)), valid.reshape(lead)


def schur_solve_planes(A_re: torch.Tensor, A_im: torch.Tensor,
                       b_re: torch.Tensor, b_im: torch.Tensor,
                       blk_ix: torch.Tensor, blk_mask: torch.Tensor,
                       if_ix: torch.Tensor, eps: float = EPS
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Complex structured solve on (re, im) planes: the algorithm of
    ``schur_solve_multi`` with plane arithmetic. The block eliminations
    and the interface solve pivot on |pivot|^2; each Schur product is four
    real products. A_* (..., N, N); b_* (..., N). Returns (x_re, x_im,
    valid)."""
    lead, n_all = A_re.shape[:-2], A_re.shape[-1]
    Ar = A_re.reshape(-1, n_all, n_all)
    Ai = A_im.reshape(-1, n_all, n_all)
    br = b_re.reshape(-1, n_all, 1)
    bi = b_im.reshape(-1, n_all, 1)
    nb = Ar.shape[0]
    Arr, Brr, Crr, Dr = _gather_blocks(Ar, blk_ix, blk_mask, if_ix, 1.0)
    # on a pad slot the imaginary diagonal is 0, the real one 1
    Aii, Bii, Cii, Di = _gather_blocks(Ai, blk_ix, blk_mask, if_ix, 0.0)
    bkr, bIr = _rhs_parts(br, blk_ix, blk_mask, if_ix)
    bki, bIi = _rhs_parts(bi, blk_ix, blk_mask, if_ix)
    K, n = blk_ix.shape
    n_i = if_ix.shape[0]
    w = 1 + n_i
    Yr, Yi, blk_valid = solve_planes_multi(
        Arr.reshape(-1, n, n), Aii.reshape(-1, n, n),
        torch.cat([bkr, Brr], dim=-1).reshape(-1, n, w),
        torch.cat([bki, Bii], dim=-1).reshape(-1, n, w), eps=eps)
    Yr = Yr.reshape(nb, K * n, w)
    Yi = Yi.reshape(nb, K * n, w)
    yr, Wr = Yr[..., :1], Yr[..., 1:]
    yi, Wi = Yi[..., :1], Yi[..., 1:]
    Cr, Ci = _flat(Crr), _flat(Cii)
    # S = D - sum_k C_k W_k, a complex product on planes
    Sr = Dr - (Cr @ Wr - Ci @ Wi)
    Si = Di - (Cr @ Wi + Ci @ Wr)
    rSr = bIr - (Cr @ yr - Ci @ yi)
    rSi = bIi - (Cr @ yi + Ci @ yr)
    xIr, xIi, s_valid = solve_planes_multi(Sr, Si, rSr, rSi, eps=eps)
    xkr = yr - (Wr @ xIr - Wi @ xIi)
    xki = yi - (Wr @ xIi + Wi @ xIr)
    valid = blk_valid.reshape(nb, K).all(dim=1) & s_valid
    x_re = _scatter_back(xkr.reshape(nb, K, n, 1), xIr, blk_ix, blk_mask,
                         if_ix, n_all)
    x_im = _scatter_back(xki.reshape(nb, K, n, 1), xIi, blk_ix, blk_mask,
                         if_ix, n_all)
    return (x_re.reshape(lead + (n_all,)), x_im.reshape(lead + (n_all,)),
            valid.reshape(lead))
