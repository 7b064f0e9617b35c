"""K11: a Newton pass's (A, b) written once from a stamp plan
(csrc/stamp_real.cu).

The JAX package assembles a pass with one scatter per stamp
(``spicey_tpu/ops/stamps.py``). Their port, ``ops/stamps.py``, is K11's
plain version and the CPU path: a pass of the batched time loop there is
~31 ``index_add_`` calls into a zero-filled padded (B, N+1, N+1) system,
each with its own index arithmetic, negation and constant, and K2 then
reads a strided slice of it through a copy. K11 writes the (B, N, N)
matrix and the (B, N) right-hand side once, contiguous, in the layout K2
reads, 0 where no stamp lands: the same sums, formed once.

Layouts. A pass's stamps are a list of ``(kind, key, slot, sign)`` in the
order the assembly makes them: ``kind`` names a scatter pattern (one
function of ops/stamps.py, a plain ``index_add_`` into b, or a list of
(row, column) pairs), ``key`` the index set it scatters through, ``slot``
the name of its value tensor (None: the constant 1) and ``sign`` +1 or -1
on that value. ``apply`` runs a layout through ops/stamps.py into a padded
system: the CPU path, the same calls in the same order as before K11.
``build_plan`` turns the same layout over the index sets' host arrays into
K11's plan: each contribution as (target entry, value slot, element,
sign), those to the ground dump slot dropped, grouped by target in the
layout's order. Each entry of A and b is then the sum of its
contributions in the order the sequential ``index_add_`` calls add them
(the CPU's ``index_add_`` adds one call's duplicate indices in element
order, as the plan does): bit-equal to the CPU path on the same values.

The kernel reads every value tensor in place, through its pointer and its
lane and element strides (lane stride 0 for an unbatched value): no value
is stacked, negated or copied, and the signs and constants live in the
plan. One launch takes at most ``MAX_SLOTS`` value tensors (its parameter
block); a layout with more splits into pages, each later page adding to
what the earlier ones wrote, so the order of the sums is kept. Every deck
of the repository has fewer, and takes one launch a pass.

Bound: bytes. A pass reads each value once and writes A and b once: at
the boost's 1M lanes x N = 6 in f64, 288 MB of A, 48 MB of b and ~64 MB
of values, ~0.12 ms at 3.35 TB/s. Two forms, by N (``form_for``, counted
in ``K11_FORMS``; csrc/stamp_real.cu says what each does): "tile", 32
lanes a block, a warp's threads on neighbouring lanes of one entry, the
systems staged in shared memory and stored as one contiguous run; "entry"
past the tile's N, one thread an entry, ``lanes_for(n)`` whole systems a
block.

Derivatives. The assembly is linear in the values. A value with a
forward-mode tangent or ``requires_grad`` goes through ``_Assemble``: its
JVP is K11 on the tangents with the constants dropped, its VJP the plan's
transpose (a signed gather of dA and db per value), as ops/linsolve.py's
rules wrap K2 (``RULE_CALLS`` counts them on the card).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ._build import Kernel, check, load, ptr, stream_ptr
from .linsolve import _differentiated
from .stamps import (stamp_admittance, stamp_cccs, stamp_ccvs, stamp_current,
                     stamp_mutual, stamp_tline_ports, stamp_vccs, stamp_vcvs,
                     stamp_voltage_source)

K11 = {dt: Kernel(name=f"stamp_real_{tag}",
                  source="spicey_tpu_torch/csrc/stamp_real.cu",
                  replaces="spicey_tpu/ops/stamps.py")
       for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))}

MAX_SLOTS = 64            # csrc/stamp_real.cu:MAX_SLOTS
BLOCK_ENTRIES = 2048      # entries of A and b one entry-form block writes
TILE_LANES = 32           # csrc/stamp_real.cu:TILE_LANES
TILE_BYTES_MAX = 46 * 1024   # csrc/stamp_real.cu:TILE_BYTES_MAX
_ACCUMULATE, _NO_CONST = 1, 2   # csrc/stamp_real.cu:FLAG_*
# the kernel's forms (csrc/stamp_real.cu:FORM_*), and each one's launches
FORMS = ("tile", "entry")
K11_FORMS = {dt: dict.fromkeys(FORMS, 0)
             for dt in (torch.float32, torch.float64)}

# Rule dispatches on a CUDA tensor: "forward" counts the primal launches
# made through the rules, "tangent" the JVP launches, "adjoint" the VJPs
# (a gather, no launch of K11).
RULE_CALLS = dict.fromkeys(("forward", "tangent", "adjoint"), 0)


def _pattern(A: torch.Tensor, rc: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """A[..., r_e, c_e] += y[..., e] for the (row, column) pairs ``rc``
    (nE, 2); a scalar ``y`` adds to every pair."""
    if rc.shape[0] == 0:
        return A
    n1 = A.shape[-1]
    lead = A.shape[:-2]
    A.view(*lead, n1 * n1).index_add_(
        -1, rc[:, 0] * n1 + rc[:, 1], y.to(A.dtype).expand(
            *lead, rc.shape[0]))
    return A


# each kind's plain version: ops/stamps.py's function, or a plain scatter
_APPLY = {
    "adm": lambda A, b, ix, v: stamp_admittance(A, ix, v),
    "cur": lambda A, b, ix, v: stamp_current(b, ix, v),
    "vsrc": lambda A, b, ix, v: stamp_voltage_source(A, b, ix, v),
    "tline": lambda A, b, ix, v: stamp_tline_ports(A, ix, v),
    "vec": lambda A, b, ix, v: b.index_add_(-1, ix, v),
    "mutual": lambda A, b, ix, v: stamp_mutual(A, ix, v),
    "vccs": lambda A, b, ix, v: stamp_vccs(A, ix, v),
    "vcvs": lambda A, b, ix, v: stamp_vcvs(A, ix, v),
    "cccs": lambda A, b, ix, v: stamp_cccs(A, ix, v),
    "ccvs": lambda A, b, ix, v: stamp_ccvs(A, ix, v),
    "pattern": lambda A, b, ix, v: _pattern(A, ix, v),
}


def apply(A_pad: torch.Tensor, b_pad: torch.Tensor, layout: list,
          index: dict, values: dict) -> None:
    """Run ``layout`` through ops/stamps.py into the padded system
    (``A_pad`` (..., n+1, n+1), ``b_pad`` (..., n+1)) in place: the plain
    version of K11. ``index``: key -> index tensor; ``values``: slot ->
    value tensor."""
    for kind, key, slot, sign in layout:
        if slot is None:
            v = torch.full((), float(sign), dtype=A_pad.dtype,
                           device=A_pad.device)
        else:
            v = values[slot] if sign > 0 else -values[slot]
        _APPLY[kind](A_pad, b_pad, index[key], v)


def _calls(kind: str, ix: np.ndarray) -> list[tuple]:
    """The scatter calls of one stamp of ``kind`` over the index rows
    ``ix``, in ops/stamps.py's order: (into b, rows, columns, sign,
    constant), element e of the value feeding the e-th row."""
    c = [ix[:, j] for j in range(ix.shape[1])] if ix.ndim == 2 else [ix]
    if kind == "adm":
        i1, i2 = c[0], c[1]
        return [(False, i1, i1, 1, False), (False, i2, i2, 1, False),
                (False, i1, i2, -1, False), (False, i2, i1, -1, False)]
    if kind == "cur":
        return [(True, c[0], None, -1, False), (True, c[1], None, 1, False)]
    if kind == "vsrc":
        i1, i2, j = c[0], c[1], c[2]
        return [(False, i1, j, 1, True), (False, j, i1, 1, True),
                (False, i2, j, -1, True), (False, j, i2, -1, True),
                (True, j, None, 1, False)]
    if kind == "tline":
        out = []
        for p, q, br in ((c[0], c[1], c[4]), (c[2], c[3], c[5])):
            out += [(False, p, br, 1, True), (False, q, br, -1, True),
                    (False, br, p, 1, True), (False, br, q, -1, True),
                    (False, br, br, -1, False)]
        return out
    if kind == "vec":
        return [(True, c[0], None, 1, False)]
    if kind == "mutual":
        n_l = ix.shape[0]
        r1, c1 = np.repeat(c[0], n_l), np.tile(c[0], n_l)
        r2, c2 = np.repeat(c[1], n_l), np.tile(c[1], n_l)
        return [(False, r1, c1, 1, False), (False, r1, c2, -1, False),
                (False, r2, c1, -1, False), (False, r2, c2, 1, False)]
    if kind == "vccs":
        i1, i2, icp, icn = c[0], c[1], c[2], c[3]
        return [(False, i1, icp, 1, False), (False, i1, icn, -1, False),
                (False, i2, icp, -1, False), (False, i2, icn, 1, False)]
    if kind == "vcvs":
        i1, i2, j, icp, icn = c[0], c[1], c[2], c[3], c[4]
        return [(False, i1, j, 1, True), (False, i2, j, -1, True),
                (False, j, i1, 1, True), (False, j, i2, -1, True),
                (False, j, icp, -1, False), (False, j, icn, 1, False)]
    if kind == "cccs":
        return [(False, c[0], c[2], 1, False), (False, c[1], c[2], -1, False)]
    if kind == "ccvs":
        i1, i2, j, jv = c[0], c[1], c[2], c[3]
        return [(False, i1, j, 1, True), (False, i2, j, -1, True),
                (False, j, i1, 1, True), (False, j, i2, -1, True),
                (False, j, jv, -1, False)]
    if kind == "pattern":
        return [(False, c[0], c[1], 1, False)]
    raise ValueError(f"unknown stamp kind {kind!r}")


@dataclass
class StampPlan:
    """K11's plan for a system of ``n`` unknowns. ``pages``: (slots,
    ptr, ent) each, host int32 arrays: ``slots`` the value slots the page
    reads (position s = code >> 1 less 1), ``ptr`` (n*n + n + 1,) the
    start of each entry's contributions (A's n*n row-major, then b's n),
    ``ent`` (K, 2) their (code, element), code = (slot + 1) << 1 | minus,
    slot + 1 = 0 for the constant 1. ``matrix``: the slots holding a
    (..., nL, nL) matrix (the coupled inductors' companion), read as their
    flattened last two axes. ``names``: every value slot the plan reads,
    in first-use order."""

    n: int
    pages: list
    matrix: frozenset
    names: tuple = ()
    _tables: dict = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        self.names = tuple(dict.fromkeys(s for slots, _p, _e in self.pages
                                         for s in slots))

    def tables(self, device: torch.device) -> list:
        """(ptr, ent) of every page on ``device``: one int32 buffer, built
        once per device and copied from pinned memory without a stream
        sync."""
        got = self._tables.get(device)
        if got is not None:
            return got
        parts, spans, at = [], [], 0
        for _s, p, e in self.pages:
            pad = np.zeros(len(p) % 2, np.int32)   # int2 loads: align ent
            parts += [p, pad, e.reshape(-1)]
            spans.append((at, at + len(p), at + len(p) + len(pad),
                          at + len(p) + len(pad) + e.size))
            at = spans[-1][-1]
        buf = torch.from_numpy(np.concatenate(parts).astype(np.int32))
        if device.type == "cuda":
            buf = buf.pin_memory().to(device, non_blocking=True)
        got = [(buf[a:b], buf[c:d]) for a, b, c, d in spans]
        self._tables[device] = got
        return got


def build_plan(layout: list, index: dict, n: int,
               max_slots: int = MAX_SLOTS) -> StampPlan:
    """K11's plan for ``layout`` over the host index arrays ``index`` (key
    -> integer array) of a system of ``n`` unknowns (index ``n`` is the
    ground dump slot). Stamps go into pages in order, a new page where a
    stamp would bring the page's value slots past ``max_slots``."""
    groups: list[tuple[list, list]] = [([], [])]
    for item in layout:
        items, slots = groups[-1]
        slot = item[2]
        if slot is not None and slot not in slots:
            if len(slots) == max_slots:
                groups.append(([], []))
                items, slots = groups[-1]
            slots.append(slot)
        items.append(item)
    nn = n * n
    pages = []
    for items, slots in groups:
        tgt, code, elem = [], [], []
        for kind, key, slot, sign in items:
            ix = np.asarray(index[key], np.int64)
            for on_b, rows, cols, csign, const in _calls(kind, ix):
                rows = np.asarray(rows, np.int64)
                if on_b:
                    t = np.where(rows < n, nn + rows, -1)
                else:
                    cols = np.asarray(cols, np.int64)
                    t = np.where((rows < n) & (cols < n), rows * n + cols, -1)
                s = 0 if (const or slot is None) else slots.index(slot) + 1
                minus = csign * (1 if const else sign) < 0
                tgt.append(t)
                code.append(np.full(len(t), (s << 1) | int(minus), np.int64))
                elem.append(np.arange(len(t), dtype=np.int64))
        none = [np.zeros(0, np.int64)]
        t, code_, elem_ = (np.concatenate(a or none)
                           for a in (tgt, code, elem))
        keep = t >= 0
        order = np.argsort(t[keep], kind="stable")
        ent = np.stack([code_[keep][order], elem_[keep][order]], axis=1)
        ptr_ = np.searchsorted(t[keep][order], np.arange(nn + n + 1))
        pages.append((tuple(slots), ptr_.astype(np.int32),
                      ent.astype(np.int32)))
    matrix = frozenset(s for kind, _k, s, _g in layout
                       if kind == "mutual" and s is not None)
    return StampPlan(n=n, pages=pages, matrix=matrix)


def form_for(n: int, dtype: torch.dtype) -> str:
    """K11's form at ``n`` unknowns: "tile" where ``TILE_LANES`` lanes'
    systems (row pitch (n*n + n) | 1) fit ``TILE_BYTES_MAX`` of shared
    memory (n <= 13 in f64, 18 in f32), "entry" beyond."""
    tile = TILE_LANES * ((n * n + n) | 1) * dtype.itemsize
    return "tile" if tile <= TILE_BYTES_MAX else "entry"


def lanes_for(n: int) -> int:
    """Lanes (whole systems) one block of K11's entry form writes: the
    most whose n*n + n entries stay within ``BLOCK_ENTRIES``, at least
    1."""
    return max(1, BLOCK_ENTRIES // (n * n + n))


# (slot pointers, lane strides, element strides, slots, ptr, ent, A, b,
#  nb, n, lanes, flags, form, stream)
_ARGS = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
         ctypes.POINTER(ctypes.c_longlong), ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIGNATURES = {"stamp_real_f32": (_ARGS, ctypes.c_int),
               "stamp_real_f64": (_ARGS, ctypes.c_int)}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load this kernel's library."""
    return load("stamp_real", _SIGNATURES)


def _slot(v: torch.Tensor | None, lead: tuple, nb: int,
          dtype: torch.dtype, matrix: bool) -> tuple:
    """(pointer, lane stride, element stride, the tensor read) of one
    value slot, read in place: a value shaped (nE,) or (1, nE) is shared
    by every lane (lane stride 0), one shaped (nb, nE) read at its own
    strides; a wider ``lead`` broadcasts first. None: a null slot. The
    strides are read straight off the tensor, a pass's launch being on the
    host's path between the card's kernels."""
    if v is None:
        return 0, 0, 0, None
    if v.dtype != dtype:
        v = v.to(dtype)
    if matrix:
        v = v.flatten(-2)
    if v.dim() == 0:
        v = v.reshape(1)
    if v.dim() > 2 or len(lead) > 1:
        v = v.expand(lead + v.shape[-1:]).reshape(nb, v.shape[-1])
    if v.numel() == 0:
        return 0, 0, 0, None
    stride = v.stride()
    lane = 0
    if v.dim() == 2:
        if v.shape[0] not in (1, nb):
            raise ValueError(f"K11: a value of {v.shape[0]} lanes in a "
                             f"system of {nb}")
        lane = stride[0] if v.shape[0] > 1 else 0
    return v.data_ptr(), lane, stride[-1], v


def stamp_real_cuda(plan: StampPlan, values: dict, lead: tuple,
                    dtype: torch.dtype, device: torch.device,
                    constants: bool = True, form: str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K11: A (*lead, n, n) and b (*lead, n), contiguous, from
    ``values`` (slot -> CUDA tensor broadcasting against ``lead`` + its
    element axis, or None: no contribution). ``constants=False`` drops the
    constant contributions (the JVP). ``form`` forces one of ``FORMS``
    (the comparisons); None takes ``form_for``'s."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("K11 takes float32 or float64 systems")
    if device.type != "cuda":
        raise ValueError("K11 takes CUDA tensors")
    n = plan.n
    form = form_for(n, dtype) if form is None else form
    if form not in FORMS or (form == "tile" and form_for(n, dtype) != form):
        raise ValueError(f"K11 has no form {form!r} at N={n}")
    nb = math.prod(lead)
    if nb >= 2**31:
        raise ValueError(f"K11 takes fewer than 2^31 systems, got {nb}")
    A = torch.empty(lead + (n, n), dtype=dtype, device=device)
    b = torch.empty(lead + (n,), dtype=dtype, device=device)
    if nb == 0 or n == 0:
        return A, b
    lib = load_library()
    fn = lib.stamp_real_f64 if dtype == torch.float64 else lib.stamp_real_f32
    with torch.cuda.device(device):
        tables = plan.tables(device)
        for p, ((slots, _p, _e), (ptr_t, ent_t)) in enumerate(
                zip(plan.pages, tables)):
            args = [_slot(values.get(s), lead, nb, dtype, s in plan.matrix)
                    for s in slots]
            k = len(args)
            flags = (_ACCUMULATE if p else 0) | (0 if constants else _NO_CONST)
            code = fn((ctypes.c_void_p * max(k, 1))(*[a[0] for a in args]),
                      (ctypes.c_longlong * max(k, 1))(*[a[1] for a in args]),
                      (ctypes.c_longlong * max(k, 1))(*[a[2] for a in args]),
                      k, ptr(ptr_t), ptr(ent_t), ptr(A), ptr(b), nb, n,
                      lanes_for(n), flags, FORMS.index(form),
                      stream_ptr(device))
            check(code, f"stamp_real {form} launch")
            K11[dtype].launches += 1
            K11_FORMS[dtype][form] += 1
    return A, b


def transpose(plan: StampPlan, gA: torch.Tensor | None,
              gb: torch.Tensor | None, lead: tuple, shapes: dict,
              dtype: torch.dtype, device: torch.device) -> dict:
    """The VJP of the assembly: slot -> the gradient of its value (shaped
    as ``shapes[slot]``), each entry the signed sum of dA and db over the
    plan's contributions that read it."""
    n, nb = plan.n, math.prod(lead)
    G = torch.cat([
        (torch.zeros(lead + (n, n), dtype=dtype, device=device)
         if gA is None else gA).reshape(nb, n * n),
        (torch.zeros(lead + (n,), dtype=dtype, device=device)
         if gb is None else gb).reshape(nb, n)], dim=1)
    grads: dict[str, torch.Tensor] = {}
    for slots, ptr_, ent in plan.pages:
        tgt = np.repeat(np.arange(len(ptr_) - 1), np.diff(ptr_))
        slot_of = (ent[:, 0] >> 1) - 1
        for s, name in enumerate(slots):
            sel = slot_of == s
            if not sel.any():
                continue
            shape = shapes[name]
            elem_shape = shape[-2:] if name in plan.matrix else shape[-1:]
            sign = torch.as_tensor(np.where(ent[sel, 0] & 1, -1.0, 1.0),
                                   dtype=dtype, device=device)
            g = torch.zeros((nb, math.prod(elem_shape)), dtype=dtype,
                            device=device).index_add_(
                1, torch.as_tensor(ent[sel, 1], device=device),
                G[:, torch.as_tensor(tgt[sel], device=device)] * sign)
            g = g.reshape(lead + tuple(elem_shape))
            grads[name] = g if name not in grads else grads[name] + g
    return {name: g.sum_to_size(shapes[name]) for name, g in grads.items()}


class _Assemble(torch.autograd.Function):
    """(A, b) through K11, linear in the values: JVP K11 on the tangents
    without the constants, VJP ``transpose``."""

    @staticmethod
    def forward(plan, lead, dtype, device, *vals):
        RULE_CALLS["forward"] += 1
        return stamp_real_cuda(plan, dict(zip(plan.names, vals)), lead,
                               dtype, device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, lead, dtype, device, *vals = inputs
        ctx.plan, ctx.lead, ctx.dtype, ctx.device = plan, lead, dtype, device
        ctx.shapes = {s: v.shape for s, v in zip(plan.names, vals)}

    @staticmethod
    def jvp(ctx, _plan, _lead, _dtype, _device, *tangents):
        RULE_CALLS["tangent"] += 1
        return stamp_real_cuda(ctx.plan, dict(zip(ctx.plan.names, tangents)),
                               ctx.lead, ctx.dtype, ctx.device,
                               constants=False)

    @staticmethod
    def backward(ctx, gA, gb):
        RULE_CALLS["adjoint"] += 1
        grads = transpose(ctx.plan, gA, gb, ctx.lead, ctx.shapes, ctx.dtype,
                          ctx.device)
        return (None, None, None, None) + tuple(
            grads.get(s) for s in ctx.plan.names)


def assemble(plan: StampPlan, values: dict, lead: tuple,
             dtype: torch.dtype, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """A pass's (A (*lead, n, n), b (*lead, n)) on the card: K11, through
    its derivative rules when a value carries a tangent or
    ``requires_grad``."""
    vals = [values[s] for s in plan.names]
    if _differentiated(*vals):
        return _Assemble.apply(plan, lead, dtype, device, *vals)
    return stamp_real_cuda(plan, values, lead, dtype, device)
