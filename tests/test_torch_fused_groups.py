"""K7's group widths and its row-ordered pattern table, on any host.

K7 (``csrc/mc_ac_fused.cu``) solves each (frequency, variant) system with
a group of ``fused_group_for(n)`` lanes, one row of [A | b] per lane in
registers, and each lane assembles its own row from the pattern's
row-ordered copy of the entry table (``PackedPattern.row_ent`` /
``row_ptr``). These tests hold that copy to the table K5 and the plain
versions read: an assembly from it in plain torch, the same sums in the
same order, builds planes bitwise equal to ``_plain_planes`` on the N = 16
ladder of ``simulate_ac_batch``'s batch-ac-16k cell, the linear part of
the two-stage amplifier (N = 11), a deck with every term kind (one, inv,
lin, w, winv: V/E/H couplings, resistors, gains and phasors, capacitors,
inductors) and a dense random pattern, in both RHS modes and both
dtypes. Nothing here needs a card.
"""

import numpy as np
import pytest
import torch

from spicey_tpu_torch import decks, parse_netlist
from spicey_tpu_torch.constants import EPS
from spicey_tpu_torch.ir.circuit import build_tensors
from spicey_tpu_torch.ops import mc_ac_fused as tfused
from tests.fused_systems import dense_pattern

# I/G/E/F/H sources, a V source and an inductor: every term kind
EVERY_KIND = """* every term kind
I1 0 a 1m ac 2 30
R1 a 0 1k
G1 0 b a 0 2m
R2 b 0 500
E1 c 0 b 0 3
R3 c d 100
C1 d 0 1u
V1 e 0 ac 1
R4 e d 200
F1 0 b V1 0.5
H1 f 0 V1 50
R5 f d 300
L1 d 0 10m
.ac dec 10 10 1e5
.end
"""


def _deck_pattern(net, dialect="spicey"):
    t = build_tensors(parse_netlist(net, dialect=dialect))
    pattern = tfused.build_stamp_pattern(
        t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx,
        {k: getattr(t, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                    "h_idx")})
    return pattern, t.nvar


PATTERNS = {
    "ladder-16": lambda: _deck_pattern(decks.rc_ladder_netlist(14, 201)),
    "amp": lambda: _deck_pattern(decks.AMP_DECK, "extended"),
    "every-kind": lambda: _deck_pattern(EVERY_KIND, "extended"),
    "dense-5": lambda: (dense_pattern(5), 5),
}
# w = 2 pi f: 0 opens every inductor (|w L| < EPS), the rest do not
FREQS = (0.0, 1.0, 1.0e3, 1.0e6)


@pytest.mark.parametrize("n", range(1, 17))
def test_group_is_the_smallest_that_holds_n_rows(n):
    g = tfused.fused_group_for(n)
    assert g in tfused.K7_GROUPS and n <= g and 32 % g == 0
    assert all(h < n for h in tfused.K7_GROUPS if h < g)


@pytest.mark.parametrize("n", [0, -1, 17, 64])
def test_group_refuses_n_out_of_range(n):
    with pytest.raises(ValueError, match="1 <= N <= 16"):
        tfused.fused_group_for(n)


def _row_planes(freqs, values, packed, eps):
    """The assembly K7's lanes do, in plain torch: row i of plane c is the
    entries row_ent[row_ptr[c, i]:row_ptr[c, i + 1]], each the sum of its
    terms in table order, zero elsewhere. (2, n, n+1, F, B) planes."""
    n = packed.n
    F, B = freqs.shape[0], values.shape[1]
    w = (2.0 * np.pi) * freqs.to(values.dtype)
    tv = tfused._term_values(packed, values, w, eps)
    planes = torch.zeros((2, n, n + 1, F, B), dtype=values.dtype)
    ptr = packed.row_ptr.tolist()
    ent = packed.row_ent.tolist()
    for c in range(2):
        for i in range(n):
            for col, t0, t1 in ent[ptr[c][i]:ptr[c][i + 1]]:
                acc = tv[t0]
                for t in range(t0 + 1, t1):
                    acc = acc + tv[t]
                planes[c, i, col] = acc
    return planes


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ext_rhs", [False, True])
@pytest.mark.parametrize("deck", sorted(PATTERNS))
def test_row_table_assembles_bitwise(deck, ext_rhs, dtype):
    pattern, n = PATTERNS[deck]()
    packed = tfused.pack_pattern(pattern, n, "cpu", ext_rhs=ext_rhs)
    rng = np.random.default_rng(7)
    values = torch.as_tensor(rng.uniform(0.5, 2.0, (packed.n_rows, 5)),
                             dtype=dtype)
    freqs = torch.as_tensor(FREQS, dtype=dtype)
    want = tfused._plain_planes(freqs, values, packed, EPS)
    got = _row_planes(freqs, values, packed, EPS)
    assert torch.equal(got, want)
    if ext_rhs:  # column n is left to the caller's planes
        assert not bool(want[:, :, n].any())
    if deck == "every-kind":
        assert set(packed.terms[:, 0].tolist()) == set(tfused.KINDS.values())


@pytest.mark.parametrize("ext_rhs", [False, True])
@pytest.mark.parametrize("deck", sorted(PATTERNS))
def test_row_table_layout(deck, ext_rhs):
    """row_ptr (2, n + 1) int32 runs over the entries once, plane 0 then
    plane 1; within a row the columns increase; every entry of ``ent``
    appears with its terms; with an external RHS no entry is in column
    n."""
    pattern, n = PATTERNS[deck]()
    packed = tfused.pack_pattern(pattern, n, "cpu", ext_rhs=ext_rhs)
    ptr, ent = packed.row_ptr, packed.row_ent
    assert ptr.dtype == ent.dtype == torch.int32
    assert ptr.shape == (2, n + 1) and ent.shape == packed.ent.shape
    assert int(ptr[0, 0]) == 0 and int(ptr[0, n]) == int(ptr[1, 0])
    assert int(ptr[1, n]) == ent.shape[0]
    assert bool((ptr[:, 1:] >= ptr[:, :-1]).all())
    w = n + 1
    rows = set()
    for c in range(2):
        for i in range(n):
            cols = ent[ptr[c, i]:ptr[c, i + 1], 0].tolist()
            assert cols == sorted(set(cols)) and all(0 <= j <= n
                                                     for j in cols)
            assert not (ext_rhs and n in cols)
            rows |= {(c * n * w + i * w + j, t0, t1) for j, t0, t1 in
                     ent[ptr[c, i]:ptr[c, i + 1]].tolist()}
    assert rows == {tuple(e) for e in packed.ent.tolist()}


def test_packed_pattern_moves_every_table():
    pattern, n = PATTERNS["every-kind"]()
    packed = tfused.pack_pattern(pattern, n, "cpu", ext_rhs=True)
    moved = packed.to("cpu")
    assert moved.ext_rhs and moved.n == n and moved.n_rows == packed.n_rows
    for name in ("ent", "terms", "zeros", "row_ent", "row_ptr"):
        assert torch.equal(getattr(moved, name), getattr(packed, name))
