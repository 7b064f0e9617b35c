"""K5's forms and what its group form computes, on any host.

K5 (``csrc/mc_ac_fused.cu``) runs each (frequency, variant) system in one
of two forms, chosen by ``k5_form_for`` from N and the dtype: "register"
(one thread per system, the system in registers, N a template constant up
to ``REG_MAX_N``) and "group" (K7's body, a group of ``fused_group_for(N)``
lanes per system, writing |x[node]| and ``valid`` in place of the whole
solution). The register form assembles each system from the pattern's
flat term table (``PackedPattern.flat``). These tests hold the chooser to
the kernel's instances at every N the fused tier takes, the flat table to
the entry table (a walk of it in plain torch builds planes bitwise equal
to ``_plain_planes``), and K5's function to K7's on the plain versions:
|x[node]| of ``mc_ac_fused_x_plain`` equals ``mc_ac_fused_plain``'s
``mag`` bit for bit, with identical ``valid``, on the yield's RC deck, an
extended deck with every term kind (N = 7, past the register form) and a
dense random pattern, in both dtypes. Nothing here needs a card.
"""

import numpy as np
import pytest
import torch

from spicey_tpu_torch import parse_netlist
from spicey_tpu_torch.constants import EPS
from spicey_tpu_torch.ir.circuit import build_tensors
from spicey_tpu_torch.ops import mc_ac_fused as tfused
from tests.fused_systems import FREQS, dense_pattern, dense_values

RC_NET = ("* yield rc\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 5 1 100\n.end\n")
# I/G/E/F/H sources, a V source and an inductor: every term kind, N = 7
EXT_NET = """* extended fused-tier deck
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
.ac dec 2 10 1e5
.end
"""


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_form_chooser_covers_every_n(dtype):
    """Every N of the fused tier (1-16) has a form with an instance: the
    register form up to K5_REG_MAX_N (within the register instances), the
    group form past it, in a group that holds N rows; one crossover."""
    forms = [tfused.k5_form_for(n, dtype) for n in range(1, 17)]
    for n, (form, width) in zip(range(1, 17), forms):
        assert form in tfused.FORMS
        if form == "register":
            assert width == n <= tfused.REG_MAX_N
        else:
            assert width == tfused.fused_group_for(n) >= n
            assert width in tfused.K7_GROUPS
    names = [f for f, _ in forms]
    cross = tfused.K5_REG_MAX_N[dtype]
    assert names == ["register"] * cross + ["group"] * (16 - cross)
    assert 1 <= cross <= tfused.REG_MAX_N


@pytest.mark.parametrize("n", [0, 17])
def test_form_chooser_refuses_n_out_of_range(n):
    with pytest.raises(ValueError, match="1 <= N <= 16"):
        tfused.k5_form_for(n, torch.float64)


def _deck_inputs(net, node, dtype, B=6, seed=3):
    ckt = parse_netlist(net, dialect="extended")
    t = build_tensors(ckt)
    pattern = tfused.build_stamp_pattern(
        t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx,
        {k: getattr(t, k) for k in ("i_idx", "g_idx", "e_idx", "f_idx",
                                    "h_idx")})
    packed = tfused.pack_pattern(pattern, t.nvar, "cpu")
    rng = np.random.default_rng(seed)
    values = torch.as_tensor(rng.uniform(0.5, 2.0, (packed.n_rows, B)),
                             dtype=dtype)
    freqs = torch.as_tensor([0.0, 1.0, 1.0e3, 1.0e6], dtype=dtype)
    idx = [nm.upper() for nm in t.node_names].index(node.upper())
    return freqs, values, packed, idx


def _dense_inputs(n, dtype):
    vals = dense_values(n, 8, seed=n)
    vals[2 + 2 * (n - 1), 2] = np.nan  # entry (0, n - 1) of variant 2
    return (torch.as_tensor(FREQS, dtype=dtype),
            torch.as_tensor(vals, dtype=dtype),
            tfused.pack_pattern(dense_pattern(n), n, "cpu"), n // 2)


INPUTS = {
    "rc": lambda dtype: _deck_inputs(RC_NET, "2", dtype),
    "every-kind": lambda dtype: _deck_inputs(EXT_NET, "d", dtype),
    "dense-5": lambda dtype: _dense_inputs(5, dtype),
    "dense-11": lambda dtype: _dense_inputs(11, dtype),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("deck", sorted(INPUTS))
def test_group_epilogue_is_k5s_function(deck, dtype):
    """The group form's epilogue, |x[node]| of the full solution, is K5's
    function: bitwise the plain K5's ``mag`` and the same ``valid``."""
    freqs, values, packed, node = INPUTS[deck](dtype)
    mag, valid = tfused.mc_ac_fused_plain(freqs, values, packed, node, EPS)
    xr, xi, xvalid = tfused.mc_ac_fused_x_plain(freqs, values, packed,
                                                eps=EPS)
    r, i = xr[:, node, :], xi[:, node, :]          # (F, B)
    assert torch.equal(xvalid.T, valid)
    torch.testing.assert_close(torch.sqrt(r * r + i * i).T, mag, rtol=0,
                               atol=0, equal_nan=True)
    if deck.startswith("dense"):  # the zero, zero-row and NaN variants
        assert not valid[:3].any() and valid[3:].all()
    else:
        assert valid.all()


def _flat_planes(freqs, values, packed, eps):
    """The register form's assembly in plain torch: zero planes, then the
    flat table's terms in order, the first of an entry opening its sum
    and the last storing it at the entry's position."""
    n = packed.n
    w = (2.0 * np.pi) * freqs.to(values.dtype)
    tv = tfused._term_values(packed, values, w, eps)   # (n_terms, F, B)
    planes = torch.zeros((2 * n * (n + 1),) + tv.shape[1:],
                         dtype=values.dtype)
    acc = None
    for q, (pos, flags, _row, _sign) in enumerate(packed.flat.tolist()):
        acc = tv[q] if flags & 8 else acc + tv[q]
        if flags & 16:
            planes[pos] = acc
    return planes.reshape(2, n, n + 1, *tv.shape[1:])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("deck", sorted(INPUTS))
def test_flat_table_assembles_bitwise(deck, dtype):
    freqs, values, packed, _node = INPUTS[deck](dtype)
    flat = packed.flat
    assert flat.dtype == torch.int32 and flat.shape == (
        packed.terms.shape[0], 4)
    # each term keeps its kind, row and sign, in the term table's order
    assert torch.equal(flat[:, 1] & 7, packed.terms[:, 0])
    assert torch.equal(flat[:, 2:], packed.terms[:, 1:])
    want = tfused._plain_planes(freqs, values, packed, EPS)
    torch.testing.assert_close(_flat_planes(freqs, values, packed, EPS),
                               want, rtol=0, atol=0, equal_nan=True)
