"""K11, the assembly of a Newton pass (ops/stamp_real.py,
csrc/stamp_real.cu), against the index_add_ assembly of ops/stamps.py.

On any host: the plan of each deck, applied by a plain gather and signed
sum in the order it lists, equals ``tran._stamp_system``'s index_add_
assembly bit for bit (lead () and (B,), Newton passes 0 and 1, backward
Euler, trap and gear2 with their startup steps), split into pages too;
its transpose is the gradient of that assembly. Marked ``cuda``: the
kernel against the CPU path on the same values, bit for bit (the boost at
1, 4,096 and 1,000,000 lanes, the uA741 at N = 36, a paged plan), its
derivative rules, and one launch per Newton pass on the boost's
Monte-Carlo loop. Run those on the card with
``python -m pytest tests/test_torch_k11.py -m cuda --noconftest``.
"""

import functools
import math
import pathlib

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.analysis import tran as ttran
from spicey_tpu_torch.ir.circuit import (build_tensors, effective_time_step,
                                         ext_arrays, tl_arrays)
from spicey_tpu_torch.ops import stamp_real
from spicey_tpu_torch.utils import profiling
from tests.fixtures import netlists

F64 = torch.float64
CPU = torch.device("cpu")

# an I-kind B source reading two nodes
B_CURRENT = """* i-kind b source
v1 in 0 SIN(0 0.5 1k)
rb in 0 1k
bi 0 out I=1m*tanh(3*v(in))+0.1m*v(in)*v(out)
rl out 0 1k
.tran 10u 1m
.end
"""
# two resistors on one node pair: one scatter call adds twice to an entry
PARALLEL = """* parallel resistors and a diode
v1 1 0 dc 5
r1 1 2 1k
r2 1 2 2k
r3 2 1 3k
d1 2 0 dm
.model dm d
.tran 1u 10u
.end
"""
DECKS = {"boost": decks.BOOST_NET, "diode_switch": netlists.DIODE_SWITCH,
         "mosfet": decks.RING_NET, "bjt_charge": decks.QC_NET,
         "diode_charge": decks.TT_NET, "coupled": decks.TRANSFORMER_TRAN,
         "tline": decks.TLINE_TRAN, "bsource_v": decks.BSRC_TANH,
         "bsource_i": B_CURRENT, "efgh": decks.EXT_TRAN,
         "parallel": PARALLEL}
STEPS = [("be", False, False), ("be", True, False), ("trap", True, False),
         ("trap", False, False), ("gear2", True, False),
         ("gear2", False, True), ("gear2", False, False)]


@functools.lru_cache(maxsize=None)
def _deck(text):
    ckt = st.parse_netlist(text, dialect="extended")
    dt, _ = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    return ckt, build_tensors(ckt), dt


def _to(tree, dev):
    """``tree`` (dicts, lists, tuples of tensors) with every tensor moved
    to ``dev``; the plan and other leaves pass as they are."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def _case(text, B, seed=0):
    """A prepared ``arr`` of the deck (as ``_tran_core`` prepares it) on
    the CPU, values batched over B lanes (B None: lead ()), and a random
    state: (arr, lead, nvar, dt, carry, x, sw, vs_t, e_t, vt_scale)."""
    ckt, t, dt = _deck(text)
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)

    def val(a):
        a = np.asarray(a, np.float64)
        if B is not None:
            a = a * rng.uniform(0.9, 1.1, (B,) + a.shape)
        return torch.as_tensor(a, dtype=F64)

    ext = ext_arrays(t, CPU, F64)
    for k in ("g_gm", "e_gain", "f_gain", "h_r"):
        ext[k] = val(ext[k].numpy())
    tl = tl_arrays(t, CPU, F64)
    if tl is not None:
        tl["z0"] = val(tl["z0"].numpy())
    arr = ttran.tran_arrays(t, CPU, F64, r_vals=val(t.r_vals),
                            c_vals=val(t.c_vals), l_vals=val(t.l_vals),
                            ext=ext, tl=tl, ckt=ckt, dt=dt)
    arr = dict(arr, bsrc_t=ttran.prepare_bsources(arr["bsrc"], CPU))
    if arr["lk"] is not None:
        arr["minv"] = ttran._mutual_inv(arr["l_vals"], arr["lk"])[0]
    n = {"c": t.n_c, "l": t.n_l, "s": t.n_s, "d": t.n_d, "m": t.n_m,
         "q": t.n_q}
    carry = ttran._init_carry(lead, n, F64, CPU, arr["dchg"] is not None,
                              arr["qchg"] is not None)
    carry = [torch.as_tensor(rng.random(c.shape) < 0.5)
             if c.dtype == torch.bool
             else torch.as_tensor(rng.uniform(-0.9, 0.9, c.shape), dtype=F64)
             for c in carry]
    x = torch.as_tensor(rng.uniform(-2, 2, lead + (t.nvar,)), dtype=F64)
    n_src = t.n_v + t.n_i
    vs_t = torch.as_tensor(rng.uniform(-5, 5, lead + (n_src,)), dtype=F64)
    e_t = (None if tl is None else
           torch.as_tensor(rng.uniform(-1, 1, lead + (t.n_t, 2)), dtype=F64))
    vt_scale = ttran.vt_scale_of(t, CPU, F64)
    return arr, lead, t.nvar, dt, carry, x, carry[7], vs_t, e_t, vt_scale


def _flat(plan, name, v, lead, dtype):
    """A value slot as (lanes, elements), as the kernel reads it."""
    v = v.to(dtype)
    if name in plan.matrix:
        v = v.reshape(v.shape[:-2] + (-1,))
    return v.expand(lead + v.shape[-1:]).reshape(math.prod(lead), -1)


def _apply_plan(plan, vals, lead, dtype=F64):
    """The plan by a plain gather and signed sum, each entry's
    contributions added in the plan's order (later pages onto the
    earlier pages' sums)."""
    n, nb = plan.n, math.prod(lead)
    out = torch.zeros((nb, n * n + n), dtype=dtype)
    for p, (slots, ptr, ent) in enumerate(plan.pages):
        cols = [_flat(plan, s, vals[s], lead, dtype) for s in slots]
        for t in range(n * n + n):
            acc = out[:, t].clone() if p else torch.zeros(nb, dtype=dtype)
            for code, e in ent[ptr[t]:ptr[t + 1]]:
                s = (int(code) >> 1) - 1
                v = torch.ones(nb, dtype=dtype) if s < 0 else cols[s][:, e]
                acc = acc + (-v if code & 1 else v)
            out[:, t] = acc
    return (out[:, :n * n].reshape(lead + (n, n)),
            out[:, n * n:].reshape(lead + (n,)))


def _bits(t):
    return t.contiguous().view(torch.int64)


def _pass(case, it, integration="be", first=False, second=False):
    arr, lead, nvar, dt, carry, x, sw, vs_t, e_t, vt_scale = case
    args = (arr, nvar, dt, vs_t, x, it, carry, sw, integration, first,
            second, vt_scale)
    return args, dict(e_t=e_t, t=0.5 * dt)


@pytest.mark.parametrize("integration,first,second", STEPS)
@pytest.mark.parametrize("it", [0, 1])
@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_plan_equals_index_add_assembly(deck, B, it, integration, first,
                                        second):
    case = _case(DECKS[deck], B)
    args, kw = _pass(case, it, integration, first, second)
    A, b = ttran._stamp_system(*args, **kw)
    vals = ttran._pass_values(*args, kw["e_t"], kw["t"])
    plan = ttran.stamp_plan(case[0], case[2])
    assert len(plan.pages) == 1
    A2, b2 = _apply_plan(plan, vals, case[1])
    assert torch.equal(_bits(A), _bits(A2))
    assert torch.equal(_bits(b), _bits(b2))


@pytest.mark.parametrize("deck", ["bjt_charge", "bsource_i", "coupled",
                                  "efgh", "tline"])
def test_paged_plan_equals_index_add_assembly(deck):
    """Two value slots a page: the later pages add onto the earlier
    pages' sums, in the order of the one-page plan."""
    case = _case(DECKS[deck], 2, seed=1)
    arr, nvar = case[0], case[2]
    args, kw = _pass(case, 1)
    A, b = ttran._stamp_system(*args, **kw)
    vals = ttran._pass_values(*args, kw["e_t"], kw["t"])
    bsets = ttran._bsource_sets(arr["bsrc"])
    plan = stamp_real.build_plan(
        ttran._stamp_layout(arr),
        ttran._stamp_index(arr["index_host"], bsets), nvar, max_slots=2)
    assert len(plan.pages) > 2
    assert all(len(slots) <= 2 for slots, _p, _e in plan.pages)
    A2, b2 = _apply_plan(plan, vals, case[1])
    assert torch.equal(_bits(A), _bits(A2))
    assert torch.equal(_bits(b), _bits(b2))


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_plan_tables(deck):
    """Every entry's contributions are a run of the table, no target is
    the ground row or column, and each slot's elements lie inside its
    value."""
    case = _case(DECKS[deck], 2)
    args, kw = _pass(case, 1)
    vals = ttran._pass_values(*args, kw["e_t"], kw["t"])
    plan = ttran.stamp_plan(case[0], case[2])
    n = plan.n
    for slots, ptr, ent in plan.pages:
        assert ptr.dtype == ent.dtype == np.int32
        assert ptr.shape == (n * n + n + 1,) and ptr[0] == 0
        assert np.all(np.diff(ptr) >= 0) and ptr[-1] == len(ent)
        for code, e in ent:
            s = (int(code) >> 1) - 1
            if s >= 0:
                width = _flat(plan, slots[s], vals[slots[s]], case[1],
                              F64).shape[1]
                assert 0 <= e < width
    assert set(plan.names) <= set(vals)


@pytest.mark.parametrize("B", [None, 1, 3])
@pytest.mark.parametrize("deck", sorted(DECKS))
def test_slot_reads_what_the_plan_reads(deck, B):
    """The pointer and strides K11 reads each value through address the
    value broadcast over the lanes, element for element."""
    case = _case(DECKS[deck], B)
    args, kw = _pass(case, 1)
    vals = ttran._pass_values(*args, kw["e_t"], kw["t"])
    plan = ttran.stamp_plan(case[0], case[2])
    lead = case[1]
    nb = math.prod(lead)
    for name in plan.names:
        want = _flat(plan, name, vals[name], lead, F64)
        ptr, lane, elem, t = stamp_real._slot(vals[name], lead, nb, F64,
                                              name in plan.matrix)
        if t is None:
            assert want.numel() == 0 and ptr == 0
            continue
        assert ptr == t.data_ptr()
        got = torch.as_strided(t, want.shape, (lane, elem),
                               t.storage_offset())
        assert torch.equal(got, want)


def test_plan_transpose_is_the_assembly_gradient():
    """``transpose`` (K11's VJP) against reverse mode through the
    index_add_ assembly, on the K-coupled, T-line and B-source decks."""
    for deck in ("coupled", "tline", "bsource_v", "bjt_charge"):
        case = _case(DECKS[deck], 3, seed=2)
        arr, lead, nvar = case[0], case[1], case[2]
        args, kw = _pass(case, 1)
        vals = {k: v.detach().clone().requires_grad_(True)
                for k, v in ttran._pass_values(*args, kw["e_t"],
                                               kw["t"]).items()}
        plan = ttran.stamp_plan(arr, nvar)
        stamps = ttran._stamp_setup(arr, nvar)
        A, b = ttran._zeros(lead, nvar + 1, F64, CPU)
        ttran.apply_stamps(A, b, stamps.layout, stamps.index, vals)
        rng = np.random.default_rng(3)
        gA = torch.as_tensor(rng.standard_normal(lead + (nvar, nvar)))
        gb = torch.as_tensor(rng.standard_normal(lead + (nvar,)))
        names = [s for s in plan.names if vals[s].numel()]
        want = torch.autograd.grad(
            (A[..., :nvar, :nvar] * gA).sum() + (b[..., :nvar] * gb).sum(),
            [vals[s] for s in names], allow_unused=True)
        got = stamp_real.transpose(plan, gA, gb, lead,
                                   {s: v.shape for s, v in vals.items()},
                                   F64, CPU)
        for s, w in zip(names, want):
            if w is None:
                assert s not in got or not got[s].any()
            else:
                torch.testing.assert_close(got[s], w, rtol=1e-12,
                                           atol=1e-12)


def test_layout_covers_every_kind_and_the_constants_match():
    """Every kind of ops/stamp_real.py is used by some deck's layout, and
    the kernel's slot cap is the wrapper's."""
    kinds = set()
    for text in DECKS.values():
        kinds |= {k for k, *_ in ttran._stamp_layout(_case(text, None)[0])}
    assert kinds == set(stamp_real._APPLY)
    src = (pathlib.Path(stamp_real.__file__).parent.parent / "csrc"
           / "stamp_real.cu").read_text()
    assert f"constexpr int MAX_SLOTS = {stamp_real.MAX_SLOTS};" in src
    assert f"constexpr int TILE_LANES = {stamp_real.TILE_LANES};" in src
    assert ("constexpr int TILE_BYTES_MAX = "
            f"{stamp_real.TILE_BYTES_MAX // 1024} * 1024;") in src
    assert stamp_real.lanes_for(6) == 48 and stamp_real.lanes_for(64) == 1
    form = stamp_real.form_for
    assert [form(n, F64) for n in (1, 6, 13, 14, 36)] == \
        ["tile"] * 3 + ["entry"] * 2
    assert [form(n, torch.float32) for n in (18, 19)] == ["tile", "entry"]


def test_k11_refuses_before_building():
    plan = ttran.stamp_plan(_case(decks.BOOST_NET, None)[0], 6)
    with pytest.raises(TypeError, match="float32 or float64"):
        stamp_real.stamp_real_cuda(plan, {}, (1,), torch.int32,
                                   torch.device("cuda"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        stamp_real.stamp_real_cuda(plan, {}, (1,), F64, CPU)
    with pytest.raises(ValueError, match="no form 'panel'"):
        stamp_real.stamp_real_cuda(plan, {}, (1,), F64,
                                   torch.device("cuda"), form="panel")


# ---- on the card -------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _card_vs_cpu(case, cuda, it=0, plan=None, form=None):
    """K11 (in ``form``, None: its own) on the values computed on the
    card, and the index_add_ path on the CPU on the same values: (K11's A,
    b), (the CPU path's A, b)."""
    arr, lead, nvar = case[0], case[1], case[2]
    args, kw = _pass(case, it)
    vals = ttran._pass_values(*_to(list(args), cuda), _to(kw["e_t"], cuda),
                              kw["t"])
    plan = ttran.stamp_plan(arr, nvar) if plan is None else plan
    got = stamp_real.stamp_real_cuda(plan, vals, lead, F64, cuda, form=form)
    stamps = ttran._stamp_setup(arr, nvar)
    A, b = ttran._zeros(lead, nvar + 1, F64, CPU)
    ttran.apply_stamps(A, b, stamps.layout, stamps.index,
                       {k: v.cpu() for k, v in vals.items()})
    return got, (A[..., :nvar, :nvar], b[..., :nvar])


@pytest.mark.cuda
@pytest.mark.parametrize("form", stamp_real.FORMS)
@pytest.mark.parametrize("B", [None, 4096, 1_000_000])
def test_k11_boost_bit_equal_to_cpu_path(cuda, B, form):
    case = _case(decks.BOOST_NET, B, seed=4)
    before = dict(stamp_real.K11_FORMS[F64])
    (A, b), (rA, rb) = _card_vs_cpu(case, cuda, form=form)
    assert stamp_real.K11_FORMS[F64][form] == before[form] + 1
    assert A.is_contiguous() and b.is_contiguous()
    assert torch.equal(_bits(A.cpu()), _bits(rA))
    assert torch.equal(_bits(b.cpu()), _bits(rb))


@pytest.mark.cuda
@pytest.mark.parametrize("form", stamp_real.FORMS)
@pytest.mark.parametrize("deck,max_slots", [("ua741", None),
                                            ("bjt_charge", 2),
                                            ("bsource_i", 2)])
def test_k11_wide_and_paged_bit_equal_to_cpu_path(cuda, deck, max_slots,
                                                   form):
    """The uA741 (N = 36, the entry form; one launch) and plans paged two
    slots a page (one launch a page, in both forms): the same sums in the
    same order, so the same bits (tolerance 0)."""
    if deck == "ua741" and form == "tile":
        pytest.skip("N = 36 has no tile form")
    text = decks.UA741_AMP if deck == "ua741" else DECKS[deck]
    case = _case(text, 64, seed=5)
    plan = None
    if max_slots is not None:
        bsets = ttran._bsource_sets(case[0]["bsrc"])
        plan = stamp_real.build_plan(
            ttran._stamp_layout(case[0]),
            ttran._stamp_index(case[0]["index_host"], bsets), case[2],
            max_slots=max_slots)
    before = stamp_real.K11[F64].launches
    (A, b), (rA, rb) = _card_vs_cpu(case, cuda, it=1, plan=plan, form=form)
    pages = 1 if plan is None else len(plan.pages)
    assert stamp_real.K11[F64].launches == before + pages
    assert torch.equal(_bits(A.cpu()), _bits(rA))
    assert torch.equal(_bits(b.cpu()), _bits(rb))


@pytest.mark.cuda
def test_k11_rules_match_cpu(cuda):
    """JVP (K11 on the tangents, constants dropped) and VJP (the plan's
    transpose) against forward and reverse mode through the index_add_
    path on the CPU."""
    case = _case(decks.QC_NET, 8, seed=6)
    arr, lead, nvar = case[0], case[1], case[2]
    args, kw = _pass(case, 1)
    vals = ttran._pass_values(*args, kw["e_t"], kw["t"])
    plan = ttran.stamp_plan(arr, nvar)
    stamps = ttran._stamp_setup(arr, nvar)
    rng = np.random.default_rng(7)
    tans = {k: torch.as_tensor(rng.standard_normal(v.shape), dtype=F64)
            for k, v in vals.items()}

    def cpu_path(vs):
        A, b = ttran._zeros(lead, nvar + 1, F64, CPU)
        ttran.apply_stamps(A, b, stamps.layout, stamps.index, vs)
        return A[..., :nvar, :nvar], b[..., :nvar]

    before = dict(stamp_real.RULE_CALLS)
    with fwAD.dual_level():
        got = stamp_real.assemble(
            plan, {k: fwAD.make_dual(v.to(cuda), tans[k].to(cuda))
                   for k, v in vals.items()}, lead, F64, cuda)
        got_t = [fwAD.unpack_dual(g).tangent.cpu() for g in got]
    with fwAD.dual_level():
        want = cpu_path({k: fwAD.make_dual(v, tans[k])
                         for k, v in vals.items()})
        want_t = [fwAD.unpack_dual(w).tangent for w in want]
    for g, w in zip(got_t, want_t):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    leaves = {k: v.to(cuda).requires_grad_(True) for k, v in vals.items()}
    A, b = stamp_real.assemble(plan, leaves, lead, F64, cuda)
    gA = torch.as_tensor(rng.standard_normal(A.shape), dtype=F64)
    gb = torch.as_tensor(rng.standard_normal(b.shape), dtype=F64)
    names = [k for k in plan.names if vals[k].numel()]
    got_g = torch.autograd.grad((A * gA.to(cuda)).sum()
                                + (b * gb.to(cuda)).sum(),
                                [leaves[k] for k in names],
                                allow_unused=True)
    cpu_leaves = {k: v.clone().requires_grad_(True) for k, v in vals.items()}
    rA, rb = cpu_path(cpu_leaves)
    want_g = torch.autograd.grad((rA * gA).sum() + (rb * gb).sum(),
                                 [cpu_leaves[k] for k in names],
                                 allow_unused=True)
    for g, w in zip(got_g, want_g):
        if w is None:
            assert g is None or not g.any()
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-12, atol=1e-12)
    assert stamp_real.RULE_CALLS["tangent"] == before["tangent"] + 1
    assert stamp_real.RULE_CALLS["adjoint"] == before["adjoint"] + 1


@pytest.mark.cuda
def test_k11_sensitivity_tran_through_rules_matches_cpu(cuda):
    """``sensitivity_tran`` runs the time loop on dual tensors: on the card
    every pass's assembly is K11's forward launch plus its JVP launch."""
    boost = decks.BOOST_NET.replace(".tran 0.001 0.1 uic",
                                    ".tran 0.001 0.01 uic")
    before = dict(stamp_real.RULE_CALLS)
    got = st.sensitivity_tran(st.parse_netlist(boost), "N3", ["LL1", "RR1"],
                              device=cuda)
    assert stamp_real.RULE_CALLS["tangent"] > before["tangent"]
    assert (stamp_real.RULE_CALLS["tangent"] - before["tangent"]
            == stamp_real.RULE_CALLS["forward"] - before["forward"])
    want = st.sensitivity_tran(st.parse_netlist(boost), "N3", ["LL1", "RR1"],
                               device="cpu")
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max())


@pytest.mark.cuda
def test_k11_once_per_newton_pass_on_the_mc_loop(cuda):
    ckt = st.parse_netlist(decks.BOOST_NET)
    rng = np.random.default_rng(8)
    over = {k: v * rng.uniform(0.9, 1.1, 4096)
            for k, v in (("RR1", 1e3), ("CC1", 1e-5), ("LL1", 1.0))}
    before = stamp_real.K11[F64].launches
    with profiling.profiled():
        st.mc_tran_stats(ckt, over, "N3", method="gj", precision="f64",
                         device=cuda)
        passes = profiling.counters()["tran.newton_passes"]
    assert passes >= 101
    assert stamp_real.K11[F64].launches - before == passes
