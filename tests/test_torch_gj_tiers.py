"""The tiers of K1 and K2 (warp, block, panel; K2's thread tier too).

On any host: the tier choice, a pure function of N, the dtype and real or
complex, at its boundaries, monotone in N, with K3 (the real inverse,
``tests/test_torch_k3_tiers.py``) and K4 (the complex inverse) on their
routes; and the wrappers
refuse a tier that cannot take N before they touch the device.

On the card (marked ``cuda``, skipped elsewhere; run with
``python -m pytest tests/test_torch_gj_tiers.py -m cuda --noconftest``):
every tier of K1, K2 and K4, forced, against the plain version on random
systems with an all-zero lane, a NaN lane and a zero-column lane, as
``chip_smoke.py`` phase 2 holds them: ``valid`` identical on every lane; f64 within
1e-12 x max|x|; in f32, the tier's error against an f64 solve of the same
planes at most twice the plain f32 version's, plus 1e-5 x max|x| (nvcc
contracts multiply-adds into FMAs and the panel tier sums in another
order, so two f32 eliminations differ in their last bits).
"""

import numpy as np
import pytest
import torch

from spicey_tpu_torch.ops import gj, gj_real, linsolve

DTYPES = (torch.float32, torch.float64)
ORDER = ("thread", "warp", "block", "panel")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the largest N whose [panel | C] fits in one block's shared memory in the
# panel tier, per (complex, dtype) (gj_panel.cuh:smem_bytes); past it the
# panel tier keeps [panel | C] in its workspace (PANEL_GLOBAL)
PANEL_SMEM_EDGE = {(True, torch.float64): 401, (True, torch.float32): 822,
                   (False, torch.float64): 822, (False, torch.float32): 1629}
PAST_EDGE = [(c, dt, n) for (c, dt), e in PANEL_SMEM_EDGE.items()
             for n in (e, e + 1)] + [(True, torch.float64, 512),
                                     (False, torch.float64, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# ---- the tier choice, on any host -------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_tier_boundaries(dtype):
    wmax, pmin = gj.K1_WARP_MAX, gj.K1_PANEL_MIN
    assert 1 <= wmax <= gj.WARP_MAX_N < pmin
    assert gj.tier_for(1, dtype) == "warp"
    assert gj.tier_for(wmax, dtype) == "warp"
    assert gj.tier_for(wmax + 1, dtype) in ("block", "panel")
    assert gj.tier_for(pmin - 1, dtype) in ("warp", "block")
    assert gj.tier_for(pmin, dtype) == "panel"
    # past the N where [panel | C] fits in shared memory the panel tier
    # keeps it in its workspace: no N goes to another tier for want of room
    edge = PANEL_SMEM_EDGE[(True, dtype)]
    for n in (edge, edge + 1, 4096):
        assert gj.tier_for(n, dtype) == "panel"


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_tier_boundaries(dtype):
    tmax, wmax = gj_real.K2_THREAD_MAX[dtype], gj_real.K2_WARP_MAX
    pmin = gj_real.K2_PANEL_MIN
    assert 0 <= tmax <= gj_real.THREAD_MAX_N
    assert tmax <= wmax <= gj.WARP_MAX_N < pmin
    if tmax:
        assert gj_real.tier_for(1, dtype) == "thread"
        assert gj_real.tier_for(tmax, dtype) == "thread"
    assert gj_real.tier_for(tmax + 1, dtype) in ("warp", "block", "panel")
    assert gj_real.tier_for(wmax + 1, dtype) in ("block", "panel")
    assert gj_real.tier_for(pmin, dtype) == "panel"
    edge = PANEL_SMEM_EDGE[(False, dtype)]
    for n in (edge, edge + 1, 4096):
        assert gj_real.tier_for(n, dtype) == "panel"


@pytest.mark.parametrize("module", [gj, gj_real], ids=["K1", "K2"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tier_monotone_in_n(module, dtype):
    ranks = [ORDER.index(module.tier_for(n, dtype)) for n in range(1, 600)]
    assert ranks == sorted(ranks)
    assert set(module.tier_for(n, dtype) for n in range(1, 600)) \
        <= set(module.TIERS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_tier_only_where_a_warp_holds_the_rows(dtype):
    for module in (gj, gj_real):
        for n in range(1, 300):
            tier = module.tier_for(n, dtype)
            assert tier != "warp" or n <= gj.WARP_MAX_N
            assert tier != "thread" or n <= gj_real.THREAD_MAX_N


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 16, 17, 32, 33, 64, 128, 129, 256])
def test_inverses_keep_their_route(n, dtype):
    # K4: K1's tiers, warp up to N = 32 and panel from 33; K3: its register
    # form up to N = 8, then warp up to N = 32 and panel from 33, never block
    assert gj.tier_for(n, dtype, inverse=True) == (
        "warp" if n <= gj.K4_WARP_MAX else "panel")
    want = ("register" if n <= gj_real.K3_REG_INSTANCES
            else "warp" if n <= gj_real.K3_WARP_MAX else "panel")
    assert gj_real.tier_for(n, dtype, inverse=True) == want


def test_tier_counters_cover_every_tier():
    for dtype in DTYPES:
        # the solve's tiers, and the multi entry's warp kernel ("multi";
        # its panel launches count as "panel")
        assert set(gj.K1_TIERS[dtype]) == set(gj.TIERS) | {"multi"} \
            == {"warp", "block", "panel", "multi"}
        assert set(gj_real.K2_TIERS[dtype]) == set(gj_real.TIERS) \
            | {"multi"} == {"thread", "warp", "block", "panel", "multi"}
        assert gj.MULTI_TIERS == gj_real.MULTI_TIERS == ("multi", "panel")


def test_wrappers_refuse_a_tier_that_cannot_take_n():
    A = torch.zeros((2, 33, 33), dtype=torch.float64)
    b = torch.zeros((2, 33), dtype=torch.float64)
    with pytest.raises(ValueError, match="no tier 'warp' at N=33"):
        gj.gj_solve_planes_cuda(A, A, b, b, tier="warp")
    with pytest.raises(ValueError, match="no tier 'thread' at N=33"):
        gj_real.gj_solve_cuda(A, b, tier="thread")
    with pytest.raises(ValueError, match="no tier 'lu'"):
        gj.gj_solve_planes_cuda(A, A, b, b, tier="lu")
    # a tier that can take N gets as far as the device check
    with pytest.raises(ValueError, match="CUDA"):
        gj.gj_solve_planes_cuda(A, A, b, b, tier="panel")
    with pytest.raises(ValueError, match="CUDA"):
        gj_real.gj_solve_cuda(A, b, tier="block")


# ---- every tier against the plain version, on the card ---------------------

def _lanes(n, B, seed):
    """Random systems with an all-zero lane (0), a NaN lane (1) and a
    zero-column lane (2): (Ar, Ai, br, bi) as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
    Ai = rng.standard_normal((B, n, n))
    br, bi = rng.standard_normal((2, B, n))
    Ar[0] = Ai[0] = 0.0
    Ar[1, n // 2, n - 1] = np.nan
    Ar[2, :, n // 3] = Ai[2, :, n // 3] = 0.0
    return Ar, Ai, br, bi


def _hold(got, plain, truth, ok, dtype, what):
    """got / plain / truth: tuples of planes of x; ok: the valid lanes."""
    scale = max(float(t[ok].abs().max()) for t in truth)
    e_got = max(float((g.double() - t)[ok].abs().max())
                for g, t in zip(got, truth))
    if dtype == torch.float64:
        assert e_got <= TOL[dtype] * scale, f"{what}: {e_got:.3e}"
    else:
        e_plain = max(float((p.double() - t)[ok].abs().max())
                      for p, t in zip(plain, truth))
        assert e_got <= 2 * e_plain + TOL[dtype] * scale, (
            f"{what}: error vs f64 {e_got:.3e}, plain's {e_plain:.3e}")


K1_CASES = [(t, n) for t in gj.TIERS
            for n in (3, 8, 16, 17, 31, 32, 33, 47, 48, 64, 128, 129, 256)
            if not (t == "warp" and n > gj.WARP_MAX_N)]
K2_CASES = [(t, n) for t in gj_real.TIERS
            for n in (3, 8, 16, 17, 31, 32, 33, 47, 48, 64, 128, 129, 256)
            if not (t == "warp" and n > gj.WARP_MAX_N)
            and not (t == "thread" and n > gj_real.THREAD_MAX_N)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tier,n", K1_CASES)
def test_k1_tier_matches_plain(cuda, tier, n, dtype):
    planes64 = [torch.as_tensor(a) for a in _lanes(n, 24, n)]
    cpu = [p.to(dtype) for p in planes64]
    before = gj.K1_TIERS[dtype][tier]
    xr, xi, valid = gj.gj_solve_planes_cuda(*[p.to(cuda) for p in cpu],
                                            tier=tier)
    assert gj.K1_TIERS[dtype][tier] == before + 1
    pr, pi, pv = linsolve.gj_solve_planes(*cpu)
    assert torch.equal(valid.cpu(), pv)
    assert not pv[:3].any() and pv[3:].all()
    tr, ti, _ = linsolve.gj_solve_planes(*[p.double() for p in cpu])
    _hold((xr.cpu(), xi.cpu()), (pr, pi), (tr, ti), pv, dtype,
          f"K1 {tier} N={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tier,n", K2_CASES)
def test_k2_tier_matches_plain(cuda, tier, n, dtype):
    Ar, _, br, _ = _lanes(n, 24, 100 + n)
    A, b = (torch.as_tensor(a, dtype=dtype) for a in (Ar, br))
    before = gj_real.K2_TIERS[dtype][tier]
    x, valid = gj_real.gj_solve_cuda(A.to(cuda), b.to(cuda), tier=tier)
    assert gj_real.K2_TIERS[dtype][tier] == before + 1
    px, pv = linsolve.gj_solve(A, b)
    assert torch.equal(valid.cpu(), pv)
    assert not pv[:3].any() and pv[3:].all()
    tx, _ = linsolve.gj_solve(A.double(), b.double())
    _hold((x.cpu(),), (px,), (tx,), pv, dtype, f"K2 {tier} N={n}")


# N = 410: past complex f64's [panel | C] edge (PANEL_SMEM_EDGE), where the
# panel tier keeps [panel | C] in its workspace
K4_CASES = [(t, n) for t in gj.TIERS
            for n in (1, 3, 11, 16, 31, 32, 33, 64, 128, 129, 256, 410)
            if not (t == "warp" and n > gj.WARP_MAX_N)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tier,n", K4_CASES)
def test_k4_tier_matches_plain(cuda, tier, n, dtype):
    """Every tier of K4, forced, against the plain inverse on the card (at
    N = 410 the plain version takes minutes on a host's cores)."""
    B = 8 if n > 128 else 24
    Ar, Ai, _, _ = _lanes(max(n, 3), B, 300 + n)
    if n < 3:  # the three lanes need N >= 3; N = 1, 2: zero and NaN only
        Ar, Ai = Ar[:, :n, :n].copy(), Ai[:, :n, :n].copy()
        Ar[1, 0, n - 1] = np.nan
        Ar[2] = Ai[2] = 0.0
    dev = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in (Ar, Ai)]
    before = gj.K4_TIERS[dtype][tier]
    mr, mi, valid = gj.gj_inverse_planes_cuda(*dev, tier=tier)
    assert gj.K4_TIERS[dtype][tier] == before + 1
    pr, pi, pv = linsolve.gj_inverse_planes(*dev)
    assert torch.equal(valid, pv)
    assert not pv[:3].any() and pv[3:].all()
    tr, ti, _ = linsolve.gj_inverse_planes(*[p.double() for p in dev])
    pv = pv.cpu()
    _hold((mr.cpu(), mi.cpu()), (pr.cpu(), pi.cpu()), (tr.cpu(), ti.cpu()),
          pv, dtype, f"K4 {tier} N={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_chosen_tier_on_the_dispatch_path(cuda, n, dtype):
    """linsolve.solve_planes / solve reach the tier ``tier_for`` names."""
    Ar, Ai, br, bi = (torch.as_tensor(a, dtype=dtype, device=cuda)
                      for a in _lanes(n, 8, 7))
    t1, t2 = gj.tier_for(n, dtype), gj_real.tier_for(n, dtype)
    b1, b2 = gj.K1_TIERS[dtype][t1], gj_real.K2_TIERS[dtype][t2]
    linsolve.solve_planes(Ar, Ai, br, bi)
    linsolve.solve(Ar, br)
    assert gj.K1_TIERS[dtype][t1] == b1 + 1
    assert gj_real.K2_TIERS[dtype][t2] == b2 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["panel", "block"])
@pytest.mark.parametrize("cplx,dtype,n", PAST_EDGE)
def test_past_panel_edge_matches_plain(cuda, cplx, dtype, n, tier):
    """The panel and block tiers on either side of the N past which the
    panel tier's [panel | C] lives in the workspace, 8 systems with the
    same three lanes."""
    Ar, Ai, br, bi = _lanes(n, 8, 200 + n)
    # the plain versions run on the card too: at N = 1630 they take
    # minutes on a host's cores
    if cplx:
        dev = [torch.as_tensor(a, dtype=dtype, device=cuda)
               for a in (Ar, Ai, br, bi)]
        solve_cuda = gj.gj_solve_planes_cuda
        plain_fn = linsolve.gj_solve_planes
    else:
        dev = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in (Ar, br)]
        solve_cuda = gj_real.gj_solve_cuda
        plain_fn = linsolve.gj_solve
    got = [t.cpu() for t in solve_cuda(*dev, tier=tier)]
    plain = [t.cpu() for t in plain_fn(*dev)]
    assert torch.equal(got[-1], plain[-1])
    assert not plain[-1][:3].any() and plain[-1][3:].all()
    truth = [t.cpu() for t in plain_fn(*[p.double() for p in dev])]
    _hold(tuple(got[:-1]), tuple(plain[:-1]), tuple(truth[:-1]), plain[-1],
          dtype, f"{'K1' if cplx else 'K2'} {tier} N={n}")
