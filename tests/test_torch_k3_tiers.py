"""The tiers of K3, the factor-once real inverse.

K3 (``csrc/gj_real.cu``) inverts [A | I] in four tiers: "register" (N up
to 8, one thread per system in its registers, ``gj_real_inv_reg_kernel``
on ``gj_common.cuh:reg_gj_inv_real``), "warp" (N <= 32,
``warp_inverse_kernel``), "panel"
(``csrc/gj_panel.cuh`` with N right-hand sides, the identity) and "block"
(``block_gj``, only when forced). On any host these tests hold the
choice, a pure function of N and the dtype, at its boundaries and
monotone in N, never "block"; the register form only at N with an
instance; the launch counters; and the wrapper's refusal of a tier that
cannot take N (K2's "thread" at any N), before it touches the device.

On the card (marked ``cuda``, skipped elsewhere; run with
``python -m pytest tests/test_torch_k3_tiers.py -m cuda --noconftest``):
every tier, forced, against the plain ``gj_inverse`` on random systems
with an all-zero system, a zero-row system and a NaN entry: ``valid``
identical on every system; f64 within 1e-12 x max|inverse|; in f32 the
tier's error against an f64 inverse of the same matrices at most twice
the plain f32 version's, plus 1e-5 x max|inverse| (nvcc contracts
multiply-adds into FMAs and the panel tier sums in another order).
"""

import numpy as np
import pytest
import torch

from spicey_tpu_torch.ops import gj_real, linsolve

DTYPES = (torch.float32, torch.float64)
ORDER = ("register", "warp", "block", "panel")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CARD_NS = (1, 3, 8, 9, 16, 17, 32, 33, 64, 129, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# ---- the tier choice, on any host -------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_tier_boundaries(dtype):
    rmax = gj_real.K3_REG_INSTANCES
    wmax, pmin = gj_real.K3_WARP_MAX, gj_real.K3_PANEL_MIN
    assert rmax < wmax <= gj_real.WARP_MAX_N and pmin == wmax + 1
    assert gj_real.tier_for(1, dtype, inverse=True) == "register"
    assert gj_real.tier_for(rmax, dtype, inverse=True) == "register"
    assert gj_real.tier_for(rmax + 1, dtype, inverse=True) == "warp"
    assert gj_real.tier_for(wmax, dtype, inverse=True) == "warp"
    assert gj_real.tier_for(pmin, dtype, inverse=True) == "panel"


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_tiers_monotone_and_never_block(dtype):
    tiers = [gj_real.tier_for(n, dtype, inverse=True) for n in range(1, 1025)]
    ranks = [ORDER.index(t) for t in tiers]
    assert ranks == sorted(ranks)
    assert "block" not in tiers
    assert set(tiers) <= set(gj_real.INV_TIERS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_register_form_only_where_it_has_an_instance(dtype):
    for n in range(1, 300):
        tier = gj_real.tier_for(n, dtype, inverse=True)
        assert tier != "register" or n <= gj_real.K3_REG_INSTANCES
        assert tier != "warp" or n <= gj_real.WARP_MAX_N
        assert tier in gj_real.inverse_tiers(n)
    assert "register" in gj_real.inverse_tiers(gj_real.K3_REG_INSTANCES)
    assert "register" not in gj_real.inverse_tiers(
        gj_real.K3_REG_INSTANCES + 1)


def test_k3_tier_counters_cover_every_tier():
    for dtype in DTYPES:
        assert set(gj_real.K3_TIERS[dtype]) == set(gj_real.INV_TIERS) \
            == {"register", "warp", "block", "panel"}
    # the register form is K3's alone, the thread tier K2's
    assert "register" not in gj_real.TIERS
    assert set(gj_real.TIERS) | set(gj_real.INV_TIERS) \
        | set(gj_real.MULTI_TIERS) == set(gj_real.CODES)


@pytest.mark.parametrize("n,tier,message", [
    (9, "register", "no tier 'register' at N=9"),
    (3, "thread", "no tier 'thread' at N=3"),
    (33, "warp", "no tier 'warp' at N=33"),
    (3, "lu", "no tier 'lu' at N=3"),
])
def test_k3_refuses_a_tier_that_cannot_take_n(n, tier, message):
    A = torch.zeros((2, n, n), dtype=torch.float64)
    before = dict(gj_real.K3_TIERS[torch.float64])
    with pytest.raises(ValueError, match=message):
        gj_real.gj_inverse_cuda(A, tier=tier)
    assert gj_real.K3_TIERS[torch.float64] == before


@pytest.mark.parametrize("n,tier", [(8, "register"), (16, "warp"),
                                    (32, "warp"), (33, "panel"),
                                    (3, "panel"), (64, "block")])
def test_k3_takes_a_tier_that_can_take_n_as_far_as_the_device(n, tier):
    A = torch.zeros((2, n, n), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gj_real.gj_inverse_cuda(A, tier=tier)


def test_k2_refuses_k3s_register_form():
    A = torch.zeros((2, 3, 3), dtype=torch.float64)
    b = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="no tier 'register'"):
        gj_real.gj_solve_cuda(A, b, tier="register")


# ---- every tier against the plain inverse, on the card ---------------------

def _systems(n, B, seed):
    """Random well-conditioned systems (B, n, n) as float64 numpy, with an
    all-zero system (0), a zero-row system (1) and a NaN entry (2); at
    N = 1 the zero row is the zero system."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + n * np.eye(n)
    A[0] = 0.0
    A[1, n // 2] = 0.0
    A[2, n // 2, n - 1] = np.nan
    return A


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tier,n", [(t, n) for n in CARD_NS
                                    for t in gj_real.inverse_tiers(n)])
def test_k3_tier_matches_plain(cuda, tier, n, dtype):
    B = 8 if n > 128 else 64
    A = torch.as_tensor(_systems(n, B, 400 + n), dtype=dtype, device=cuda)
    before = gj_real.K3_TIERS[dtype][tier]
    inv, valid = gj_real.gj_inverse_cuda(A, tier=tier)
    assert gj_real.K3_TIERS[dtype][tier] == before + 1
    pinv, pv = linsolve.gj_inverse(A)
    assert torch.equal(valid, pv)
    assert not pv[:3].any() and pv[3:].all()
    ok = pv.cpu()
    truth = pinv if dtype == torch.float64 else \
        linsolve.gj_inverse(A.double())[0]
    truth, got, plain = truth.cpu(), inv.cpu().double(), pinv.cpu().double()
    scale = float(truth[ok].abs().max())
    err = float((got - truth)[ok].abs().max())
    limit = TOL[dtype] * scale
    if dtype == torch.float32:
        limit += 2 * float((plain - truth)[ok].abs().max())
    assert err <= limit, f"K3 {tier} N={n}: {err:.3e} above {limit:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", CARD_NS)
def test_k3_chosen_tier_on_the_dispatch_path(cuda, n, dtype):
    """linsolve.inverse reaches the tier ``tier_for`` names."""
    A = torch.as_tensor(_systems(n, 8, 7)[3:], dtype=dtype, device=cuda)
    tier = gj_real.tier_for(n, dtype, inverse=True)
    before = gj_real.K3_TIERS[dtype][tier]
    _inv, valid = linsolve.inverse(A)
    assert bool(valid.all())
    assert gj_real.K3_TIERS[dtype][tier] == before + 1
