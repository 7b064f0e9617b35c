"""The tiers of K4, the complex inverse, on any host.

K4 (``csrc/gj_complex.cu``) inverts [A | I] in K1's tiers: "warp" (N <=
32, ``gj_common.cuh:warp_gj`` on width 2N), "panel" (N >= 33,
``csrc/gj_panel.cuh`` with N right-hand sides, the identity) and "block"
(``block_gj``, only when forced). These tests hold the choice, a pure
function of N and the dtype, at its boundaries and monotone in N; the
launch counters; and the wrapper's refusal of a tier that cannot take N,
before it touches the device. The card tests of every tier against the
plain inverse are in ``tests/test_torch_gj_tiers.py``.
"""

import pytest
import torch

from spicey_tpu_torch.ops import gj

DTYPES = (torch.float32, torch.float64)
ORDER = ("warp", "block", "panel")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 11, 16, 32, 33, 64, 128, 129, 256])
def test_k4_tier_at(n, dtype):
    assert gj.tier_for(n, dtype, inverse=True) == (
        "warp" if n <= 32 else "panel")


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_tiers_monotone_and_within_a_warp(dtype):
    tiers = [gj.tier_for(n, dtype, inverse=True) for n in range(1, 600)]
    ranks = [ORDER.index(t) for t in tiers]
    assert ranks == sorted(ranks)
    assert all(t != "warp" or n <= gj.WARP_MAX_N
               for n, t in enumerate(tiers, start=1))
    assert gj.K4_WARP_MAX <= gj.WARP_MAX_N < gj.K4_PANEL_MIN


def test_k4_tier_counters_cover_every_tier():
    for dtype in DTYPES:
        assert set(gj.K4_TIERS[dtype]) == set(gj.TIERS)


@pytest.mark.parametrize("n,tier,message", [
    (33, "warp", "no tier 'warp' at N=33"),
    (64, "warp", "no tier 'warp' at N=64"),
    (3, "lu", "no tier 'lu' at N=3"),
    (3, "thread", "no tier 'thread' at N=3"),
])
def test_k4_refuses_a_tier_that_cannot_take_n(n, tier, message):
    A = torch.zeros((2, n, n), dtype=torch.float64)
    before = dict(gj.K4_TIERS[torch.float64])
    with pytest.raises(ValueError, match=message):
        gj.gj_inverse_planes_cuda(A, A, tier=tier)
    assert gj.K4_TIERS[torch.float64] == before


@pytest.mark.parametrize("n,tier", [(32, "warp"), (33, "panel"),
                                    (3, "block"), (64, "block")])
def test_k4_takes_a_tier_that_can_take_n_as_far_as_the_device(n, tier):
    A = torch.zeros((2, n, n), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gj.gj_inverse_planes_cuda(A, A, tier=tier)
