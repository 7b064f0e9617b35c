"""The plain references against closed forms at small sizes (CPU)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import manifest  # noqa: E402

mna = manifest.module("reference", "mna")
CPU = torch.device("cpu")


def test_rlc_step_matches_the_backward_euler_recurrence():
    """An RL-C step (5 V through L into C || R, the boost converter with
    its switch open and its diode shorted): backward Euler's update is
    the linear map z' = M z + c on z = (i_L, v_C), whose closed form is
    z_k = M^k (z_0 - z*) + z*."""
    deck = mna.read_deck("* rl-c step\nv1 1 0 dc 5\nl1 1 2 1\n"
                         "c1 2 0 10u\nr1 2 0 1k\n.tran 10u 2m\n.end\n")
    v, ok, passes = mna.tran_response(deck, {"r1": np.array([1e3, 900.0])},
                                      "2", torch.float64, CPU)
    assert bool(ok.all()) and bool((passes == v.shape[1]).all())
    dt, times = mna.time_grid(deck)
    L, C = 1.0, 10e-6
    for lane, R in enumerate((1e3, 900.0)):
        # C (v' - v)/dt = i' - v'/R ; i' = i + dt/L (5 - v')
        A = np.array([[1.0, dt / L], [-1.0, C / dt + 1.0 / R]])
        M = np.linalg.solve(A, np.array([[1.0, 0.0], [0.0, C / dt]]))
        c = np.linalg.solve(A, np.array([5.0 * dt / L, 0.0]))
        z_star = np.linalg.solve(np.eye(2) - M, c)
        w, P = np.linalg.eig(M)
        z0 = c                       # the first step from rest
        want = []
        for k in range(len(times)):
            zk = (P @ np.diag(w ** k) @ np.linalg.solve(P, z0 - z_star)
                  + z_star)
            want.append(zk[1].real)
        np.testing.assert_allclose(v[lane].numpy(), want, rtol=1e-9,
                                   atol=1e-12)


def test_boost_first_step_with_the_switch_open():
    """The upstream boost converter's t = 0 point: the switch is open
    (Roff), the diode at rest carries only GMIN, so V(N3) is the
    divider 5 g_L / (g_L + g_off + g_d || (g_C + g_R)) seen through g_d.
    On the deck's 1 ms grid the PULSE is 0 V at every point, so the
    switch never closes: one pass a step."""
    text = (ROOT / "portbench/configs/boost-converter-probe.cir").read_text()
    deck = mna.read_deck(text)
    R = np.array([1e3, 1.1e3])
    v, ok, passes = mna.tran_response(deck, {"RR1": R}, "N3",
                                      torch.float64, CPU)
    dt, _ = mna.time_grid(deck)
    g_l, g_off, g_d, g_c = dt / 1.0, 1e-12, mna.GMIN, 10e-6 / dt
    g_r = 1.0 / R
    g_out = g_c + g_r
    n2 = 5 * g_l / (g_l + g_off + g_d - g_d * g_d / (g_d + g_out))
    n3 = g_d * n2 / (g_d + g_out)
    np.testing.assert_allclose(v[:, 0].numpy(), n3, rtol=1e-9)
    assert bool(ok.all())
    assert bool((passes == v.shape[1]).all())
    src = deck.of("V")[1].pulse
    assert all(src.at(float(t)) == 0.0 for t in mna.time_grid(deck)[1])


def test_unknown_model_parameters_raise():
    with pytest.raises(ValueError, match="parameter"):
        mna.read_deck("* t\n.model sw1 SW(vt=2.5)\nr1 1 0 1k\n.end\n")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gauss_solve_agrees_with_the_library(dtype):
    g = torch.Generator().manual_seed(3)
    A = torch.randn((64, 6, 6), generator=g, dtype=torch.float64) \
        + 6 * torch.eye(6, dtype=torch.float64)
    b = torch.randn((64, 6), generator=g, dtype=torch.float64)
    x_ref, ok_ref = mna.solve(A, b)
    x, ok = mna.gauss_solve(A.to(dtype), b.to(dtype))
    assert bool(ok.all()) and bool(ok_ref.all())
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(x.double().numpy(), x_ref.numpy(), rtol=tol,
                               atol=tol)


def test_numbers_and_grids():
    assert mna.number("10U") == pytest.approx(1e-5)
    assert mna.number("1K") == 1e3
    assert mna.number("2meg") == 2e6
    assert mna.number("0.00068") == 0.00068
    with pytest.raises(ValueError):
        mna.read_deck("* t\nv1 1 0 ac 1\nr1 1 0 1k\n.ac lin 201 1 10k\n")
    deck = mna.read_deck((ROOT / "portbench/configs/boost-converter-probe.cir")
                         .read_text())
    dt, t = mna.time_grid(deck)
    assert len(t) == 101 and dt == pytest.approx(1e-3)
    assert len(deck.unknowns) == 6
