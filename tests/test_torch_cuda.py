"""Kernels K1 and K5 against their plain versions, on the card.

Tests marked ``cuda`` need an NVIDIA GPU with the CUDA toolkit and skip
elsewhere; run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
card's machine has no jax, which ``tests/conftest.py`` imports, so this
file needs no conftest fixture). f64 is held at rtol
1e-12 and f32 at 1e-5 (nvcc contracts multiply-adds into FMAs, so the
last bits differ from the CPU); ``valid`` must agree exactly. The
unmarked tests check, on any host, that a wrapper refuses what its kernel
does not take before it builds anything.
"""

import pathlib

import numpy as np
import pytest
import torch

import spicey_tpu_torch as st
from spicey_tpu_torch.ops import gj, linsolve, mc_ac_fused

RC = ("* rc\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
      ".ac dec 10 1 100\n.end\n")
BASICS01 = ("Demo of a simple AC circuit\nv1 1 0 dc 0 ac 1\nr1 1 2 30\n"
            "c1 2 0 100u\n.ac dec 100 1 100\n.end\n")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "basics01_golden.txt"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _systems(n, B, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
    Ai = rng.standard_normal((B, n, n))
    br, bi = rng.standard_normal((2, B, n))
    Ar[0] = Ai[0] = 0.0  # one singular lane
    return [torch.as_tensor(a, dtype=dtype) for a in (Ar, Ai, br, bi)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [3, 16, 64, 128])
def test_k1_matches_plain(cuda, n, dtype):
    cpu = _systems(n, 33, dtype)
    before = gj.K1[dtype].launches
    xr, xi, valid = linsolve.solve_planes(*[t.to(cuda) for t in cpu])
    assert gj.K1[dtype].launches == before + 1
    rr, ri, rv = linsolve.gj_solve_planes(*cpu)
    assert torch.equal(valid.cpu(), rv) and not rv[0]
    for got, want in ((xr, rr), (xi, ri)):
        torch.testing.assert_close(got.cpu()[rv], want[rv],
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("method", ["pallas", "gj"])
def test_mc_routes_match_cpu(cuda, precision, method):
    rng = np.random.default_rng(1)
    ov = {"r1": 30 * (1 + 0.2 * rng.random(500)),
          "c1": 1e-4 * (1 + 0.2 * rng.random(500))}
    dtype = torch.float64 if precision == "f64" else torch.float32
    counter = (mc_ac_fused.K5 if method == "pallas" else gj.K1)[dtype]
    before = counter.launches
    got = st.mc_ac_stats(RC, ov, node="2", method=method,
                         precision=precision, device=cuda)
    assert counter.launches > before
    want = st.mc_ac_stats(RC, ov, node="2", method=method,
                          precision=precision)
    tol = TOL[dtype]
    assert got.n_valid == want.n_valid == 500
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=10 * tol, err_msg=f)


@pytest.mark.cuda
def test_golden_on_cuda(cuda):
    golden = GOLDEN.read_text()
    out = st.format_ac_result(st.simulate(BASICS01, device=cuda).ac)
    assert out == golden


def test_k1_wrapper_refuses_bad_input():
    cpu = _systems(4, 2, torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        gj.gj_solve_planes_cuda(*cpu)
    with pytest.raises(TypeError, match="float32 or float64"):
        gj.gj_solve_planes_cuda(*[t.to(torch.float16) for t in cpu])
    big = _systems(129, 1, torch.float64)
    with pytest.raises(ValueError, match="N <= 128"):
        gj.gj_solve_planes_cuda(*big)


def test_k5_wrapper_refuses_bad_input():
    ckt = st.parse_netlist(RC)
    t = st.build_tensors(ckt)
    pattern = mc_ac_fused.build_stamp_pattern(t.nvar, t.r_idx, t.c_idx,
                                              t.l_idx, t.v_idx)
    packed = mc_ac_fused.pack_pattern(pattern, t.nvar, "cpu")
    freqs = torch.ones(3, dtype=torch.float32)
    values = torch.ones((packed.n_rows, 5), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mc_ac_fused.mc_ac_fused_cuda(freqs, values, packed, 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        mc_ac_fused.mc_ac_fused_cuda(freqs.double(), values, packed, 1)
    with pytest.raises(ValueError, match="n_rows"):
        mc_ac_fused.mc_ac_fused_cuda(freqs, values[:1], packed, 1)
