"""The port's device mesh (``spicey_tpu_torch/parallel/mesh.py``) on the CPU.

A mesh of repeated ``cpu`` devices stands in for the JAX package's
8-device virtual CPU mesh (``tests/conftest.py``). Each of the JAX
package's mesh tests has its counterpart here (``tests/test_batch.py``:
the 1D and the 2D batch x freq AC, the 1D transient;
``tests/test_mc.py``: the AC and transient statistics, the time-parallel
core with exact and approximate quantiles; ``tests/test_pallas_fused.py``:
the fused AC, the fused linear and switch/diode transient, and the 2D
mesh that falls back to the loop), each case held two ways:

(a) the port sharded against the port unsharded, at the JAX tests' own
    tolerances: rtol 1e-12 / atol 1e-15 on ``x``/``xs``, rtol 1e-13 on
    means and 1e-10 on quantiles (1e-12 on the time-parallel means), and
    for the f32 fused tiers rtol 1e-6 / atol 1e-7 on means and 1e-4 /
    1e-8 on std;
(b) against the JAX package's sharded run on the same inputs (made with
    numpy from a seed), at rtol 1e-9 / atol 1e-12 of the largest value
    in f64 and at the port's f32 tier tolerances (K5 and K8 2e-5, K9
    2e-4 with its std at 2e-2; ``tests/test_torch_mc_ac.py``,
    ``tests/test_torch_mc_tran.py``); an uneven split, which the JAX
    mesh refuses, is held to the JAX package's unsharded run, as is the
    singular variant.

Route parity is proven by counting the calls of each route's plain
version per piece: the fused kernels (K5, K8, K9) run per device only on
a 1D batch mesh dividing B with an unchunked AC sweep; a 2D mesh, an
uneven split and a chunked AC run take the non-fused route on every
piece, as the JAX package's sharded runs do. Empty pieces (B below the
device count) launch nothing.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu_torch.analysis import batch as tbatch
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.ops import mc_tran_fused as tfused
from spicey_tpu_torch.parallel import mesh as tmesh
from tests.fixtures import netlists
from tests.test_mc import _RLC_TP_NET
from tests.test_pallas_fused import RC_NET, TRAN_NET

CPU = "cpu"
AC_2D_NET = ("The t\nv1 1 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
             ".ac lin 16 1 100\n.end\n")
# DIODE_SWITCH over its first two switching periods (200 steps)
DIODE_SWITCH = netlists.DIODE_SWITCH.replace(".tran 0.00001 0.01",
                                             ".tran 0.00001 0.002")
SINGULAR_NET = ("* cap divider\nv1 1 0 ac 1\nc1 1 2 1u\nc2 2 0 1u\n"
                ".ac dec 2 1 100\n.end\n")


def _put(axes=None):
    """The port's sharder over repeated cpu devices, and the JAX
    package's over its 8 virtual CPU devices, for the same axes."""
    axes = axes or {"batch": 8}
    n = int(np.prod(list(axes.values())))
    return (st.sharder(st.make_mesh(axes, devices=[CPU] * n)),
            sj.sharder(sj.make_mesh(axes, devices=jax.devices("cpu")[:n])))


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a route's entry)."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _stats_close(a, b, rtol, std_rtol=None, q_rtol=None):
    """Every statistic at ``rtol`` of its largest value (std at
    ``std_rtol``, quantiles at ``q_rtol``, when given)."""
    np.testing.assert_array_equal(a.grid, b.grid)
    for f in ("mean", "std", "min", "max"):
        x, y = getattr(a, f), getattr(b, f)
        tol = std_rtol if f == "std" and std_rtol is not None else rtol
        np.testing.assert_allclose(x, y, rtol=tol,
                                   atol=tol * float(np.max(np.abs(y))),
                                   err_msg=f)
    for q, y in b.quantiles.items():
        tol = rtol if q_rtol is None else q_rtol
        np.testing.assert_allclose(a.quantiles[q], y, rtol=tol,
                                   atol=tol * float(np.max(np.abs(y))),
                                   err_msg=f"q{q}")
    assert a.n_valid == b.n_valid and a.n_total == b.n_total


def _f32_close(got, want):
    """tests/test_pallas_fused.py's sharded-against-unsharded rule for the
    f32 fused tiers."""
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-4, atol=1e-8)
    assert got.n_valid == want.n_valid


# ---- the mesh itself ------------------------------------------------------

def test_make_mesh_matches_jax_and_raises_as_it_does(monkeypatch):
    mesh = st.make_mesh({"batch": 4, "freq": 2}, devices=[CPU] * 8)
    jm = sj.make_mesh({"batch": 4, "freq": 2}, devices=jax.devices("cpu"))
    assert mesh.axis_names == jm.axis_names
    assert mesh.shape == dict(jm.shape)
    assert mesh.devices.shape == (4, 2) and mesh.first == torch.device(CPU)
    assert st.make_mesh(devices=[CPU] * 3).shape == {"batch": 3}
    with pytest.raises(ValueError) as got:
        st.make_mesh({"batch": 3}, devices=[CPU] * 8)
    with pytest.raises(ValueError) as want:
        sj.make_mesh({"batch": 3}, devices=jax.devices("cpu"))
    assert str(got.value) == str(want.value)
    # the default mesh spans the CUDA devices and never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.make_mesh()


@pytest.mark.parametrize("axes,spec", [
    ({"batch": 8}, ("batch", None)),
    ({"batch": 4, "freq": 2}, ("batch", None)),
    ({"batch": 4, "freq": 2}, (None, "freq")),
    ({"batch": 2, "freq": 4}, ("batch", "freq")),
    ({"batch": 8}, ("freq", None)),          # an axis the mesh lacks
])
def test_put_places_pieces_as_jax_device_put(axes, spec):
    """Each position's piece is the block that jax.device_put places on
    the device at that position of the JAX mesh."""
    put, jput = _put(axes)
    a = np.arange(8 * 16, dtype=np.float64).reshape(8, 16)
    pieces = put(torch.as_tensor(a), spec)
    placed = jput(a, spec)
    assert isinstance(placed.sharding, NamedSharding)
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    jdevs = jput.mesh.devices
    assert pieces.shape == jdevs.shape
    for pos in np.ndindex(*jdevs.shape):
        np.testing.assert_array_equal(pieces[pos].numpy(),
                                      by_device[jdevs[pos]])
    assert put.mesh.shape == dict(jput.mesh.shape)


def test_put_splits_unevenly_and_leaves_empty_pieces():
    put, _ = _put({"batch": 8})
    pieces = put(torch.arange(5.0)[:, None].expand(5, 2), ("batch", None))
    assert [p.shape[0] for p in pieces] == [1, 1, 1, 1, 1, 0, 0, 0]
    assert torch.equal(torch.cat(list(pieces)), torch.arange(5.0)[:, None]
                       .expand(5, 2))


def test_device_must_be_the_mesh_first_device():
    put, _ = _put()
    ov = {"r1": np.array([30.0, 33.0])}
    st.mc_ac_stats(netlists.BASICS01_AC, ov, node="2", device=CPU,
                   device_put=put)
    with pytest.raises(ValueError, match="first device"):
        st.mc_ac_stats(netlists.BASICS01_AC, ov, node="2", device="meta",
                       device_put=put)
    with pytest.raises(TypeError, match="sharder"):
        st.simulate_ac_batch(netlists.BASICS01_AC, ov,
                             device_put=lambda t, axes: t)


# ---- tests/test_batch.py:102, 118, 132 -------------------------------------

@pytest.mark.parametrize("layout", ["1d", "2d"])
@pytest.mark.parametrize("method", ["gj", "pallas"])
def test_ac_batch_sharded_over_repeated_cpu_devices(layout, method, monkeypatch):
    """The JAX package's 1D AC mesh (B = 16 over 8) and its 2D batch x
    freq mesh (B = 8, 16 frequencies over 4 x 2): every block takes the
    route an unsharded call takes (K7's plain version for "pallas", the
    planes and K1's plain version for "gj")."""
    if layout == "1d":
        net, axes = netlists.BASICS01_AC, {"batch": 8}
        ov = {"r1": 30.0 * (1 + 0.1 * np.random.default_rng(0)
                            .random(16))}
    else:
        net, axes = AC_2D_NET, {"batch": 4, "freq": 2}
        ov = {"r1": np.linspace(10, 50, 8)}
    put, jput = _put(axes)
    local = st.simulate_ac_batch(net, ov, method=method, device=CPU)
    route = _counting(monkeypatch, tbatch, "mc_ac_fused_x"
                      if method == "pallas" else "_ac_sweep_core")
    got = st.simulate_ac_batch(net, ov, method=method, device_put=put)
    assert len(route) == 8
    np.testing.assert_allclose(got.x.view(np.float64),
                               local.x.view(np.float64), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(got.valid, local.valid)
    want = _jax_ac_batch(net, tuple(ov["r1"]), tuple(axes.items()))
    scale = float(np.max(np.abs(want.x)))
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-12 * scale)
    np.testing.assert_array_equal(got.valid, want.valid)


@functools.lru_cache(maxsize=None)
def _jax_ac_batch(net, r1, axes):
    return sj.simulate_ac_batch(net, {"r1": np.array(r1)},
                                device_put=_put(dict(axes))[1])


@pytest.mark.parametrize("case", ["rc", "dc-sources-uneven"])
def test_tran_batch_sharded_over_cpu_mesh(case, monkeypatch):
    """The JAX package's 1D transient (RC, B = 8 over 8), and the
    DIODE_SWITCH loop with its DC source swept (the source grid split on
    its variants axis) at B = 5 over 8 devices: three pieces are empty and
    never run."""
    put, jput = _put()
    if case == "rc":
        net = netlists.RC_PULSE
        ov = {"R1": 1e3 * (1 + 0.2 * np.linspace(0, 1, 8))}
    else:
        net = DIODE_SWITCH
        rng = np.random.default_rng(5)
        ov = {"RR1": 1e3 * (1 + 0.1 * rng.random(5)),
              "Vsimulation_voltage_source_0": 5 * (1 + 0.1 * rng.random(5))}
    local = st.simulate_tran_batch(net, ov, device=CPU)
    blocks = _counting(monkeypatch, tbatch, "_tran_block")
    got = st.simulate_tran_batch(net, ov, device_put=put)
    assert len(blocks) == len(next(iter(ov.values())))
    np.testing.assert_allclose(got.xs, local.xs, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(got.sw_states, local.sw_states)
    np.testing.assert_array_equal(got.valid, local.valid)
    want = (sj.simulate_tran_batch(net, ov, device_put=jput)
            if case == "rc" else sj.simulate_tran_batch(net, ov))
    scale = float(np.max(np.abs(want.xs)))
    np.testing.assert_allclose(got.xs, want.xs, rtol=1e-9,
                               atol=1e-12 * scale)
    np.testing.assert_array_equal(got.valid, want.valid)


# ---- tests/test_mc.py:161, 582 --------------------------------------------

def test_mc_stats_sharded_over_cpu_mesh():
    put, jput = _put()
    B = 32
    rng = np.random.default_rng(13)
    ov = {"r1": 30.0 * (1 + 0.2 * rng.random(B))}
    a = st.mc_ac_stats(netlists.BASICS01_AC, ov, node="2", device=CPU)
    b = st.mc_ac_stats(netlists.BASICS01_AC, ov, node="2", device_put=put)
    _stats_close(b, a, rtol=1e-13, q_rtol=1e-10)
    _stats_close(b, sj.mc_ac_stats(netlists.BASICS01_AC, ov, node="2",
                                   device_put=jput), rtol=1e-9)
    ovt = {"R1": 1e3 * (1 + 0.2 * rng.random(B))}
    at = st.mc_tran_stats(netlists.RC_PULSE, ovt, node="2", device=CPU)
    bt = st.mc_tran_stats(netlists.RC_PULSE, ovt, node="2", device_put=put)
    _stats_close(bt, at, rtol=1e-13, q_rtol=1e-10)
    assert bt.n_valid == B
    _stats_close(bt, sj.mc_tran_stats(netlists.RC_PULSE, ovt, node="2",
                                      device_put=jput), rtol=1e-9)


@pytest.mark.parametrize("q_method", ["exact", "approx"])
def test_time_parallel_sharded_over_cpu_mesh(q_method, monkeypatch):
    """The time-parallel decision is taken at the global B; each of the 8
    pieces then runs _tp_solutions (K3 on the card), and one reduction
    runs over the gathered responses."""
    put, jput = _put()
    B = 32
    rng = np.random.default_rng(13)
    ov = {"R1": 100.0 * (1 + 0.2 * rng.random(B)),
          "C1": 1e-6 * (1 + 0.2 * rng.random(B))}
    kw = dict(node="b", quantile_method=q_method)
    a = st.mc_tran_stats(_RLC_TP_NET, ov, device=CPU, **kw)
    tp = _counting(monkeypatch, tmc, "_tp_solutions")
    b = st.mc_tran_stats(_RLC_TP_NET, ov, device_put=put, **kw)
    assert len(tp) == 8 and b.n_valid == B
    _stats_close(b, a, rtol=1e-12, q_rtol=1e-10)
    want = sj.mc_tran_stats(_RLC_TP_NET, ov, device_put=jput, **kw)
    if q_method == "exact":
        _stats_close(b, want, rtol=1e-9)
        return
    # the CDF bisection stops within ~span/2^30 of a quantile: its
    # quantiles are held as tests/test_mc.py holds them against the sort
    _stats_close(b, dataclasses.replace(want, quantiles=b.quantiles),
                 rtol=1e-9)
    tol = 5.0 * float(np.max(want.max - want.min)) / B + 1e-12
    for q in want.quantiles:
        assert np.max(np.abs(b.quantiles[q] - want.quantiles[q])) <= tol


# ---- tests/test_pallas_fused.py:132, 502 ----------------------------------

def test_ac_fused_sharded_over_cpu_mesh(monkeypatch):
    """A 1D batch mesh dividing B runs K5 (its plain version here) once
    per piece."""
    put, jput = _put()
    rng = np.random.default_rng(12)
    B = 40
    ov = {"r1": 30.0 * (1 + 0.2 * rng.random(B)),
          "c1": 100e-6 * (1 + 0.2 * rng.random(B))}
    kw = dict(node="2", method="pallas", precision="f32")
    k5 = _counting(monkeypatch, tmc, "mc_ac_fused")
    a = st.mc_ac_stats(RC_NET, ov, device=CPU, **kw)
    assert len(k5) == 1
    b = st.mc_ac_stats(RC_NET, ov, device_put=put, **kw)
    assert len(k5) == 1 + 8
    _f32_close(b, a)
    want = sj.mc_ac_stats(sj.parse_netlist(RC_NET), ov, interpret=True,
                          device_put=jput, **kw)
    _stats_close(b, want, rtol=2e-5)


@pytest.mark.parametrize("deck", ["linear", "diode-switch"])
def test_tran_fused_sharded_over_cpu_mesh(deck, monkeypatch):
    """K8 (linear) and K9 (switch + diode) run once per piece on a 1D
    batch mesh dividing B."""
    put, jput = _put()
    rng = np.random.default_rng(11)
    B = 32
    if deck == "linear":
        net, node, tol = TRAN_NET, "2", {"rtol": 2e-5}
        ov = {"R1": 1e3 * (1 + 0.2 * rng.random(B)),
              "C1": 1e-6 * (1 + 0.2 * rng.random(B)),
              "L1": 1e-3 * (1 + 0.2 * rng.random(B))}
    else:
        net, node, tol = DIODE_SWITCH, "N3", {"rtol": 2e-4, "std_rtol": 2e-2}
        ov = {"RR1": 1e3 * (1 + 0.1 * rng.random(B))}
    kw = dict(node=node, method="pallas", precision="f32")
    fused = _counting(monkeypatch, tfused, "mc_tran_fused")
    a = st.mc_tran_stats(net, ov, device=CPU, **kw)
    b = st.mc_tran_stats(net, ov, device_put=put, **kw)
    assert len(fused) == 1 + 8
    _f32_close(b, a)
    assert b.n_valid == B
    want = sj.mc_tran_stats(sj.parse_netlist(net), ov, interpret=True,
                            device_put=jput, **kw)
    _stats_close(b, want, **tol)


def test_tran_2d_mesh_falls_back_to_the_loop(monkeypatch):
    """A 2D mesh (a freq axis in play) takes the loop on every piece at
    f32, not the fused kernel, as the JAX package's does."""
    put, jput = _put({"batch": 4, "freq": 2})
    rng = np.random.default_rng(11)
    B = 32
    ov = {"R1": 1e3 * (1 + 0.2 * rng.random(B)),
          "C1": 1e-6 * (1 + 0.2 * rng.random(B)),
          "L1": 1e-3 * (1 + 0.2 * rng.random(B))}
    fused = _counting(monkeypatch, tfused, "mc_tran_fused")
    loop = _counting(monkeypatch, tmc, "_tran_core")
    kw = dict(node="2", method="pallas", precision="f32",
              time_parallel="never")
    c = st.mc_tran_stats(TRAN_NET, ov, device_put=put, **kw)
    assert not fused and len(loop) == 4 and c.n_valid == B
    local = st.mc_tran_stats(TRAN_NET, ov, device=CPU,
                             **dict(kw, method="gj"))
    _f32_close(c, local)
    want = sj.mc_tran_stats(sj.parse_netlist(TRAN_NET), ov, interpret=True,
                            device_put=jput, **kw)
    _stats_close(c, want, rtol=2e-5)


@pytest.mark.parametrize("case", ["uneven", "chunked", "2d"])
def test_ac_fused_rule_falls_back_on_every_piece(case, monkeypatch):
    """K5 runs per device only on a 1D batch mesh dividing B with no
    chunk; otherwise every piece takes the planes and K1 (plain here),
    as the JAX package's ``_batch_mesh`` rule says."""
    axes = {"batch": 4, "freq": 2} if case == "2d" else {"batch": 8}
    put, _ = _put(axes)
    B = 37 if case == "uneven" else 40
    rng = np.random.default_rng(3)
    ov = {"r1": 30.0 * (1 + 0.2 * rng.random(B)),
          "c1": 100e-6 * (1 + 0.2 * rng.random(B))}
    kw = dict(node="2", precision="f32",
              chunk=3 if case == "chunked" else None)
    k5 = _counting(monkeypatch, tmc, "mc_ac_fused")
    sweep = _counting(monkeypatch, tmc, "_ac_sweep_core")
    got = st.mc_ac_stats(RC_NET, ov, method="pallas", device_put=put, **kw)
    # 8 pieces (2d: 4 blocks, the freq axis splits nothing here); chunked:
    # two chunks of at most 3 in each piece of 5
    assert not k5
    assert len(sweep) == {"uneven": 8, "chunked": 16, "2d": 4}[case]
    local = st.mc_ac_stats(RC_NET, ov, method="gj", device=CPU, **kw)
    _stats_close(got, local, rtol=1e-6, std_rtol=1e-4)


# ---- edge cases -----------------------------------------------------------

@pytest.mark.parametrize("where", [3, 11])
def test_singular_variant_is_flagged_in_its_piece(where):
    """A singular variant (c1 = c2 = 0) is invalid in whichever piece it
    falls (B = 12 over 8: pieces of 2, 2, 2, 2, 1, 1, 1, 1) and leaves the
    statistics, as unsharded."""
    put, _ = _put()
    B = 12
    c = np.full(B, 1e-6)
    c[where] = 0.0
    ov = {"c1": c.copy(), "c2": c.copy()}
    got = st.mc_ac_stats(SINGULAR_NET, ov, node="2", device_put=put)
    local = st.mc_ac_stats(SINGULAR_NET, ov, node="2", device=CPU)
    assert got.n_valid == local.n_valid == B - 1
    _stats_close(got, local, rtol=1e-13, q_rtol=1e-10)
    _stats_close(got, sj.mc_ac_stats(SINGULAR_NET, ov, node="2"),
                 rtol=1e-9)
    res = st.simulate_ac_batch(SINGULAR_NET, ov, device_put=put)
    assert not res.valid[where].any() and res.valid.sum() == (B - 1) * 5


def test_fewer_variants_than_devices_skip_empty_pieces(monkeypatch):
    """B = 3 over 8 devices: three blocks run, five pieces are empty and
    launch nothing; the gather is the unsharded answer."""
    put, _ = _put()
    ov = {"r1": np.array([20.0, 30.0, 40.0])}
    local = st.simulate_ac_batch(netlists.BASICS01_AC, ov, device=CPU)
    sweep = _counting(monkeypatch, tbatch, "_ac_sweep_core")
    got = st.simulate_ac_batch(netlists.BASICS01_AC, ov, device_put=put)
    assert len(sweep) == 3
    np.testing.assert_array_equal(got.x, local.x)
    stats = st.mc_tran_stats(netlists.RC_PULSE, {"R1": ov["r1"] * 50},
                             node="2", device_put=put)
    assert stats.n_valid == stats.n_total == 3


def test_map_blocks_gathers_in_mesh_order():
    """Blocks over a 2D mesh (uneven on both axes) gather into the
    unsplit answer, keeping a transposed output's memory layout."""
    put, _ = _put({"batch": 4, "freq": 2})
    a = torch.arange(7 * 3, dtype=torch.float64).reshape(7, 3)
    f = torch.arange(3, dtype=torch.float64)

    def fn(a, f):
        out = a[:, None, :] * 10 + f[None, :, None]
        return out, out.sum(-1).T.contiguous().T

    got = tmesh.map_blocks(put, fn, {"a": a, "f": f},
                           {"a": tmesh.VARIANTS, "f": ("freq",)},
                           ({"batch": 0, "freq": 1},) * 2, 7)
    want = fn(a, f)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].stride() == want[1].stride()


def test_warmup_on_the_cpu(monkeypatch):
    assert st.warmup(device=CPU) >= 0.0
    assert st.warmup(full=True, device=CPU) >= 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.warmup()
