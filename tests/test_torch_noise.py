"""The port's .noise, AC ``linearize="op"`` and the small-signal slice as a
whole against the JAX package on the CPU.

``simulate_noise`` solves the forward and the adjoint system from one
complex inverse per frequency (the plain version of kernel K4 here, K4 on
the card) with the JAX pallas tier's 1e-12 residual guard; the JAX package
solves each directly. Output PSD, gain and every contribution are held at
rtol 1e-9 / atol 1e-12 on the decks of tests/test_noise.py; on the
two-stage amplifier, whose bypassed emitter resistors contribute ~1e-10 of
the total at the top of its GHz sweep, each contribution is held within
1e-9 of the total output PSD at its frequency. The formatters are
string-equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

import spicey_tpu as sj
from spicey_tpu.analysis.ac import simulate_ac as jax_simulate_ac
from spicey_tpu.analysis.noise import simulate_noise as jax_simulate_noise
from spicey_tpu.analysis.op import simulate_op as jax_simulate_op
import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.analysis import noise as tnoise
from spicey_tpu_torch.ops import linsolve
from tests.test_torch_cuda import guard_systems

RTOL, ATOL = 1e-9, 1e-12

_MOS = """* mos noise
.model mn nmos(vto=1 kp=1m)
vdd vdd 0 {VD}
vg g 0 {VG}
rload vdd d 1k
m1 d g 0 mn
.noise v(d) vg lin 2 1k 2k
.end
"""

NOISE_DECKS = {
    "resistor": ("the lone resistor\nv1 in 0 dc 0 ac 1\nr1 in out 1k\n"
                 "r2 out 0 1k\n.noise v(out) v1 dec 10 1k 1meg\n"),
    "rc_ktc": ("the rc noise\nv1 in 0 dc 0 ac 1\nr1 in out 10k\n"
               "c1 out 0 1n\n.noise v(out) v1 dec 40 1 1g\n"),
    "diode_shot": ("the diode shot\nv1 in 0 dc 5\nr1 in out 1k\n"
                   "d1 out 0 dm\n.model dm d(is=1e-14)\n"
                   ".noise v(out) v1 dec 5 1k 100k\n"),
    "differential_current_input": (
        "the norton noise\ni1 0 a 1m\nr1 a 0 1k\nr2 a b 1k\nr3 b 0 1k\n"
        ".noise v(a,b) i1 lin 5 10 50\n"),
    "flicker": ("* flicker\n.model dn d(is=1e-14 kf=1e-16 af=1)\n"
                "v1 a 0 dc 5 ac 1\nr1 a b 1k\ndx b 0 dn\n"
                ".noise v(b) v1 dec 10 1 1e6\n.end\n"),
    "mos_triode": _MOS.format(VD="1", VG="5"),
    "mos_saturation": _MOS.format(VD="30", VG="5"),
    "mos_cutoff": _MOS.format(VD="8", VG="0"),
}


def _same_noise(got, want, contrib_scale=None):
    np.testing.assert_array_equal(got.freqs, want.freqs)
    for f in ("output_psd", "input_psd", "gain"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert list(got.contributions) == list(want.contributions)
    for name, c in want.contributions.items():
        atol = ATOL if contrib_scale is None else 1e-9 * contrib_scale
        err = np.abs(got.contributions[name] - c)
        assert (err <= RTOL * np.abs(c) + atol).all(), (name, err.max())
    np.testing.assert_allclose(got.total_output_rms, want.total_output_rms,
                               rtol=RTOL)
    assert (got.out_spec, got.src_name) == (want.out_spec, want.src_name)


@pytest.mark.parametrize("deck", sorted(NOISE_DECKS))
def test_simulate_noise_matches_jax(deck):
    net = NOISE_DECKS[deck]
    want = jax_simulate_noise(sj.parse_netlist(net, dialect="extended"))
    got = st.simulate(net, dialect="extended", device="cpu").noise
    _same_noise(got, want)
    assert got.guard_resolves == 0
    if deck == "mos_cutoff":
        assert got.contributions["m1"][0] == 0.0


@pytest.mark.parametrize("deck", ["diode_shot", "mos_saturation"])
def test_noise_takes_the_jax_operating_point(deck):
    net = NOISE_DECKS[deck]
    jckt = sj.parse_netlist(net, dialect="extended")
    op = jax_simulate_op(jckt)
    want = jax_simulate_noise(jckt, op=op)
    got = st.simulate_noise(st.parse_netlist(net, dialect="extended"),
                            tensors=st.from_jax_tensors(
                                sj.build_tensors(jckt)), op=op, device="cpu")
    _same_noise(got, want)


def test_amplifier_deck_matches_jax():
    """The two-stage amplifier through simulate(): .op, .tf, .options
    acop with .ac and .noise over 1 Hz - 1 GHz, one operating point."""
    want = sj.simulate(decks.AMP_DECK, dialect="extended")
    got = st.simulate(decks.AMP_DECK, dialect="extended", device="cpu")
    for series, ref in ((got.op.node_voltages, want.op.node_voltages),
                        (got.op.element_currents, want.op.element_currents)):
        assert list(series) == list(ref)
        for name, v in ref.items():
            np.testing.assert_allclose(series[name], v, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    for f in ("transfer_function", "input_impedance", "output_impedance"):
        np.testing.assert_allclose(getattr(got.tf, f), getattr(want.tf, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    for name, z in want.ac.node_voltages.items():
        np.testing.assert_allclose(got.ac.node_voltages[name], z, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert len(got.noise.freqs) == 901
    _same_noise(got.noise, want.noise,
                contrib_scale=want.noise.output_psd)
    assert got.noise.guard_resolves == 0


AC_OP_DECKS = {
    "mosfet_gain": ("t\n.model mn nmos(vto=1 kp=2m)\nvdd vdd 0 5\n"
                    "vg gt 0 dc 2 ac 1\nrd vdd d 1k\nm1 d gt 0 mn\n"
                    ".ac lin 3 10 1000\n"),
    "bjt_gain": ("t\n.model qn npn(is=1e-16 bf=100)\nvcc vcc 0 5\n"
                 "ib 0 bs dc 10u ac 1u\nrc vcc c 1k\nq1 c bs 0 qn\n"
                 ".ac lin 3 10 1000\n"),
    "diode": ("t\n.model dm d(is=1e-14)\nv1 a 0 dc 5 ac 1\nr1 a k 10k\n"
              "d1 k 0 dm\n.ac lin 2 10 100\n"),
    "varactor": ("t\n.model dv d(is=1e-14 cjo=10p vj=0.7 m=0.5)\n"
                 "v1 a 0 dc -2 ac 1\nr1 a k 10k\nd1 k 0 dv\n"
                 ".ac dec 5 1k 1g\n"),
}


@pytest.mark.parametrize("deck", sorted(AC_OP_DECKS))
def test_ac_linearize_op_matches_jax(deck):
    net = AC_OP_DECKS[deck]
    want = jax_simulate_ac(sj.parse_netlist(net, dialect="extended"),
                           linearize="op")
    got = st.simulate(net, dialect="extended", ac_linearize="op",
                      device="cpu").ac
    assert list(got.node_voltages) == list(want.node_voltages)
    for series, ref in ((got.node_voltages, want.node_voltages),
                        (got.element_currents, want.element_currents)):
        for name, z in ref.items():
            np.testing.assert_allclose(series[name], z, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    if deck == "mosfet_gain":  # -gm*Rd = -2 exactly (lambda = 0)
        np.testing.assert_allclose(got.node_voltages["d"], -2.0, rtol=1e-6)


def test_formatters_string_equal():
    net = ("the fmt\nv1 in 0 dc 1 ac 1\nr1 in out 1k\nr2 out 0 1k\n.op\n"
           ".dc v1 0 2 0.5\n.tf v(out) v1\n"
           ".noise v(out) v1 lin 3 100 300\n")
    want = sj.simulate(net, dialect="extended")
    got = st.simulate(net, dialect="extended", device="cpu")
    assert st.format_op_result(got.op) == sj.format_op_result(want.op)
    assert st.format_dc_result(got.dc) == sj.format_dc_result(want.dc)
    assert st.format_tf_result(got.tf) == sj.format_tf_result(want.tf)
    assert (st.format_noise_result(got.noise)
            == sj.format_noise_result(want.noise))
    for fmt, none in ((st.format_op_result, "No OP analysis.\n"),
                      (st.format_dc_result, "No DC analysis.\n"),
                      (st.format_tf_result, "No TF analysis.\n"),
                      (st.format_noise_result, "No NOISE analysis.\n")):
        assert fmt(None) == none


def test_noise_guard_resolves_ill_conditioned_systems():
    """Systems whose inverse-route residual exceeds 1e-12 are solved
    again directly (K1's plain version here): systems 0-2 of
    ``guard_systems`` (cond(A) = 1e10, b and e_out along the largest
    singular directions of A and A^T) fail the guard forward and adjoint;
    their answers then equal the direct solves of A and of A^T, the
    others stay within 1e-9 of them, and every residual is within
    1e-12."""
    A_re, A_im, b_re, b_im, e = guard_systems()
    x_re, x_im, z_re, z_im, ok_f, ok_a, n_resolved = tnoise._noise_core(
        A_re, A_im, b_re, b_im, e, "gj")
    assert n_resolved == 6 and ok_f.all() and ok_a.all()
    et = e.expand(b_re.shape)
    fr, fi, _ = linsolve.gj_solve_planes(A_re, A_im, b_re, b_im)
    ar, ai, _ = linsolve.gj_solve_planes(A_re.transpose(-1, -2),
                                         A_im.transpose(-1, -2), et,
                                         torch.zeros_like(et))
    for got, want in ((x_re, fr), (x_im, fi), (z_re, ar), (z_im, ai)):
        assert torch.equal(got[:3], want[:3])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-12)
    rel_f = tnoise._rel_residual(A_re, A_im, x_re, x_im, b_re, b_im, False)
    rel_a = tnoise._rel_residual(A_re, A_im, z_re, z_im, et,
                                 torch.zeros_like(et), True)
    assert (rel_f <= 1e-12).all() and (rel_a <= 1e-12).all()


def test_unported_noise_raises():
    # a B deck's .noise, refused before ROADMAP §1 item 2, matches the JAX
    # package (its gradient at the operating point shapes the transfer)
    net = NOISE_DECKS["resistor"].replace(
        ".noise", "b1 out 0 i=1m*v(in)\n.noise")
    _same_noise(st.simulate(net, dialect="extended", device="cpu").noise,
                sj.simulate(net, dialect="extended").noise)
    with pytest.raises(ValueError, match="Unknown source"):
        st.simulate("t\nv1 1 0 dc 1\nr1 1 0 1k\n.noise v(1) vx dec 5 1 10\n",
                    dialect="extended", device="cpu")
