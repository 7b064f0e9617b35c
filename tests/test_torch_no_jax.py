"""The port runs where jax is absent, as on the GPU machine.

A subprocess blocks ``import jax`` and reproduces the basics01 golden
through ``spicey_tpu_torch``, runs the boost-converter transient, a
small transient Monte-Carlo on both routes (the batched loop and the
fused tier's plain versions, linear and nonlinear), the MOSFET ring
through ``simulate``, a small ring Monte-Carlo, the bench's op/dc/tf deck,
the two-stage amplifier's .op/.tf/.ac/.noise, an ``op_batch``, a
``simulate_ac_batch`` through the fused full-solution route, a
``.step`` deck, the panel-blocked solves of ``ops/mxu.py``, and a K deck
(the transformer's .ac against its closed form, a k1 sweep), a T deck
(a line's port currents, a Td sweep) and a B deck (the tanh amplifier's
transient and its f32 ``method="pallas"`` Monte-Carlo), a deck with
``.pz``, ``.sens``, ``.four``, ``.meas`` and a ``.control`` block that
writes a rawfile, the CLI (``__main__.main([..., "--cpu"])``), a
transient sensitivity of the boost converter, an adaptive RC
transient and an ``mc_ac_stats`` over a mesh of repeated CPU devices
(``make_mesh``, ``sharder``; and ``make_mesh()`` raising with no card); an
AST scan asserts that no module of the port, ``parallel/`` included,
imports jax or the JAX package.
"""

import ast
import os
import pathlib
import subprocess
import sys

from spicey_tpu_torch import decks
from tests.fixtures import netlists

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "spicey_tpu_torch"

_SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["spicey_tpu"] = None
import numpy as np
import spicey_tpu_torch as st
deck = open(sys.argv[1]).read()
golden = open(sys.argv[2]).read()
out = st.format_ac_result(st.simulate(deck, device="cpu").ac)
stats = st.mc_ac_stats(deck, {"r1": [30.0, 33.0]}, node="2",
                       method="pallas", precision="f32", device="cpu")
assert out == golden, "golden mismatch"
assert stats.n_valid == 2
tran = st.simulate(open(sys.argv[3]).read(), device="cpu").tran
assert st.format_tran_result(tran).startswith("t(s), N1:V, N3:V")
assert len(tran.times) == 101 and "DD1" in tran.element_currents
rc = open(sys.argv[4]).read()
for method, precision in (("gj", "f64"), ("pallas", "f32")):
    ts = st.mc_tran_stats(rc, {"R1": [1e3, 1.1e3, 1.2e3]}, node="2",
                          method=method, precision=precision, device="cpu")
    assert ts.n_valid == 3 and ts.mean.shape == (201,)
ring = open(sys.argv[5]).read()
tran = st.simulate(ring, dialect="extended", device="cpu").tran
assert len(tran.times) == 51 and "mn1" in tran.element_currents
for method, precision in (("gj", "f64"), ("pallas", "f32")):
    ts = st.mc_tran_stats(ring, {"c1": [1e-9, 1.05e-9], "mn1": [2e-3, 2.1e-3]},
                          node="n1", method=method, precision=precision,
                          dialect="extended", device="cpu")
    assert ts.n_valid == 2 and ts.mean.shape == (51,)
bs = st.mc_tran_stats(open(sys.argv[3]).read(), {"RR1": [1e3, 1.05e3]},
                      node="N3", method="pallas", precision="f32",
                      device="cpu")
assert bs.n_valid == 2
from spicey_tpu_torch import decks
r = st.simulate(decks.OPDCTF_DECK, dialect="extended", device="cpu")
assert r.op is not None and r.dc.valid.all() and r.tf is not None
amp = st.simulate(decks.AMP_DECK, dialect="extended", device="cpu")
assert amp.noise.output_psd.shape == (901,) and amp.ac is not None
assert st.format_noise_result(amp.noise).startswith("Noise analysis at")
ob = st.op_batch(decks.BJT_NET, {"Q1": [1e-15, 1.1e-15], "VIN": [0.65, 0.65]},
                 dialect="extended", device="cpu")
assert ob.valid.all()
ab = st.simulate_ac_batch(decks.rc_ladder_netlist(14, 3),
                          {"r1": [115.0, 120.0]}, method="pallas",
                          device="cpu")
assert ab.x.shape == (2, 3, 16) and ab.valid.all()
step = st.simulate(decks.STEP_DECK.replace("100 1100 1", "100 1100 500"),
                   dialect="extended", device="cpu").step
assert step.ac.x.shape == (3, 301, 4) and step.tran.valid.all()
assert step.op.valid.all() and step.tran.xs.shape[:2] == (3, 201)
import torch
from spicey_tpu_torch.ops import mxu
A = torch.eye(40, dtype=torch.float64).expand(2, 40, 40) * 2.0
x, v = mxu.mxu_solve_real(A, torch.ones((2, 40), dtype=torch.float64))
assert v.all() and torch.allclose(x, torch.full((2, 40), 0.5, dtype=x.dtype))
xr, xi, v = mxu.mxu_solve_complex(A, A, torch.ones((2, 40)).double(),
                                  torch.zeros((2, 40)).double())
assert v.all() and torch.allclose(xr, -xi) and torch.allclose(xr, 0.25 + 0 * xr)
ext = dict(dialect="extended", device="cpu")
k = st.simulate(decks.TRANSFORMER_AC, **ext).ac
ref = decks.analytic_transformer(k.freqs)
assert abs(k.node_voltages["s"] - ref[:, 1]).max() < 1e-9
assert "l2" in k.element_currents
kt = st.simulate_tran_batch(
    decks.TRANSFORMER_TRAN.replace(".tran 2u 1m", ".tran 2u 0.1m"),
    {"k1": [0.5, 0.9]}, **ext)
assert kt.valid.all() and kt.xs.shape[0] == 2
line = decks.TLINE_TRAN.replace(".tran 0.5n 150n", ".tran 0.5n 20n")
tl = st.simulate(line, **ext).tran
assert "t1#p2" in tl.element_currents
tb = st.simulate_tran_batch(line, {"t1.td": [4e-9, 6e-9]}, **ext)
assert tb.valid.all()
bv = decks.BSRC_TANH.replace(".tran 10u 1m", ".tran 10u 0.1m")
b = st.simulate(bv, **ext).tran
vin, vout = b.node_voltages["in"], b.node_voltages["out"]
assert abs(vout - 2 * np.tanh(5 * vin)).max() < 1e-12
bm = st.mc_tran_stats(bv, {"rl": [900.0, 1100.0]}, node="out",
                      method="pallas", precision="f32", **ext)
assert bm.n_valid == 2
post = ("the post analyses\n.model mn nmos(vto=1 kp=2m)\nvdd vdd 0 5\n"
        "vg g 0 dc 2 ac 1 sin(2 0.1 1k)\nrd vdd d 1k\nm1 d g 0 mn\n"
        "cgd g d 1p\n.pz g 0 d 0 vol pz\n.sens v(d)\n.tran 10u 2m\n"
        ".four 1k v(d)\n.meas tran vmax max v(d)\n.control\n"
        "let gain = v(d)/v(g)\nprint vmax\nwrdata post.dat v(d)\n"
        "write post.raw\n.endc\n")
pr = st.simulate(post, **ext)
assert abs(pr.pz.zeros[0] - 2e9) < 1e-3 and pr.pz.poles.size == 1
assert pr.sens.values["m1:vto"] > 0 and pr.four.probes["d"].thd_percent > 0
assert pr.meas["vmax"] > 3
assert pr.control_output == "print: no such vector vmax"
assert st.read_rawfile(open("post.raw", "rb").read())[0][0] == \
    "Transient Analysis"
open("post.cir", "w").write(post)
from spicey_tpu_torch.__main__ import main
assert main(["post.cir", "--cpu", "--quiet", "--raw", "cli.raw"]) == 0
assert [p for p, _ in st.read_rawfile(open("cli.raw", "rb").read())] == [
    "Transient Analysis"]
sens = st.sensitivity_tran(st.parse_netlist(open(sys.argv[3]).read()), "N3",
                           ["RR1", "CC1"], device="cpu")
assert sens["RR1"].shape == (101,) and np.isfinite(sens["CC1"]).all()
ad = st.simulate_tran_adaptive(st.parse_netlist(
    "t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 1u\n.tran 10u 10m\n"), rtol=1e-3,
    device="cpu")
assert not ad.exhausted and ad.times[-1] == 10e-3
put = st.sharder(st.make_mesh({"batch": 4}, devices=["cpu"] * 4))
ms = st.mc_ac_stats(deck, {"r1": [30.0, 31.0, 32.0, 33.0, 34.0]}, node="2",
                    device_put=put)
one = st.mc_ac_stats(deck, {"r1": [30.0, 31.0, 32.0, 33.0, 34.0]}, node="2",
                     device="cpu")
assert ms.n_valid == 5 and np.allclose(ms.mean, one.mean, rtol=1e-13)
if not torch.cuda.is_available():
    try:
        st.make_mesh()
    except RuntimeError:
        pass
    else:
        raise AssertionError("make_mesh() fell back to the CPU")
print("OK")
"""

BASICS01 = """Demo of a simple AC circuit
v1 1 0 dc 0 ac 1
r1 1 2 30
c1 2 0 100u
.ac dec 100 1 100
.end
"""

RING = decks.RING_NET.replace(".tran 0.1u 10u", ".tran 0.1u 5u")


def test_port_runs_with_jax_blocked(tmp_path, fixtures_dir):
    deck = tmp_path / "basics01.cir"
    deck.write_text(BASICS01)
    boost = tmp_path / "boost.cir"
    boost.write_text(netlists.BOOST_CONVERTER)
    rc = tmp_path / "rc.cir"
    rc.write_text(netlists.RC_PULSE)
    ring = tmp_path / "ring.cir"
    ring.write_text(RING)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(deck),
         os.path.join(fixtures_dir, "basics01_golden.txt"), str(boost),
         str(rc), str(ring)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15 and PORT / "parallel" / "mesh.py" in files
    for path in files:
        for name in _imports(ast.parse(path.read_text(), str(path))):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "spicey_tpu"), (path, name)
