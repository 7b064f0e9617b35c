"""The port's .control scripts, ngspice rawfile and CLI against the JAX
package on the CPU.

Every deck of tests/test_control.py, tests/test_rawfile.py and
tests/test_cli.py goes through both packages from the same netlist:
``control_output`` string-equal, the files a block writes (wrdata columns
at rtol 1e-9 with an atol of 1e-12 of the column's largest |value|; the
rawfile's header lines but the date string-equal and its vectors at the
same rule),
``format_rawfile`` at a fixed date string-equal in its headers and bit
for bit through ``read_rawfile`` of its binary form, and the CLI's
standard output (``python -m spicey_tpu_torch ... --cpu``, in process and
as a subprocess with jax blocked) string-equal to ``python -m
spicey_tpu``'s. Without ``--cpu`` and without a card the CLI raises.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spicey_tpu as sj
import spicey_tpu_torch as st
from spicey_tpu.__main__ import main as jax_main
from spicey_tpu_torch import decks
from spicey_tpu_torch.__main__ import main

RTOL, ATOL = 1e-9, 1e-12
EXT = dict(dialect="extended")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RC_BODY = """v1 1 0 dc 5 ac 1 pulse(0 5 0 1u 1u 1m 2m)
r1 1 2 1k
c1 2 0 1u
"""


def _deck(control: str, body: str = RC_BODY, cards: str = "") -> str:
    return (f"* control test deck\n{body}{cards}"
            f".control\n{control}\n.endc\n.end\n")


# tests/test_control.py's decks; the file names a block writes are the
# same in both packages' runs (each run writes into its own directory)
CONTROL_DECKS = {
    "analysis_commands": _deck("run\nac dec 2 1 100\ntran 0.1m 1m"),
    "command_wins": _deck("ac lin 5 10 1000", cards=".ac dec 2 1 100\n"),
    "echo_print_quit": _deck(
        "op\necho hello world\nprint v(2)\nquit\necho nope"),
    "print_tables": _deck("ac dec 2 1 100\ntran 0.1m 1m\n"
                          "print v(2) vm(2) i(v1)"),
    "print_all_missing": _deck("op\nprint all\nprint v(nosuch)"),
    "write_binary": _deck("ac dec 2 1 100\nwrite out.raw"),
    "write_ascii": _deck("ac dec 2 1 100\nset filetype=ascii\nwrite a.raw"),
    "wrdata_tran": _deck("tran 0.1m 1m\nwrdata out.dat v(2)"),
    "wrdata_ac": _deck("ac dec 2 1 100\nwrdata ac.dat v(2)"),
    "meas_command": _deck("tran 0.1m 1m\nmeas tran vmax max v(2)"),
    "write_op": _deck("op\nwrite op.raw"),
    "let_expressions": _deck("ac dec 2 1 100\nlet gain = v(2)/v(1)\n"
                             "let gdb = db(gain)\nlet flat = 2k*1m\n"
                             "print gdb flat"),
    "let_reductions": _deck("tran 0.1m 1m\nlet vr = rms(v(2))\n"
                            "let vm2 = vecmax(v(2)) - vecmin(v(2))\n"
                            "print vr vm2"),
    "let_errors": _deck("op\nlet bad = v(nosuch)+1\nlet 1x = 2\n"
                        "let ok = 3*2\nprint ok"),
    "let_wrdata": _deck("tran 0.1m 1m\nlet p = v(2)*i(v1)\nwrdata p.dat p"),
    "alter": _deck("alter r1 2k\nalter v1 = 10\nop\nprint v(2)"),
    "alter_divider": ("* alter divider\nv1 1 0 dc 6\nr1 1 2 1k\nr2 2 0 1k\n"
                      ".control\nalter r2 3k\nop\nprint v(2)\n.endc\n"
                      ".end\n"),
    "let_scalar_errors": _deck(
        "op\nlet a = 1/0\nlet b = 9e99**9e99\nprint v(2)"),
    "write_bad_path": _deck("op\nwrite /nonexistent_dir_xyz/out.raw\n"
                            "echo still here"),
    "wrdata_bad_path": _deck("op\nwrdata /nonexistent_dir_xyz/o.dat v(2)\n"
                             "echo after"),
    "scalar_then_vector": _deck("ac dec 2 1 100\nlet s = mean(vm(2))\n"
                                "print s vm(2)"),
    "wrdata_mixed_lengths": _deck("ac dec 2 1 100\ntran 0.1m 1m\n"
                                  "wrdata mix.dat v(2) vm(2)"),
    "comment_marker": _deck("op\necho ab;cd $ tail comment"),
    "ua741": decks.UA741_CONTROL,
}

RAW_DECK = """Demo of a simple AC circuit
v1 1 0 dc 0 ac 1 PULSE(0 5 1u 1n 1n 5u 20u)
r1 1 2 30
c1 2 0 100u
.ac dec 10 1 100
.tran 1u 20u
.end
"""

DIVIDER = """the divider
v1 in 0 dc 10
r1 in out 6k
r2 out 0 4k
.op
.dc v1 0 10 2
"""


def same_series(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def same_rawfile(got: bytes, want: bytes):
    """Header lines string-equal; every vector of every plot at the
    parity rule, the atol of a plot's voltages (with its axis) and of its
    branch currents each from its own field."""
    def header(data):  # a file a .control block writes has today's date
        return [ln for ln in data.decode("latin-1").splitlines()
                if (not ln.startswith("\t") or ln.count("\t") > 1)
                and not ln.startswith("Date: ")]

    if b"Binary:" not in want:
        assert header(got) == header(want)
    gp, wp = st.read_rawfile(got), sj.read_rawfile(want)
    assert [p for p, _ in gp] == [p for p, _ in wp]
    for (plot, gs), (_, ws) in zip(gp, wp):
        assert list(gs) == list(ws)
        for field in (False, True):  # voltages (and the axis), currents
            names = [n for n in ws if n.endswith("#branch") == field]
            if not names:
                continue
            scale = max(float(np.abs(ws[n]).max()) for n in names)
            for name in names:
                np.testing.assert_allclose(
                    gs[name], ws[name], rtol=RTOL, atol=ATOL * scale,
                    err_msg=f"{plot} {name}")


@pytest.mark.parametrize("deck", sorted(CONTROL_DECKS))
def test_control_matches_jax(deck, tmp_path):
    net = CONTROL_DECKS[deck]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    want = sj.simulate(net, base_dir=str(jdir), **EXT)
    got = st.simulate(net, base_dir=str(tdir), device="cpu", **EXT)
    assert got.circuit.control == want.circuit.control
    assert got.control_output == want.control_output
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        g, w = (tdir / name).read_bytes(), (jdir / name).read_bytes()
        if name.endswith(".raw"):
            same_rawfile(g, w)
        else:
            same_series(np.loadtxt(io.BytesIO(g)), np.loadtxt(io.BytesIO(w)),
                        name)


def test_control_parse_matches_jax():
    """What the parser folds away, skips or refuses, as the JAX package."""
    for net in (_deck("op\nfourier 1k v(2)\nplot v(2)"),
                _deck("* a comment\nlisting\nrun\nversion\n"
                      "print v(2) $ trailing"),
                _deck("alter rX 2k\nalter @r1[resistance]=2k\nalter r1\nop")):
        got, want = st.parse_netlist(net, **EXT), sj.parse_netlist(net, **EXT)
        assert (got.control, got.skipped, got.op) == (
            want.control, want.skipped, want.op)
    for bad, kw in (("* t\nr1 1 0 1k\n.control\nrun\n.end\n", EXT),
                    ("* t\nv1 1 0 dc 1\nr1 1 0 1k\n.control\nrun\n.endc\n"
                     ".ac dec 2 1 100\n.end\n", dict(dialect="spicey"))):
        with pytest.raises(ValueError) as jax_err:
            sj.parse_netlist(bad, **kw)
        with pytest.raises(ValueError) as port_err:
            st.parse_netlist(bad, **kw)
        assert str(port_err.value) == str(jax_err.value)


def test_control_fuzz_matches_jax(tmp_path):
    """tests/test_control.py's execution fuzz (seed 11): every block gives
    the JAX package's output text or its ValueError."""
    import random

    rng = random.Random(11)
    words = ["print", "v(2)", "let", "x", "=", "echo", "hi", "set",
             "filetype=ascii", "write", "o.raw", "wrdata", "o.dat",
             "all", "i(v1)", "db(v(2))", "x+1", "rms(v(2))", "1/0"]
    for k in range(25):
        block = "\n".join(
            " ".join(rng.choices(words, k=rng.randint(1, 4)))
            for _ in range(rng.randint(1, 5)))
        net = (f"* fuzz exec\nv1 1 0 dc 1\nr1 1 2 1k\nr2 2 0 1k\n"
               f".control\nop\n{block}\n.endc\n.end\n")
        outs = []
        for pkg, kw in ((sj, {}), (st, dict(device="cpu"))):
            d = tmp_path / f"{pkg.__name__}{k}"
            d.mkdir()
            try:
                outs.append(pkg.simulate(net, base_dir=str(d), **EXT,
                                         **kw).control_output)
            except ValueError as err:
                outs.append(f"ValueError: {err}")
        assert outs[0] == outs[1], block


@pytest.mark.parametrize("ascii_values", [True, False])
def test_rawfile_matches_jax(ascii_values):
    """tests/test_rawfile.py's decks: the same bytes' headers, vectors at
    the parity rule, and the binary form read back bit for bit."""
    for net, kw in ((RAW_DECK, {}), (DIVIDER, EXT)):
        want = sj.simulate(net, **kw)
        got = st.simulate(net, device="cpu", **kw)
        gb = st.format_rawfile(got, date="today", ascii_values=ascii_values)
        wb = sj.format_rawfile(want, date="today",
                               ascii_values=ascii_values)
        same_rawfile(gb, wb)
        if not ascii_values:
            for plot, series in st.read_rawfile(gb):
                res = {"AC Analysis": got.ac,
                       "Transient Analysis": got.tran}.get(plot)
                if res is None:
                    continue
                axis = res.freqs if plot == "AC Analysis" else res.times
                np.testing.assert_array_equal(
                    np.asarray(series[list(series)[0]]).real, axis)
                for node, v in res.node_voltages.items():
                    np.testing.assert_array_equal(series[f"v({node})"], v)
    text = st.format_rawfile(st.simulate(RAW_DECK, device="cpu"),
                             date="today").decode()
    assert text.startswith("Title: spicey_tpu\n")
    assert "\t0\tfrequency\tfrequency\tgrid=3\n" in text
    assert "\tv1#branch\tcurrent\n" in text


CLI_DECKS = {
    "control": """* cli control deck
v1 1 0 dc 6
r1 1 2 1k
r2 2 0 2k
.control
op
echo from-control
print v(2)
.endc
.end
""",
    "raw": ("* raw deck\nv1 1 0 dc 0 ac 1\nr1 1 2 30\n"
            "c1 2 0 100u\n.ac dec 2 1 100\n.end\n"),
    "rawfile_deck": RAW_DECK,
    # tests/test_pz.py's Miller stage with a sine on its gate, and a .sens,
    # .four and .meas (the uA741's tables hold rounding-level entries that
    # print differently, ROADMAP §3)
    "post_analyses": """the post analyses
.model mn nmos(vto=1 kp=2m)
vdd vdd 0 5
vg g 0 dc 2 ac 1 sin(2 0.1 1k)
rd vdd d 1k
m1 d g 0 mn
cgd g d 1p
.pz g 0 d 0 vol pz
.sens v(d)
.tran 10u 2m
.four 1k v(d)
.meas tran vmax max v(d)
""",
}


def _cli(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("deck", sorted(CLI_DECKS))
def test_cli_matches_jax(deck, tmp_path):
    path = tmp_path / "d.cir"
    path.write_text(CLI_DECKS[deck])
    got = _cli(main, [str(path), "--cpu"])
    want = _cli(jax_main, [str(path), "--cpu"])
    assert got == want


def test_cli_reference_dialect_and_rawfile(tmp_path, monkeypatch):
    """tests/test_cli.py's stdin run in the reference dialect, the
    rawfile-only run and a .control wrdata beside the deck."""
    ref = ("Demo of a simple AC circuit\nv1 1 0 dc 0 ac 1\nr1 1 2 30\n"
           "c1 2 0 100u\n.ac dec 2 1 100\n.end\n")
    outs = []
    for fn in (main, jax_main):
        monkeypatch.setattr(sys, "stdin", io.StringIO(ref))
        outs.append(_cli(fn, ["-", "--cpu", "--dialect", "spicey"]))
    assert outs[0] == outs[1] and "0.468650,-62.0533" in outs[0]
    deck = tmp_path / "d.cir"
    deck.write_text(CLI_DECKS["raw"])
    raw = tmp_path / "out.raw"
    assert _cli(main, [str(deck), "--cpu", "--quiet", "--raw",
                       str(raw)]) == ""
    plots = st.read_rawfile(raw.read_bytes())
    assert plots and "AC" in plots[0][0]
    assert len(plots[0][1]["frequency"]) == 5
    nested = tmp_path / "nested.cir"
    nested.write_text("* wrdata deck\nv1 1 0 dc 5\nr1 1 2 1k\nr2 2 0 1k\n"
                      ".control\nop\nwrdata o.dat v(2)\n.endc\n.end\n")
    assert _cli(main, [str(nested), "--cpu", "--quiet"]) == ""
    data = np.loadtxt(tmp_path / "o.dat")
    assert data.shape == (2,) and abs(data[1] - 2.5) < 1e-9


def test_cli_subprocess_with_jax_blocked(tmp_path):
    """``python -m spicey_tpu_torch`` as a subprocess where jax cannot be
    imported: a binary rawfile that reads back, the JAX CLI's standard
    output."""
    blocker = tmp_path / "block"
    (blocker / "jax").mkdir(parents=True)
    (blocker / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is blocked')\n")
    deck = tmp_path / "deck.cir"
    deck.write_text(RAW_DECK)
    raw = tmp_path / "out.raw"
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(blocker), REPO]))
    proc = subprocess.run(
        [sys.executable, "-m", "spicey_tpu_torch", str(deck), "--cpu",
         "--raw", str(raw), "--binary"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _cli(jax_main, [str(deck), "--cpu"])
    plots = st.read_rawfile(raw.read_bytes())
    assert [p for p, _ in plots] == ["AC Analysis", "Transient Analysis"]


def test_cli_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI runs there")
    deck = tmp_path / "d.cir"
    deck.write_text(CLI_DECKS["raw"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([str(deck), "--quiet"])
