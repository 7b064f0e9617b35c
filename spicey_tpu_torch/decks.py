"""The netlists of the port's workloads, each beside its source.

``chip_smoke.py``, ``tools/profile_torch_tran.py``,
``tools/profile_torch_op.py``, ``tools/profile_torch_k9.py`` and the
port's tests read them from here,
so that what is profiled on the card is what is
checked there and on the CPU. The decks are the JAX package's own bench
and test decks (``bench.py``, ``tests/test_pallas_fused.py``,
``tests/fixtures/netlists.py``), copied: the port imports nothing of the
JAX package or its tests. The small-signal decks at the end (the bench's
op/dc/tf deck, a two-stage BJT amplifier, an RC-ladder noise deck) are
the operating-point slice's; the K, T and B decks after them (a
transformer, a board trace, the uA741 macromodel, a tanh amplifier) are
``chip_smoke.py`` phase 23's, from ``tests/test_coupling.py``,
``tests/test_tline.py``, ``tests/fixtures/ua741.py``,
``tests/test_step.py`` and ``tests/test_bsource.py``. The post-analysis
decks at the very end (the uA741 amplifier with ``.pz``, ``.sens``,
``.four``, ``.meas`` and a ``.control`` block, and STEP_DECK with
``.meas`` lines) are ``chip_smoke.py`` phase 24's; the Schur boards and
the time-parallel RLC deck after them (``tests/test_schur.py``,
``tests/test_mc.py``) phase 25's.
"""

from __future__ import annotations

import numpy as np

# bench.py:579-586, the transient Monte-Carlo: an RC low-pass driven by a
# pulse, 201 points
TRAN_NET = ("TRAN bench\nV1 1 0 PULSE(0 5 0 1n 1n 5u 10u)\nR1 1 2 1k\n"
            "C1 2 0 1u\n.tran 0.1u 20u\n.end\n")

# K8's extended linear deck (chip_smoke.py phase 2, the card tests): an I,
# G, E, F and H source, a V source, R, C and L, N = 9
EXT_TRAN = """an extended linear transient
I1 0 a PULSE(0 1m 0 1u 1u 5u 10u)
R1 a 0 1k
G1 0 b a 0 2m
R2 b 0 500
E1 c 0 b 0 3
R3 c d 100
C1 d 0 1u
V1 e 0 PULSE(0 5 0 1n 1n 5u 10u)
R4 e d 200
F1 0 b V1 0.5
H1 f 0 V1 50
R5 f d 300
L1 d 0 10m
.tran 0.1u 20u
.end
"""

# bench.py:689-701, the switch_diode headline: the reference's boost
# converter (switch + diode), 101 points on a 1 ms grid
BOOST_NET = """a boost-converter bench (reference fixture)
.MODEL D D
.MODEL SWMOD SW
LL1 N1 N2 1
DD1 N2 N3 D
CC1 N3 0 10U
RR1 N3 0 1K
SM1 N2 0 N4 0 SWMOD
Vs0 N1 0 DC 5
Vs1 N4 0 PULSE(0 10 0 1n 1n 0.00068 0.001)
.tran 0.001 0.1 uic
"""

# the same converter on tests/fixtures/netlists.py DIODE_SWITCH's grid
# (.tran 10u 10m, 1001 points), where the switch opens and closes
BOOST_FINE = BOOST_NET.replace(".tran 0.001 0.1 uic", ".tran 0.00001 0.01")

# bench.py:646-656, the nonlinear_ring headline: a 3-stage CMOS ring
# oscillator, Newton to convergence, 101 points
RING_NET = """a ring-oscillator bench
.model mn nmos(vto=1 kp=2m)
.model mp pmos(vto=-1 kp=2m)
vdd vdd 0 5
mn1 n1 n3 0 mn
mp1 n1 n3 vdd mp
c1 n1 0 1n
mn2 n2 n1 0 mn
mp2 n2 n1 vdd mp
c2 n2 0 1n
mn3 n3 n2 0 mn
mp3 n3 n2 vdd mp
c3 n3 0 1n
ikick 0 n1 PULSE(0 2m 0 1n 1n 3u 1)
.tran 0.1u 10u
"""

# bench.py:453-474, the single-circuit latency decks
RING_DECK = ("a mosfet ring latency deck\n"
             ".model mn nmos(vto=1 kp=2m)\n.model mp pmos(vto=-1 kp=2m)\n"
             "vdd vdd 0 5\n"
             "mn1 n1 n3 0 mn\nmp1 n1 n3 vdd mp\nc1 n1 0 1n\n"
             "mn2 n2 n1 0 mn\nmp2 n2 n1 vdd mp\nc2 n2 0 1n\n"
             "mn3 n3 n2 0 mn\nmp3 n3 n2 vdd mp\nc3 n3 0 1n\n"
             "ikick 0 n1 PULSE(0 2m 0 1n 1n 3u 1)\n.tran 0.2u 30u\n.end\n")
BJT_AMP_DECK = ("a bjt amp latency deck\n.model qn npn(is=1e-16 bf=100)\n"
                "vcc vcc 0 5\nvin bs 0 SIN(0.7 0.005 100k)\nrc vcc c 1k\n"
                "q1 c bs 0 qn\n.tran 0.2u 20u\n.end\n")

# tests/test_pallas_fused.py:365-368, an NPN common-emitter amplifier
BJT_NET = ("a bjt ce amp\n.model qn npn(is=1e-15 bf=100)\n"
           "VCC vcc 0 5\nVIN in 0 PULSE(0.6 0.7 0 1u 1u 10u 20u)\n"
           "RB in b1 10k\nRC vcc c1 1k\nQ1 c1 b1 0 qn\nCL c1 0 1n\n"
           ".tran 0.2u 40u\n.end\n")

# tests/test_pallas_fused.py:454-458, the same amplifier with BJT
# junction charge (TF, CJE, CJC)
QC_NET = ("a bjt charge amp\n"
          ".model qn npn(is=1e-15 bf=100 tf=1n cje=2p cjc=1p)\n"
          "VCC vcc 0 5\nVIN in 0 PULSE(0.6 0.7 0 1u 1u 10u 20u)\n"
          "RB in b1 10k\nRC vcc c1 1k\nQ1 c1 b1 0 qn\n"
          ".tran 0.2u 40u\n.end\n")

# tests/test_pallas_fused.py:480-487, diode charge: reverse recovery (TT)
# and a varactor (CJO)
TT_NET = ("tt diode deck\n.model dchg d(is=1e-14 tt=10n)\n"
          "V1 1 0 PULSE(5 -5 0 1n 1n 50n 200n)\nR1 1 2 100\n"
          "D1 2 0 dchg\n.tran 4n 400n\n.end\n")
CJ_NET = ("a cjo varactor deck\n"
          ".model dv d(is=1e-14 cjo=10p vj=0.7 m=0.5)\n"
          "V1 1 0 SIN(0 2 1e6)\nR1 1 2 1k\nD1 2 0 dv\n"
          ".tran 10n 3u\n.end\n")

# tests/test_pallas_fused.py:432-435, a JFET common-source stage
JFET_NET = ("a jfet cs amp\n.model jm njf(vto=-2 beta=1e-4 lambda=0)\n"
            "VDD vdd 0 10\nVG g 0 PULSE(-2 0 0 1u 1u 10u 20u)\n"
            "RD vdd d1 10k\nJ1 d1 g 0 jm\nCL d1 0 1n\n"
            ".tran 1u 20u\n.end\n")

# BJT_NET mirrored to a PNP stage (the emitter at the 5 V rail), for the
# reflected frame of the PNP model
PNP_NET = ("a pnp ce amp\n.model qp pnp(is=1e-15 bf=80 br=2)\n"
           "VEE vee 0 5\nVIN in 0 PULSE(4.4 4.3 0 1u 1u 10u 20u)\n"
           "RB in b1 10k\nRC c1 0 1k\nQ1 c1 b1 vee qp\nCL c1 0 1n\n"
           ".tran 0.2u 20u\n.end\n")

# bench.py:434-444, the op/dc/tf interactive deck: a diode biased through
# 1k, its operating point, DC transfer curve and small-signal gain
OPDCTF_DECK = ("op bias bench deck\nV1 in 0 dc 5\nR1 in out 1k\n"
               "D1 out 0 DD\n.model DD d(is=1e-14)\n.op\n.dc V1 0 5 0.5\n"
               ".tf v(out) V1\n.end\n")

# the NMOS of tests/test_op.py:179 (kp=2m lambda=0.02) as a curve tracer:
# Vds 0-5 V in 10 mV steps x Vgs 0-5 V in 0.1 V steps, 501 x 51 = 25,551
# operating points in one 2D .dc
MOS_IV_DECK = ("a mosfet output characteristics deck\n"
               ".model mn nmos(vto=1 kp=2m lambda=0.02)\n"
               "vds d 0 1\nvgs gt 0 1\nm1 d gt 0 mn\n"
               ".dc vds 0 5 0.01 vgs 0 5 0.1\n.end\n")

# a two-stage common-emitter amplifier: divider bias, emitter degeneration
# with bypass capacitors, coupling capacitors, BJT junction charge (TF,
# CJE, CJC), N = 11; its bias, DC gain from the supply, op-linearized AC
# and noise from 1 Hz to 1 GHz (901 points)
AMP_DECK = """a two-stage bjt amplifier
.model qn npn(is=1e-15 bf=100 tf=0.3n cje=2p cjc=1p)
vcc vcc 0 dc 12
vin in 0 dc 0 ac 1
rs in s 1k
c1 s b1 10u
r1 vcc b1 47k
r2 b1 0 10k
rc1 vcc c1 4.7k
re1 e1 0 1k
ce1 e1 0 100u
q1 c1 b1 e1 qn
c2 c1 b2 10u
r3 vcc b2 47k
r4 b2 0 10k
rc2 vcc out 2.2k
re2 e2 0 470
ce2 e2 0 100u
q2 out b2 e2 qn
rl out 0 100k
.op
.tf v(out) vcc
.options acop
.ac dec 100 1 1g
.noise v(out) vin dec 100 1 1g
.end
"""


def ladder_noise_netlist(sections: int, per_decade: int = 100,
                         fstop: str = "1g") -> str:
    """The thermal noise at the far end of an RC interconnect: the ladder
    of ``chip_smoke.py``'s ladder-64 cell (``sections`` stages, R_i = 100
    + i ohm, 1 uF each, N = sections + 2) with a .noise sweep from 1 Hz."""
    lines = ["an rc ladder noise deck", "v1 in 0 dc 0 ac 1"]
    prev = "in"
    for i in range(1, sections + 1):
        lines.append(f"r{i} {prev} n{i} {100 + i}")
        lines.append(f"c{i} n{i} 0 1u")
        prev = f"n{i}"
    lines.append(f".noise v({prev}) v1 dec {per_decade} 1 {fstop}")
    lines.append(".end")
    return "\n".join(lines) + "\n"


# N = 64, 901 frequencies (dec 100, 1 Hz - 1 GHz)
LADDER_NOISE = ladder_noise_netlist(62)


def rc_ladder_netlist(sections: int, freqs: int = 51) -> str:
    """The RC ladder of ``chip_smoke.py``'s ladder-64 cell (``sections``
    stages, R_i = 100 + i ohm, 1 uF each, N = sections + 2) with an AC
    sweep of ``freqs`` points from 1 Hz to 10 kHz: an interconnect or
    filter whose every tap's response a designer wants. At 14 sections
    (N = 16) it is the fused tier's full width."""
    lines = ["* ladder bench", "v1 in 0 dc 0 ac 1"]
    prev = "in"
    for i in range(1, sections + 1):
        lines.append(f"r{i} {prev} n{i} {100 + i}")
        lines.append(f"c{i} n{i} 0 1u")
        prev = f"n{i}"
    lines.append(f".ac lin {freqs} 1 10k")
    lines.append(".end")
    return "\n".join(lines) + "\n"


# the first corner sweep of a filter design, in the form of
# tests/test_step.py's decks: an RLC low-pass with a load resistor (so its
# DC point is a divider, V(out) = 10 r2 / (r1 + r2)), its bias, AC at dec
# 50 from 1 Hz to 1 MHz (301 points) and a 200-step transient, with the
# source resistor stepped from 100 to 1100 ohm by 1 ohm: 1,001 lanes of
# each analysis
STEP_DECK = """* rlc step deck
v1 in 0 dc 10 ac 1
r1 in a 100
l1 a out 1m
c1 out 0 1u
r2 out 0 1k
.op
.ac dec 50 1 1meg
.tran 1u 200u
.step param r1 100 1100 1
"""


# ---- K, T and B elements (ROADMAP §1 item 2) ----------------------------

# tests/test_coupling.py:17: a 1:2 transformer (L1 1 H, L2 4 H, k 0.9)
# between a 10 ohm source and a 100 ohm load, five frequencies
TRANSFORMER_AC = """* transformer
v1 in 0 dc 0 ac 1
r1 in p 10
l1 p 0 1
l2 s 0 4
k1 l1 l2 0.9
rload s 0 100
.ac lin 5 1k 5k
.end
"""

# tests/test_coupling.py:62 with k1 0.9: the same transformer at 1 mH /
# 4 mH under a 1 kHz sine, 2 us steps; the run cut from 5 ms to 1 ms
TRANSFORMER_TRAN = """* transformer tran
v1 in 0 dc 0 ac 1 SIN(0 1 1k)
r1 in p 10
l1 p 0 1m
l2 s 0 4m
k1 l1 l2 0.9
rload s 0 100
.tran 2u 1m
.end
"""


def analytic_transformer(freqs: np.ndarray, L1: float = 1.0,
                         L2: float = 4.0, k: float = 0.9, Rs: float = 10.0,
                         Rl: float = 100.0) -> np.ndarray:
    """tests/test_coupling.py:29: the transformer's nodal solution in
    complex arithmetic, (F, [v(p), v(s)])."""
    M = k * np.sqrt(L1 * L2)
    out = []
    for f in freqs:
        w = 2 * np.pi * f
        Y = np.linalg.inv(1j * w * np.array([[L1, M], [M, L2]]))
        A = np.array([[1 / Rs + Y[0, 0], Y[0, 1]],
                      [Y[1, 0], Y[1, 1] + 1 / Rl]], complex)
        out.append(np.linalg.solve(A, np.array([1 / Rs, 0], complex)))
    return np.array(out)


# tests/test_tline.py:17 (MATCHED): a 50 ohm, 5 ns line between a matched
# source and load under a 1 V pulse; the pulse held for 1 us and the run
# 150 ns long (from 40 ns), so that with Z0 and Td swept no variant's
# reflections remain at its end (each round trip shrinks them by
# |Gs GL| <= 0.03) and late-time v(b) is the divider rl / (rs + rl)
TLINE_TRAN = """the matched line
v1 in 0 PULSE(0 1 0 1n 1n 1u 2u)
rs in a 50
t1 a 0 b 0 z0=50 td=5n
rl b 0 50
.tran 0.5n 150n
"""

# tests/test_tline.py:148: the matched line's AC, |v(b)/v(a)| = 1 and the
# phase -w Td
TLINE_AC = """the matched ac
v1 in 0 dc 0 ac 1
rs in a 50
t1 a 0 b 0 z0=50 td=5n
rl b 0 50
.ac lin 5 10meg 90meg
"""

# tests/fixtures/ua741.py: the uA741 Boyle macromodel (TI/PSpice lineage),
# unmodified: POLY(2)/POLY(5) sources (lowered to B sources), a BJT input
# pair, diode rail clamps, an H-source output limiter
UA741 = """.subckt ua741 1 2 3 4 5
c1 11 12 8.661E-12
c2 6 7 30.00E-12
dc 5 53 dx
de 54 5 dx
dlp 90 91 dx
dln 92 90 dx
dp 4 3 dx
egnd 99 0 poly(2) (3,0) (4,0) 0 .5 .5
fb 7 99 poly(5) vb vc ve vlp vln 0 10.61E6 -10E6 10E6 10E6 -10E6
ga 6 0 11 12 188.5E-6
gcm 0 6 10 99 5.961E-9
iee 10 4 dc 15.16E-6
hlim 90 0 vlim 1K
q1 11 2 13 qx
q2 12 1 14 qx
r2 6 9 100.0E3
rc1 3 11 5.305E3
rc2 3 12 5.305E3
re1 13 10 1.836E3
re2 14 10 1.836E3
ree 10 99 13.19E6
ro1 8 5 50
ro2 7 99 100
rp 3 4 18.16E3
vb 9 0 dc 0
vc 3 53 dc 1
ve 54 4 dc 1
vlim 7 8 dc 0
vlp 91 0 dc 40
vln 0 92 dc 40
.model dx D(Is=800.0E-18 Rs=1)
.model qx NPN(Is=800.0E-18 Bf=93.75)
.ends
"""

# tests/test_step.py:79: the uA741 as an inverting amplifier on +-15 V
# rails (rin 1k, rfb 10k, 50 mV in), the feedback resistor stepped from
# 5k to 20k by 15 ohm: 1,001 operating points, each -rfb/rin x 50 mV
UA741_STEP = UA741 + """
vcc vcc 0 dc 15
vee vee 0 dc -15
vin in 0 dc 0.05
rin in minus 1k
rfb minus out 10k
xamp 0 minus vcc vee out ua741
.op
.step param rfb 5k 20k 15
"""

# the same amplifier with an AC drive and a 20 mV, 10 kHz sine on its
# input: .op, acop .ac from 1 Hz to 10 MHz (tests/test_poly.py:178's
# sweep), .noise over the same band and a 50 us transient
UA741_AMP = UA741 + """
vcc vcc 0 dc 15
vee vee 0 dc -15
vin in 0 dc 0.05 ac 1 sin(0.05 0.02 10k)
rin in minus 1k
rfb minus out 10k
xamp 0 minus vcc vee out ua741
.options acop
.op
.ac dec 10 1 10meg
.noise v(out) vin dec 10 1 10meg
.tran 1u 50u
"""

# tests/test_bsource.py:47: a V-kind tanh amplifier, v(out) =
# 2 tanh(5 v(in)) under a 0.2 V, 1 kHz sine, into a 1k load
BSRC_TANH = """* bv
v1 in 0 SIN(0 0.2 1k)
rb in 0 1k
bamp out 0 V=2*tanh(5*v(in))
rl out 0 1k
.tran 10u 1m
.end
"""


# ---- the post-analyses (ROADMAP §1 items 8 and 13) ----------------------

# the uA741 amplifier's poles and zeros from its input to its output and
# the DC sensitivity of v(out) to every parameter, at the operating point
# the deck's .op shares (N = 36)
UA741_PZ_SENS = UA741_AMP + """.pz in 0 out 0 vol pz
.sens v(out)
"""

# its transient over two periods of the 10 kHz drive and the harmonics of
# v(out) over the last one: a 20 mV drive times a closed-loop gain of ~10
UA741_FOUR = (UA741_AMP.replace(".tran 1u 50u", ".tran 1u 200u")
              + ".four 10k v(out)\n")

# STEP_DECK's 1,001 lanes reduced to numbers: the peak, the rise time
# from 0.2 V to 1 V (every lane's peak is above 1.5 V) and the average
# over the last 50 us
STEP_MEAS = STEP_DECK + """.meas tran vmax max v(out)
.meas tran trise trig v(out)=0.2 rise=1 targ v(out)=1 rise=1
.meas tran vavg avg v(out) from=150u to=200u
"""

# every post-analysis in one deck, over one period of the drive (the
# least a .four 10k takes), and a .control tail that prints, computes, and
# writes the result as columns and as ngspice rawfiles (binary, then
# ASCII) relative to the run's base_dir
UA741_CONTROL = UA741_AMP.replace(".tran 1u 50u", ".tran 1u 100u") + """\
.four 10k v(out)
.pz in 0 out 0 vol pz
.sens v(out)
.meas tran vmax max v(out)
.meas tran tcross when v(out)=-0.5 fall=1
.control
echo ua741 post-analyses
print v(out) v(in)
let gain = v(out)/v(in)
let vpk = vecmax(v(out))
print vpk gain
wrdata ua741.dat v(out) v(in)
write ua741.raw
set filetype=ascii
write ua741_ascii.raw
.endc
"""


# tests/test_schur.py:_ladder_netlist: an RC low-pass chain of identical
# .subckt stages, each with ``inner`` internal nodes and a unity VCVS
# output buffer (one branch unknown per stage that couples interior to
# interface); ``stage_extra`` lines (a clamp diode) go inside the stage.
# The subcircuit structure makes the MNA matrix bordered block diagonal:
# the Schur tier's board (64 stages, inner 3: N = 322, 64 blocks of 4,
# an interface of 130; 256 stages: N = 1538, 256 blocks, 514).
def schur_ladder_netlist(n_stages: int, inner: int = 4,
                         analysis: str = ".ac dec 5 1 1e6",
                         source: str = "vsrc in 0 dc 1 ac 1",
                         stage_extra: tuple = ()) -> str:
    body = [source, analysis]
    sub = [".subckt stage a y"]
    prev = "a"
    for i in range(1, inner + 1):
        sub.append(f"r{i} {prev} m{i} 1k")
        sub.append(f"c{i} m{i} 0 1n")
        prev = f"m{i}"
    sub.extend(stage_extra)
    sub.append(f"ebuf y 0 {prev} 0 1")
    sub.append(".ends")
    lines = ["* schur ladder fixture"] + sub + body
    prev = "in"
    for s in range(1, n_stages + 1):
        lines.append(f"x{s} {prev} o{s} stage")
        prev = f"o{s}"
    lines.append(f"rload {prev} 0 10k")
    lines.append(".end")
    return "\n".join(lines)


# tests/test_schur.py:_TRAN_KW and the clamp diode of its nonlinear
# transient: every stage's m2 clamped to ground, a 5 V pulse, 50 steps
SCHUR_TRAN_KW = dict(analysis=".tran 1u 50u",
                     source="vsrc in 0 PULSE(0 5 0 1n 1n 50u 100u)")
SCHUR_CLAMP = (".model dd d(is=1e-14)", "dcl m2 0 dd")

# tests/test_mc.py:343, the linear RLC Monte-Carlo of the time-parallel
# core (a VCCS included); ``tp_rlc_netlist(tstop)`` runs it to ``tstop``
# at its 0.2 us step (30u: 150 steps; 20m: 100,000)
def tp_rlc_netlist(tstop: str = "30u") -> str:
    return ("x rlc mc\n"
            "V1 in 0 PULSE(0 5 0 1n 1n 5u 10u)\n"
            "R1 in a 100\n"
            "L1 a b 1m\n"
            "C1 b 0 1u\n"
            "R2 b 0 2k\n"
            "g1 0 b in 0 0.1m\n"
            f".tran 0.2u {tstop}\n"
            ".end\n")
