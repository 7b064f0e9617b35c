"""SPICE-dialect netlist parser -> ParsedCircuit IR.

Contract: spicey/lib/parsing/parseNetlist.ts:109-498. Every dialect
rule below carries the reference file:line it mirrors. The output IR differs
from the reference in one deliberate way: it is *immutable* — transient state
(vPrev/iPrev/vdPrev/isOn) lives in the analysis engines' scan carries, not on
IR objects (the reference mutates its IR in place, simulateTRAN.ts:221-237).

Dialect summary:
  - tokenizer keeps quoted strings, NAME(args) calls, bare (...) groups, and
    whitespace-split words as single tokens           (parseNetlist.ts:109-115)
  - '*' comment lines; '.end' stops; '//' and ';' inline comments; first
    non-element non-directive line is the title       (parseNetlist.ts:141-161)
  - directives: .ac dec|lin, .tran (extra tokens ignored), .print tran v(...),
    .model vswitch|sw|d                               (parseNetlist.ts:163-289)
  - elements: R/C/L/V (dc, ac [phase], PULSE, PWL), S (vswitch), D (4-token
    form only); everything else lands in `skipped`    (parseNetlist.ts:291-446)
  - post-pass: V-source branch index = nNodes + i; model refs resolved with
    errors on unknown models                          (parseNetlist.ts:455-479)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .node_index import NodeIndex
from .numbers import parse_number_with_units
from .waveforms import (
    AmWaveform,
    ExpWaveform,
    PulseWaveform,
    PwlWaveform,
    SffmWaveform,
    SinWaveform,
    Waveform,
    parse_am_args,
    parse_exp_args,
    parse_pulse_args,
    parse_pwl_args,
    parse_sffm_args,
    parse_sin_args,
)

_TOKEN_RE = re.compile(r'"[^"]*"|\w+\s*\([^)]*\)|\([^()]*\)|\S+')
_ELEMENT_OR_TITLE_RE = re.compile(r"^[rclvgsmiqd]\w*$", re.IGNORECASE)
# extended dialect adds E (VCVS) lines, which the reference title rule does
# not know about (parseNetlist.ts:158-161 regex lacks "e"), and allows dots
# in element names (subcircuit flattening emits "r1.x1"-style names). X
# instance lines are consumed by _flatten_subcircuits before this regex ever
# sees them.
_ELEMENT_OR_TITLE_EXT_RE = re.compile(r"^[rclvgsmiqdefhkwbjuz][\w.]*$",
                                      re.IGNORECASE)
# "t" is deliberately NOT in the title-leader set: titles beginning with
# "the/test/transient..." are ubiquitous and SPICE decks always carry a
# title line, so a T element on the very first line of an untitled netlist
# is swallowed as the title (documented quirk); anywhere else it parses.
# \b keeps ".ends" from matching (".end" terminates parsing, ".ends" closes
# a .subckt block)
_END_RE = re.compile(r"^\s*\.end\b", re.IGNORECASE)
_SUBCKT_RE = re.compile(r"^\.subckt\b", re.IGNORECASE)
_ENDS_RE = re.compile(r"^\.ends\b", re.IGNORECASE)
_X_NAME_RE = re.compile(r"^x\w*$", re.IGNORECASE)
_PROBE_RE = re.compile(r"^v\(([^)]+)\)$", re.IGNORECASE)
_IPROBE_RE = re.compile(r"^i\(([^)]+)\)$", re.IGNORECASE)
_POLY_RE = re.compile(r"^poly\s*\(\s*(\d+)\s*\)$", re.IGNORECASE)
_PAREN_GROUP_RE = re.compile(r"^\(.*\)$")
_ASSIGN_SPLIT_RE = re.compile(r"[\s,]+")


def smart_tokens(line: str) -> list[str]:
    return _TOKEN_RE.findall(line)


def _require(tokens: list[str], index: int, context: str) -> str:
    if index >= len(tokens) or tokens[index] is None:
        raise ValueError(context)
    return tokens[index]


@dataclass
class Resistor:
    name: str
    n1: int
    n2: int
    R: float
    # extended-dialect temperature coefficients (ngspice):
    # R(T) = R * (1 + tc1*(T - 300) + tc2*(T - 300)^2), applied with .temp
    tc1: float = 0.0
    tc2: float = 0.0


@dataclass
class Capacitor:
    name: str
    n1: int
    n2: int
    C: float
    # extended element-level initial condition (``ic=v0``): seeds the
    # transient companion state like a per-element .ic
    ic: float | None = None


@dataclass
class Inductor:
    name: str
    n1: int
    n2: int
    L: float
    # extended element-level initial condition (``ic=i0``): initial
    # inductor current for the transient companion
    ic: float | None = None


@dataclass
class VoltageSource:
    name: str
    n1: int
    n2: int
    dc: float = 0.0
    ac_mag: float = 0.0
    ac_phase_deg: float = 0.0
    waveform: Waveform | None = None
    index: int = -1  # MNA branch-unknown index, assigned in post-pass


@dataclass
class CurrentSource:
    """Extended-dialect independent current source (I element).

    NOT in the reference dialect — parseNetlist.ts:444-446 drops I lines
    into `skipped`. Enabled via parse_netlist(..., dialect="extended").
    Convention: a positive value drives current from n1 through the source
    to n2 (i.e. out of node n1's KCL, into n2's).
    """

    name: str
    n1: int
    n2: int
    dc: float = 0.0
    ac_mag: float = 0.0
    ac_phase_deg: float = 0.0
    waveform: Waveform | None = None


@dataclass
class VCCS:
    """Extended-dialect voltage-controlled current source (G element).

    NOT in the reference dialect — parseNetlist.ts:444-446 drops G lines
    into `skipped`. ``G name n+ n- nc+ nc- gm``: drives gm*(v(nc+)-v(nc-))
    amps out of n+'s KCL into n-'s.
    """

    name: str
    n1: int
    n2: int
    nc_pos: int
    nc_neg: int
    gm: float


@dataclass
class VCVS:
    """Extended-dialect voltage-controlled voltage source (E element).

    ``E name n+ n- nc+ nc- gain``: enforces
    v(n+) - v(n-) = gain * (v(nc+) - v(nc-)) via an extra MNA branch
    unknown (its current), allocated after the V-source branches.
    """

    name: str
    n1: int
    n2: int
    nc_pos: int
    nc_neg: int
    gain: float
    index: int = -1  # MNA branch-unknown index, assigned in post-pass


@dataclass
class CCCS:
    """Extended-dialect current-controlled current source (F element).

    ``F name n+ n- vname gain``: drives gain * i(vname) from n+ through the
    source to n-, where vname is a V source whose branch current is already
    an MNA unknown.
    """

    name: str
    n1: int
    n2: int
    ctrl_name: str
    gain: float
    ctrl_index: int = -1  # controlling V branch index, post-pass


@dataclass
class CCVS:
    """Extended-dialect current-controlled voltage source (H element).

    ``H name n+ n- vname r``: enforces v(n+) - v(n-) = r * i(vname) via an
    extra MNA branch unknown (allocated after the E-source branches).
    """

    name: str
    n1: int
    n2: int
    ctrl_name: str
    r: float
    ctrl_index: int = -1
    index: int = -1


@dataclass
class URCModel:
    """Extended-dialect uniform distributed RC line model
    (.model <name> URC(k rperl cperl [fmax])). ``isperl``/``rsperl``
    (per-length diodes) are not supported and raise."""

    name: str
    K: float = 2.0        # lump-length geometric ratio (toward the middle)
    Rperl: float = 1000.0  # ohms per meter
    Cperl: float = 1e-15   # farads per meter
    Fmax: float = 1e9      # used to size the default lump count


@dataclass
class VSwitchModel:
    name: str
    Ron: float = 1.0
    Roff: float = 1e12
    Von: float = 0.0
    Voff: float = 0.0


@dataclass
class CSwitchModel:
    """Current-controlled switch model (.model <name> CSW|ISWITCH).

    ngspice CSW semantics: switch closes when the controlling current rises
    above It + Ih and opens when it falls below It - Ih (hysteresis window
    centered on the threshold It). ngspice defaults: Ron=1, Roff=1e12
    (1/GMIN-class), It=0, Ih=0.
    """

    name: str
    Ron: float = 1.0
    Roff: float = 1e12
    It: float = 0.0
    Ih: float = 0.0


@dataclass
class DiodeModel:
    name: str
    Is: float = 1e-14
    N: float = 1.0
    # ohmic series resistance (extended; lowered to a real resistor +
    # internal node in the parser post-pass)
    RS: float = 0.0
    # temperature model (extended; Is(T) scaling under .temp)
    EG: float = 1.11
    XTI: float = 3.0
    # charge storage (extended dialect; SPICE TT/CJO/VJ/M/FC — all-zero
    # defaults keep the reference's memoryless diode exactly)
    TT: float = 0.0
    CJO: float = 0.0
    VJ: float = 1.0
    M: float = 0.5
    FC: float = 0.5
    # flicker (1/f) noise parameters (extended dialect; used by .noise)
    KF: float = 0.0
    AF: float = 1.0


@dataclass
class MOSModel:
    """Extended-dialect level-1 MOSFET model (.model <name> nmos|pmos).

    SPICE level-1 defaults: Vto=0, Kp=2e-5 A/V^2, Lambda=0.
    """

    name: str
    polarity: float = 1.0  # +1 nmos, -1 pmos
    Vto: float = 0.0
    Kp: float = 2e-5
    Lambda: float = 0.0
    # ohmic drain/source resistances (extended; lowered to real resistors)
    RD: float = 0.0
    RS: float = 0.0
    # gate-overlap capacitances per meter of width (SPICE CGSO/CGDO);
    # lowered to linear C entries cgso*W / cgdo*W at tensorization
    Cgso: float = 0.0
    Cgdo: float = 0.0
    # flicker (1/f) noise parameters (extended dialect; used by .noise)
    KF: float = 0.0
    AF: float = 1.0


@dataclass
class BJTModel:
    """Extended-dialect Ebers-Moll BJT model (.model <name> npn|pnp).

    SPICE defaults: Is=1e-16 A, Bf=100, Br=1.
    """

    name: str
    polarity: float = 1.0  # +1 npn, -1 pnp
    Is: float = 1e-16
    Bf: float = 100.0
    Br: float = 1.0
    # ohmic terminal resistances (extended; lowered to real resistors)
    RB: float = 0.0
    RC: float = 0.0
    RE: float = 0.0
    # temperature model (extended; Is(T) scaling under .temp)
    EG: float = 1.11
    XTI: float = 3.0
    # charge storage (extended; SPICE TF/TR transit times + CJE/CJC
    # depletion caps — all-zero defaults keep the memoryless device)
    TF: float = 0.0
    TR: float = 0.0
    CJE: float = 0.0
    VJE: float = 0.75
    MJE: float = 0.33
    CJC: float = 0.0
    VJC: float = 0.75
    MJC: float = 0.33
    FC: float = 0.5
    # flicker (1/f) noise parameters (extended dialect; used by .noise)
    KF: float = 0.0
    AF: float = 1.0


@dataclass
class JFETModel:
    """Extended-dialect level-1 JFET model (.model <name> njf|pjf).

    SPICE defaults: Vto=-2 V (both polarities, SPICE convention: the
    pinch-off is negative as-given and the PJF equations run on reflected
    terminal voltages), Beta=1e-4 A/V^2, Lambda=0, gate-junction Is=1e-14 A.
    """

    name: str
    polarity: float = 1.0  # +1 njf, -1 pjf
    Vto: float = -2.0
    Beta: float = 1e-4
    Lambda: float = 0.0
    Is: float = 1e-14
    # gate capacitances (absolute F; SPICE CGS/CGD) lowered to C entries
    Cgs: float = 0.0
    Cgd: float = 0.0
    # flicker (1/f) noise parameters (extended dialect; used by .noise)
    KF: float = 0.0
    AF: float = 1.0


@dataclass
class MOSFET:
    """Extended-dialect M element: ``M name nd ng ns [nb] model [w=] [l=]``.

    The bulk node, when present, is parsed but ignored (no body effect at
    level 1 without it). beta = Kp * W / L with W = L = 100 um defaults.
    """

    name: str
    nd: int
    ng: int
    ns: int
    model_name: str
    W: float = 100e-6
    L: float = 100e-6
    model: MOSModel | None = None


@dataclass
class BJT:
    """Extended-dialect Q element: ``Q name nc nb ne model``."""

    name: str
    nc: int
    nb: int
    ne: int
    model_name: str
    model: BJTModel | None = None


@dataclass
class JFET:
    """Extended-dialect J element: ``J name nd ng ns model``.

    Lowered at tensorization time onto the existing companion primitives:
    one square-law channel entry in the MOSFET arrays (JFET's
    ``Beta*(vgs-Vto)^2`` saturation law equals the level-1 MOS law with
    ``beta_mos = 2*Beta``) plus two gate-junction diode entries
    (gate-source / gate-drain) in the diode arrays — see
    ir/circuit.py:build_tensors. No new engine code paths.
    """

    name: str
    nd: int
    ng: int
    ns: int
    model_name: str
    model: JFETModel | None = None


@dataclass
class Switch:
    name: str
    n1: int
    n2: int
    nc_pos: int
    nc_neg: int
    model_name: str
    model: VSwitchModel | None = None


@dataclass
class CSwitch:
    """Extended-dialect W element: ``W name n1 n2 Vctrl model``.

    A switch whose state follows the current through the named V source
    (the control current is the source's MNA branch unknown, so no extra
    sensing element is needed).
    """

    name: str
    n1: int
    n2: int
    ctrl_name: str
    model_name: str
    model: CSwitchModel | None = None
    ctrl_index: int = -1  # controlling V-source branch (parser post-pass)


@dataclass
class LTRAModel:
    """Extended-dialect lossy transmission-line model
    (``.model <name> LTRA(r= l= g= c= len= [nseg=])``) — per-length
    series resistance/inductance and shunt conductance/capacitance, plus
    the line length (ngspice puts ``len`` on the model). ``nseg`` is this
    implementation's segment-count knob for the lossy expansion (0 =
    auto-sized from the loss, see the O expansion post-pass)."""

    name: str
    R: float = 0.0     # ohms per meter (series)
    L: float = 0.0     # henries per meter (series)
    G: float = 0.0     # siemens per meter (shunt)
    C: float = 0.0     # farads per meter (shunt)
    LEN: float = 1.0   # line length, meters
    NSEG: int = 0      # 0 = auto


@dataclass
class OLine:
    """Extended-dialect O element: LTRA lossy transmission line,
    ``O name n1 n2 n3 n4 model``. Expanded in the parser post-pass onto
    existing primitives (the same lowering strategy as U -> R/C ladders
    and J -> MOS+diode): LC lines become ONE lossless T element (exact);
    RLC/RG(C) lines become nseg cascaded sections of series R — lossless
    T — series R with the shunt conductance split across the section
    ports, converging to the true hyperbolic two-port as nseg grows; RC
    lines (L=0) become the URC-style R/C ladder; series-only lines (C=0,
    G=0) become exact series R(+L) chains. The expansion assumes an
    ideal common reference conductor (exact when n2 and n4 are the same
    node, e.g. ground) — the same differential-only modeling as the T
    element. Note: like ``t``, ``o`` is deliberately NOT in the
    title-leader set, so an O element on the very FIRST line of an
    untitled deck is swallowed as the title ("op amp deck" titles are
    ubiquitous); anywhere else it parses."""

    name: str
    n1: int
    n2: int
    n3: int
    n4: int
    model_name: str


@dataclass
class URCLine:
    """Extended-dialect U element: ``U name n1 n2 ncommon model [l=len]
    [n=lumps]`` — a uniform distributed RC line, expanded in the parser
    post-pass into a ladder of ordinary R/C elements (series R along
    n1..n2, shunt C to ncommon) with lump lengths in geometric progression
    toward the middle (ngspice's URC construction). Internal nodes are
    ``<name>#k``; generated elements ``<name>#rk`` / ``<name>#ck``."""

    name: str
    n1: int
    n2: int
    ncom: int
    model_name: str
    length: float = 1.0
    lumps: int = 0  # 0 = size from the model's fmax


@dataclass
class TLine:
    """Extended-dialect T element: lossless transmission line,
    ``T name n1 n2 n3 n4 Z0=z [TD=td | F=f [NL=nl]]`` (ngspice syntax).

    Modeled by Branin's method of characteristics: each port is a Thevenin
    branch (series Z0 + a source delayed from the far end), adding two MNA
    branch unknowns (the port currents, flowing into the + terminals). Only
    the differential mode is modeled — the classic SPICE T-element
    property. ``td = NL/F`` when given in wavelength form (NL defaults to
    0.25, ngspice semantics).
    """

    name: str
    n1: int
    n2: int
    n3: int
    n4: int
    z0: float
    td: float
    index: int = -1  # first of the two branch unknowns (post-pass)


@dataclass
class BSource:
    """Extended-dialect behavioral source: ``B name n+ n- V=expr|I=expr``.

    ngspice-style arbitrary source. ``I=expr`` drives the expression's
    current from n+ through the source to n- (KCL convention of the I
    element); ``V=expr`` enforces v(n+) - v(n-) = expr via an extra MNA
    branch unknown (allocated after the H branches). Expressions may
    reference v(node)/v(a,b), i(vname), and time (parsing/bexpr.py).
    """

    name: str
    n1: int
    n2: int
    kind: str                 # "i" | "v"
    expr: str
    refs: list                # [("v"|"i", name, name2|None), ...]
    fn: object                # compiled (vals, t) -> value closure
    ref_pairs: list = field(default_factory=list)  # resolved node-id/branch
    index: int = -1           # MNA branch (v-kind), parser post-pass


@dataclass
class MutualCoupling:
    """Extended-dialect K element: ``K name L1 L2 k`` (coupled inductors).

    Couples two named inductors with coefficient 0 < |k| <= 1; the mutual
    inductance is M = k * sqrt(L1 * L2).
    """

    name: str
    l1_name: str
    l2_name: str
    k: float
    l1_pos: int = -1  # index into ckt.L (parser post-pass)
    l2_pos: int = -1


@dataclass
class Diode:
    name: str
    n_plus: int
    n_minus: int
    model_name: str
    model: DiodeModel | None = None


@dataclass
class ACAnalysis:
    mode: str  # "dec" | "lin"
    N: int
    f1: float
    f2: float


@dataclass
class TranAnalysis:
    dt: float
    tstop: float
    # extended: ngspice's optional third ``.tran`` token — integrate from
    # 0 but record only t >= tstart. 0 (and the reference dialect, which
    # ignores extra tokens) keeps the full grid.
    tstart: float = 0.0


@dataclass
class DCAnalysis:
    """Extended-dialect .dc sweep: ``.dc <src> <start> <stop> <step>
    [<src2> <start2> <stop2> <step2>]`` (second source = ngspice-style
    nested outer sweep)."""

    src: str
    start: float
    stop: float
    step: float
    src2: str | None = None
    start2: float = 0.0
    stop2: float = 0.0
    step2: float = 0.0


@dataclass
class FourAnalysis:
    """Extended-dialect ``.four <f0> v(node)...``: Fourier decomposition of
    transient waveforms over the final fundamental period, ngspice-style."""

    f0: float
    probes: list[str]


@dataclass
class NoiseAnalysis:
    """Extended-dialect ``.noise v(out[,ref]) <src> <dec|lin> <N> <f1> <f2>``:
    ngspice-style small-signal noise analysis at the DC operating point."""

    out_pos: str
    out_neg: str | None
    src: str
    mode: str  # "dec" | "lin"
    N: int
    f1: float
    f2: float


@dataclass
class TFAnalysis:
    """Extended-dialect ``.tf v(out[,ref]) <src>``: DC small-signal transfer
    function (gain, input impedance, output impedance), ngspice-style."""

    out_pos: str
    out_neg: str | None
    src: str


@dataclass
class StepAnalysis:
    """Extended-dialect ``.step [param] <name> <start> <stop> <incr>`` or
    ``.step [param] <name> list v1 v2 ...`` (LTspice-style parameter
    stepping): every value becomes one lane of a batched run — the
    TPU-native realization of stepping (ONE compiled call, not a loop)."""

    param: str
    values: tuple  # float step values


@dataclass
class SensAnalysis:
    """Extended-dialect ``.sens v(out[,ref])``: DC sensitivities of the
    output voltage w.r.t. every circuit parameter (adjoint method)."""

    out_pos: str
    out_neg: str | None


@dataclass
class PZAnalysis:
    """Extended-dialect ``.pz n1 n2 n3 n4 cur|vol pol|zer|pz``:
    pole-zero analysis of the small-signal transfer function from the input
    port (n1, n2) to the output port (n3, n4) at the DC operating point,
    ngspice-style. ``vol`` = voltage transfer (ideal V input across the
    port), ``cur`` = transimpedance (unit current into n1, out of n2)."""

    n1: str
    n2: str
    n3: str
    n4: str
    transfer: str  # "cur" | "vol"
    which: str     # "pol" | "zer" | "pz"


@dataclass
class ParsedCircuit:
    nodes: NodeIndex = field(default_factory=NodeIndex)
    R: list[Resistor] = field(default_factory=list)
    C: list[Capacitor] = field(default_factory=list)
    L: list[Inductor] = field(default_factory=list)
    V: list[VoltageSource] = field(default_factory=list)
    S: list[Switch] = field(default_factory=list)
    D: list[Diode] = field(default_factory=list)
    I: list[CurrentSource] = field(default_factory=list)  # extended dialect
    G: list[VCCS] = field(default_factory=list)  # extended dialect
    E: list[VCVS] = field(default_factory=list)  # extended dialect
    F: list[CCCS] = field(default_factory=list)  # extended dialect
    H: list[CCVS] = field(default_factory=list)  # extended dialect
    M: list[MOSFET] = field(default_factory=list)  # extended dialect
    Q: list[BJT] = field(default_factory=list)  # extended dialect
    J: list[JFET] = field(default_factory=list)  # extended dialect
    W: list[CSwitch] = field(default_factory=list)  # extended dialect
    K: list[MutualCoupling] = field(default_factory=list)  # extended dialect
    B: list[BSource] = field(default_factory=list)  # extended dialect
    T: list[TLine] = field(default_factory=list)  # extended dialect
    U: list[URCLine] = field(default_factory=list)  # extended dialect
    O: list[OLine] = field(default_factory=list)  # extended dialect (LTRA)
    ac: ACAnalysis | None = None
    tran: TranAnalysis | None = None
    dc: DCAnalysis | None = None  # extended dialect
    tf: TFAnalysis | None = None  # extended dialect
    pz: PZAnalysis | None = None  # extended dialect
    sens: SensAnalysis | None = None  # extended dialect
    step: StepAnalysis | None = None  # extended dialect
    four: FourAnalysis | None = None  # extended dialect
    noise: NoiseAnalysis | None = None  # extended dialect
    meas: list = field(default_factory=list)  # extended .meas tran specs
    op: bool = False  # extended dialect .op directive
    tran_probes: list[str] = field(default_factory=list)
    tran_iprobes: list[str] = field(default_factory=list)  # extended i()
    ac_probes: list[str] = field(default_factory=list)  # extended .print ac
    initial_conditions: dict[str, float] = field(default_factory=dict)  # extended .ic
    nodeset: dict[str, float] = field(default_factory=dict)  # extended
    control: list[str] = field(default_factory=list)  # extended .control
    skipped: list[str] = field(default_factory=list)
    urc_models: dict[str, URCModel] = field(default_factory=dict)
    ltra_models: dict[str, LTRAModel] = field(default_factory=dict)
    vswitch_models: dict[str, VSwitchModel] = field(default_factory=dict)
    cswitch_models: dict[str, CSwitchModel] = field(default_factory=dict)
    diode_models: dict[str, DiodeModel] = field(default_factory=dict)
    mos_models: dict[str, MOSModel] = field(default_factory=dict)
    bjt_models: dict[str, BJTModel] = field(default_factory=dict)
    jfet_models: dict[str, JFETModel] = field(default_factory=dict)
    title: str | None = None
    temp_c: float | None = None  # extended .temp (Celsius); None = 300 K
    options: dict[str, float] = field(default_factory=dict)  # extended

    @property
    def temp_kelvin(self) -> float:
        """Analysis temperature. Default 300 K exactly — the reference's
        hard-coded VT=0.025852 V corresponds to T=300 K (constants.ts)."""
        return 300.0 if self.temp_c is None else 273.15 + self.temp_c

    @property
    def n_node_vars(self) -> int:
        return self.nodes.count() - 1

    @property
    def n_vars(self) -> int:
        # branch-unknown ordering: V sources, then E (VCVS), then H (CCVS),
        # then behavioral V-kind B sources, then 2 port currents per T line
        return (self.n_node_vars + len(self.V) + len(self.E) + len(self.H)
                + sum(1 for b in self.B if b.kind == "v")
                + 2 * len(self.T))

    # --- reference-shaped accessors (parseNetlist.ts:93-104) ---
    @property
    def analyses(self) -> dict:
        return {"ac": self.ac, "tran": self.tran}

    @property
    def probes(self) -> dict:
        return {"tran": self.tran_probes}

    @property
    def models(self) -> dict:
        return {"vswitch": self.vswitch_models, "diode": self.diode_models}


def _parse_model_params(params_str: str) -> dict[str, float]:
    """key=value pairs split on whitespace/commas (parseNetlist.ts:242-255)."""
    out: dict[str, float] = {}
    if not params_str:
        return out
    for assignment in filter(None, _ASSIGN_SPLIT_RE.split(params_str)):
        key_raw, sep, value_raw = assignment.partition("=")
        if not key_raw or not sep or value_raw == "":
            continue
        value = parse_number_with_units(value_raw)
        if value != value:  # NaN
            continue
        out[key_raw.lower()] = value
    return out


def _parse_v_output_spec(token: str, directive: str,
                         line: str) -> tuple[str, str | None]:
    """``v(node)`` / ``v(node,ref)`` output specs (.tf / .noise)."""
    m = re.match(r"^v\s*\(([^)]+)\)$", token, re.IGNORECASE)
    if not m:
        raise ValueError(
            f"{directive} output must be v(node) or v(node,ref): {line!r}")
    parts = [p.strip() for p in m.group(1).split(",")]
    if len(parts) == 1:
        return parts[0], None
    if len(parts) == 2:
        return parts[0], parts[1]
    raise ValueError(f"malformed {directive} output spec: {line!r}")


def _parse_directive(ckt: ParsedCircuit, tokens: list[str], line: str,
                     dialect: str = "spicey") -> None:
    dir_name = tokens[0].lower()
    if dir_name == ".op" and dialect == "extended":
        ckt.op = True
    elif dir_name == ".nodeset" and dialect == "extended":
        # .nodeset v(node)=value ... — initial Newton guess for .op
        body = line.strip()[8:].strip()
        entries = re.findall(r"v\(([^)]+)\)\s*=\s*(\S+)", body,
                             re.IGNORECASE)
        leftover = re.sub(r"v\(([^)]+)\)\s*=\s*(\S+)", "", body,
                          flags=re.IGNORECASE).strip()
        if not entries or leftover:
            raise ValueError(f"malformed .nodeset directive: {line!r}")
        for node, val in entries:
            ckt.nodeset[node] = parse_number_with_units(val)
    elif dir_name == ".ic" and dialect == "extended":
        # .ic v(node)=value ... — transient initial node voltages. Parsed
        # from the raw line: the tokenizer splits "v(2)=3" at the paren.
        body = line.strip()[3:].strip()
        entries = re.findall(r"v\(([^)]+)\)\s*=\s*(\S+)", body,
                             re.IGNORECASE)
        leftover = re.sub(r"v\(([^)]+)\)\s*=\s*(\S+)", "", body,
                          flags=re.IGNORECASE).strip()
        if not entries or leftover:
            raise ValueError(f"malformed .ic directive: {line!r}")
        for node, val in entries:
            ckt.initial_conditions[node] = parse_number_with_units(val)
    elif dir_name == ".dc" and dialect == "extended":
        src = _require(tokens, 1, ".dc missing source name")
        start = parse_number_with_units(_require(tokens, 2, ".dc missing start"))
        stop = parse_number_with_units(_require(tokens, 3, ".dc missing stop"))
        step = parse_number_with_units(_require(tokens, 4, ".dc missing step"))
        dc = DCAnalysis(src=src, start=start, stop=stop, step=step)
        if len(tokens) >= 9:
            dc.src2 = tokens[5]
            dc.start2 = parse_number_with_units(tokens[6])
            dc.stop2 = parse_number_with_units(tokens[7])
            dc.step2 = parse_number_with_units(tokens[8])
        ckt.dc = dc
    elif dir_name == ".four" and dialect == "extended":
        f0 = parse_number_with_units(
            _require(tokens, 1, ".four missing fundamental frequency"))
        probes: list[str] = []
        for token in tokens[2:]:
            m = _PROBE_RE.match(token)
            if m and m.group(1):
                if not any(p.upper() == m.group(1).upper() for p in probes):
                    probes.append(m.group(1))
        if not probes:
            raise ValueError(f".four needs at least one v(node) probe: {line!r}")
        ckt.four = FourAnalysis(f0=f0, probes=probes)
    elif dir_name == ".temp" and dialect == "extended":
        ckt.temp_c = parse_number_with_units(
            _require(tokens, 1, ".temp missing temperature"))
    elif dir_name in (".options", ".option") and dialect == "extended":
        # ngspice-style key[=value] pairs; bare keys store 1.0 (flags).
        # Keys the engines consume: temp (like .temp), reltol (Newton
        # convergence tolerance; implies iterate-to-convergence), itl4
        # (transient Newton iteration limit). Others are carried in
        # ckt.options for callers.
        params = _parse_model_params(" ".join(tokens[1:]))
        for tok in tokens[1:]:
            if "=" not in tok:
                params.setdefault(tok.lower(), 1.0)
        ckt.options.update(params)
        if "temp" in params and ckt.temp_c is None:
            ckt.temp_c = params["temp"]
    elif dir_name == ".tf" and dialect == "extended":
        out_tok = _require(tokens, 1, ".tf missing output spec")
        src = _require(tokens, 2, ".tf missing input source name")
        out_pos, out_neg = _parse_v_output_spec(out_tok, ".tf", line)
        ckt.tf = TFAnalysis(out_pos=out_pos, out_neg=out_neg, src=src)
    elif dir_name in (".meas", ".measure") and dialect == "extended":
        from ..analysis.meas import parse_meas_line

        ckt.meas.append(parse_meas_line(line))
    elif dir_name == ".noise" and dialect == "extended":
        out_tok = _require(tokens, 1, ".noise missing output spec")
        src = _require(tokens, 2, ".noise missing input source name")
        mode = _require(tokens, 3, ".noise missing sweep mode").lower()
        if mode not in ("dec", "lin", "oct"):
            raise ValueError(".noise supports 'dec', 'lin' or 'oct'")
        N = int(js_parse_int(_require(tokens, 4, ".noise missing point count")))
        f1 = parse_number_with_units(
            _require(tokens, 5, ".noise missing start frequency"))
        f2 = parse_number_with_units(
            _require(tokens, 6, ".noise missing stop frequency"))
        out_pos, out_neg = _parse_v_output_spec(out_tok, ".noise", line)
        ckt.noise = NoiseAnalysis(out_pos=out_pos, out_neg=out_neg, src=src,
                                  mode=mode, N=N, f1=f1, f2=f2)
    elif dir_name in (".save", ".probe") and dialect == "extended":
        # ngspice vector selection: v() filters node output in BOTH tran
        # and AC, i() filters recorded element currents. .probe is the
        # PSpice/LTspice spelling of the same thing.
        for token in tokens[1:]:
            m = _PROBE_RE.match(token)
            if m and m.group(1):
                nm = m.group(1)
                if not any(p.upper() == nm.upper()
                           for p in ckt.tran_probes):
                    ckt.tran_probes.append(nm)
                if not any(p.upper() == nm.upper() for p in ckt.ac_probes):
                    ckt.ac_probes.append(nm)
                continue
            mi = _IPROBE_RE.match(token)
            if mi and mi.group(1):
                el = mi.group(1)
                if not any(p.upper() == el.upper()
                           for p in ckt.tran_iprobes):
                    ckt.tran_iprobes.append(el)
    elif dir_name == ".step" and dialect == "extended":
        toks = tokens[1:]
        if toks and toks[0].lower() == "param":
            toks = toks[1:]
        if not toks:
            raise ValueError(".step missing parameter/element name")
        pname = toks[0]
        rest = toks[1:]
        if rest and rest[0].lower() == "list":
            vals = tuple(parse_number_with_units(t) for t in rest[1:])
            if not vals:
                raise ValueError(".step list needs at least one value")
        else:
            if len(rest) < 3:
                raise ValueError(
                    ".step needs <start> <stop> <incr> or list v1 v2 ...")
            start = parse_number_with_units(rest[0])
            stop = parse_number_with_units(rest[1])
            incr = parse_number_with_units(rest[2])
            if incr == 0 or (stop - start) * incr < 0:
                raise ValueError(".step increment does not reach stop")
            n_pts = int(abs((stop - start) / incr) + 1e-9) + 1
            vals = tuple(start + k * incr for k in range(n_pts))
        ckt.step = StepAnalysis(param=pname, values=vals)
    elif dir_name == ".sens" and dialect == "extended":
        out_tok = _require(tokens, 1, ".sens missing output spec")
        out_pos, out_neg = _parse_v_output_spec(out_tok, ".sens", line)
        ckt.sens = SensAnalysis(out_pos=out_pos, out_neg=out_neg)
    elif dir_name == ".pz" and dialect == "extended":
        if len(tokens) < 7:
            raise ValueError(
                ".pz needs: .pz n1 n2 n3 n4 cur|vol pol|zer|pz")
        transfer = tokens[5].lower()
        if transfer not in ("cur", "vol"):
            raise ValueError(".pz transfer type must be 'cur' or 'vol'")
        which = tokens[6].lower()
        if which not in ("pol", "zer", "pz"):
            raise ValueError(".pz analysis type must be 'pol', 'zer' or 'pz'")
        ckt.pz = PZAnalysis(n1=tokens[1], n2=tokens[2], n3=tokens[3],
                            n4=tokens[4], transfer=transfer, which=which)
    elif dir_name == ".ac":
        mode = _require(tokens, 1, ".ac missing mode").lower()
        # the reference throws on anything but dec/lin (parseNetlist.ts:
        # 165-179); the extended dialect adds ngspice's oct mode
        allowed = ("dec", "lin", "oct") if dialect == "extended" else ("dec", "lin")
        if mode not in allowed:
            raise ValueError(".ac supports 'dec' or 'lin'")
        N = int(js_parse_int(_require(tokens, 2, ".ac missing point count")))
        f1 = parse_number_with_units(_require(tokens, 3, ".ac missing start frequency"))
        f2 = parse_number_with_units(_require(tokens, 4, ".ac missing stop frequency"))
        ckt.ac = ACAnalysis(mode=mode, N=N, f1=f1, f2=f2)
    elif dir_name == ".tran":
        dt = parse_number_with_units(_require(tokens, 1, ".tran missing timestep"))
        tstop = parse_number_with_units(_require(tokens, 2, ".tran missing stop time"))
        # Extra tokens (e.g. ngspice's `uic`) are silently ignored in the
        # reference dialect (parseNetlist.ts:180-187); the extended dialect
        # honors a numeric third token as ngspice's tstart (record window).
        tstart = 0.0
        if (dialect == "extended" and len(tokens) > 3
                and re.match(r"^[\d.+-]", tokens[3])):
            tstart = parse_number_with_units(tokens[3])
            if not 0.0 <= tstart < tstop:
                raise ValueError(".tran tstart must be in [0, tstop)")
        ckt.tran = TranAnalysis(dt=dt, tstop=tstop, tstart=tstart)
    elif dir_name == ".print" or (dir_name == ".plot"
                                  and dialect == "extended"):
        # extended: `.plot tran|ac v(...)` selects the same probes as
        # .print (we record vectors, not ASCII graphs — rawfile/SVG
        # exporters draw them); the reference dialect has no .plot and
        # keeps dropping it into `skipped` below
        analysis_type = _require(
            tokens, 1, f"{dir_name} missing analysis type").lower()
        if analysis_type == "tran":
            for token in tokens[2:]:
                m = _PROBE_RE.match(token)
                if m and m.group(1):
                    node_name = m.group(1)
                    if not any(p.upper() == node_name.upper() for p in ckt.tran_probes):
                        ckt.tran_probes.append(node_name)
                    continue
                # extended: i(<element>) filters recorded element currents
                # (the reference recognizes only v() probes,
                # parseNetlist.ts:188-211, and leaves currents unfiltered)
                mi = _IPROBE_RE.match(token)
                if mi and mi.group(1) and dialect == "extended":
                    el = mi.group(1)
                    if not any(p.upper() == el.upper()
                               for p in ckt.tran_iprobes):
                        ckt.tran_iprobes.append(el)
        elif analysis_type == "ac" and dialect == "extended":
            # extended: .print ac v(node)... filters the AC output the
            # same way .print tran filters transient node voltages
            for token in tokens[2:]:
                m = _PROBE_RE.match(token)
                if m and m.group(1):
                    node_name = m.group(1)
                    if not any(p.upper() == node_name.upper()
                               for p in ckt.ac_probes):
                        ckt.ac_probes.append(node_name)
        else:
            ckt.skipped.append(line)
    elif dir_name == ".model":
        name_token = _require(tokens, 1, ".model missing name")
        type_token = _require(tokens, 2, ".model missing type")
        mtype = type_token
        params_str = ""
        if "(" in mtype:
            idx = mtype.index("(")
            params_str = mtype[idx + 1:]
            mtype = mtype[:idx]
        if not params_str:
            rest = " ".join(tokens[3:])
            params_str = re.sub(r"^\(", "", re.sub(r"\)$", "", rest))
        else:
            rest = re.sub(r"\)$", "", " ".join(tokens[3:]))
            params_str = f"{params_str} {rest}".strip()
        params_str = re.sub(r"^\(", "", re.sub(r"\)$", "", params_str)).strip()
        type_lower = mtype.lower()
        if type_lower in ("vswitch", "sw"):
            model = VSwitchModel(name=name_token)
            params = _parse_model_params(params_str)
            if "ron" in params:
                model.Ron = params["ron"]
            if "roff" in params:
                model.Roff = params["roff"]
            if "von" in params:
                model.Von = params["von"]
            if "voff" in params:
                model.Voff = params["voff"]
            if "vt" in params:
                vh = params.get("vh", 0.0)
                model.Von = params["vt"] + vh / 2
                model.Voff = params["vt"] - vh / 2
            ckt.vswitch_models[name_token.lower()] = model
        elif type_lower in ("csw", "iswitch") and dialect == "extended":
            cmodel = CSwitchModel(name=name_token)
            params = _parse_model_params(params_str)
            if "ron" in params:
                cmodel.Ron = params["ron"]
            if "roff" in params:
                cmodel.Roff = params["roff"]
            if "it" in params:
                cmodel.It = params["it"]
            if "ih" in params:
                cmodel.Ih = params["ih"]
            ckt.cswitch_models[name_token.lower()] = cmodel
        elif type_lower == "d":
            model = DiodeModel(name=name_token)
            params = _parse_model_params(params_str)
            if "is" in params:
                model.Is = params["is"]
            if "n" in params:
                model.N = params["n"]
            if dialect == "extended":
                if "rs" in params:
                    model.RS = params["rs"]
                if "eg" in params:
                    model.EG = params["eg"]
                if "xti" in params:
                    model.XTI = params["xti"]
                # charge-storage parameters (reference dialect ignores
                # unknown model keys, so these stay extended-only)
                if "tt" in params:
                    model.TT = params["tt"]
                if "cjo" in params:
                    model.CJO = params["cjo"]
                if "cj0" in params:
                    model.CJO = params["cj0"]
                if "vj" in params:
                    model.VJ = params["vj"]
                if "m" in params:
                    model.M = params["m"]
                if "fc" in params:
                    model.FC = params["fc"]
            if "kf" in params:
                model.KF = params["kf"]
            if "af" in params:
                model.AF = params["af"]
            ckt.diode_models[name_token.lower()] = model
        elif type_lower in ("nmos", "pmos") and dialect == "extended":
            model = MOSModel(name=name_token,
                             polarity=1.0 if type_lower == "nmos" else -1.0)
            params = _parse_model_params(params_str)
            if "vto" in params:
                model.Vto = params["vto"]
            if "kp" in params:
                model.Kp = params["kp"]
            if "lambda" in params:
                model.Lambda = params["lambda"]
            if "rd" in params:
                model.RD = params["rd"]
            if "rs" in params:
                model.RS = params["rs"]
            if "cgso" in params:
                model.Cgso = params["cgso"]
            if "cgdo" in params:
                model.Cgdo = params["cgdo"]
            if "kf" in params:
                model.KF = params["kf"]
            if "af" in params:
                model.AF = params["af"]
            ckt.mos_models[name_token.lower()] = model
        elif type_lower in ("npn", "pnp") and dialect == "extended":
            model = BJTModel(name=name_token,
                             polarity=1.0 if type_lower == "npn" else -1.0)
            params = _parse_model_params(params_str)
            if "is" in params:
                model.Is = params["is"]
            if "bf" in params:
                model.Bf = params["bf"]
            if "br" in params:
                model.Br = params["br"]
            for key, attr in (("eg", "EG"), ("xti", "XTI"),
                              ("rb", "RB"), ("rc", "RC"), ("re", "RE"),
                              ("tf", "TF"), ("tr", "TR"), ("cje", "CJE"),
                              ("vje", "VJE"), ("mje", "MJE"),
                              ("cjc", "CJC"), ("vjc", "VJC"),
                              ("mjc", "MJC"), ("fc", "FC")):
                if key in params:
                    setattr(model, attr, params[key])
            if "kf" in params:
                model.KF = params["kf"]
            if "af" in params:
                model.AF = params["af"]
            ckt.bjt_models[name_token.lower()] = model
        elif type_lower == "urc" and dialect == "extended":
            umodel = URCModel(name=name_token)
            params = _parse_model_params(params_str)
            if "isperl" in params or "rsperl" in params:
                raise ValueError(
                    "URC isperl/rsperl (per-length diodes) not supported")
            if "k" in params:
                umodel.K = params["k"]
            if "rperl" in params:
                umodel.Rperl = params["rperl"]
            if "cperl" in params:
                umodel.Cperl = params["cperl"]
            if "fmax" in params:
                umodel.Fmax = params["fmax"]
            ckt.urc_models[name_token.lower()] = umodel
        elif type_lower == "ltra" and dialect == "extended":
            lmodel = LTRAModel(name=name_token)
            params = _parse_model_params(params_str)
            for key, attr in (("r", "R"), ("l", "L"), ("g", "G"),
                              ("c", "C"), ("len", "LEN")):
                if key in params:
                    setattr(lmodel, attr, params[key])
            if "nseg" in params:
                lmodel.NSEG = int(params["nseg"])
            if lmodel.LEN <= 0:
                raise ValueError("LTRA model len must be > 0")
            if min(lmodel.R, lmodel.L, lmodel.G, lmodel.C) < 0:
                raise ValueError("LTRA r/l/g/c must be >= 0")
            if lmodel.L > 0 and lmodel.C == 0 and lmodel.G > 0:
                raise ValueError(
                    "LTRA with L > 0, C = 0, G > 0 is not supported")
            ckt.ltra_models[name_token.lower()] = lmodel
        elif type_lower in ("njf", "pjf", "nmf", "pmf") \
                and dialect == "extended":
            # MESFETs (nmf/pmf, Z elements) share the level-1
            # Shichman-Hodges square law and lower onto the same JFET
            # machinery (MESFET defaults: beta=1e-4 matches)
            model = JFETModel(
                name=name_token,
                polarity=1.0 if type_lower in ("njf", "nmf") else -1.0)
            params = _parse_model_params(params_str)
            if "vto" in params:
                model.Vto = params["vto"]
            if "beta" in params:
                model.Beta = params["beta"]
            if "lambda" in params:
                model.Lambda = params["lambda"]
            if "is" in params:
                model.Is = params["is"]
            if "cgs" in params:
                model.Cgs = params["cgs"]
            if "cgd" in params:
                model.Cgd = params["cgd"]
            if "kf" in params:
                model.KF = params["kf"]
            if "af" in params:
                model.AF = params["af"]
            ckt.jfet_models[name_token.lower()] = model
        else:
            ckt.skipped.append(line)
    else:
        ckt.skipped.append(line)


def _flatten_poly_tokens(toks: list[str]) -> list[str]:
    """Expand paren-grouped POLY control pairs — vendor decks write
    ``(3,0)`` or ``( 3 0 )``, which the tokenizer keeps whole."""
    flat: list[str] = []
    for t in toks:
        if t.startswith("(") and t.endswith(")"):
            flat.extend(p for p in re.split(r"[\s,]+", t[1:-1].strip())
                        if p)
        else:
            flat.append(t)
    return flat


def _poly_expr(xs: list[str], coeffs: list[float]) -> str:
    """SPICE2 POLY(n) polynomial as a behavioral-expression string.

    Term ordering (SPICE2 convention): constant p0; linear p_i*x_i; then
    for POLY(1) arbitrary powers p_k*x^k, and for n >= 2 the quadratic
    products in row-wise lower-triangle order (x1*x1, x2*x1, x2*x2,
    x3*x1, x3*x2, x3*x3, ...). Coefficients beyond second order with
    multiple controls raise (they are essentially unused in real decks).
    """
    terms = [f"({coeffs[0]!r})"]
    k = 1
    for x in xs:
        if k >= len(coeffs):
            break
        terms.append(f"({coeffs[k]!r})*{x}")
        k += 1
    if len(xs) == 1:
        order = 2
        while k < len(coeffs):
            terms.append(f"({coeffs[k]!r})*{xs[0]}**{order}")
            k += 1
            order += 1
    else:
        prods = [f"{xs[i]}*{xs[j]}"
                 for i in range(len(xs)) for j in range(i + 1)]
        for p in prods:
            if k >= len(coeffs):
                break
            terms.append(f"({coeffs[k]!r})*{p}")
            k += 1
        if k < len(coeffs):
            raise ValueError(
                "POLY coefficients beyond second order are only "
                "supported for POLY(1)")
    return "+".join(terms)


def _parse_poly_source(ckt: ParsedCircuit, name: str, type_char: str,
                       tokens: list[str]) -> None:
    """SPICE2 ``E/G/F/H name n+ n- POLY(nd) <controls> <coeffs>`` —
    lowered onto a behavioral (B) source: the polynomial becomes a
    compiled expression over v(a,b) / i(vname) references, so nonlinear
    POLY sources (opamp macromodel limiters etc.) converge under the same
    Newton machinery as any B element. E/H lower to V= sources (branch
    unknown), G/F to I= sources."""
    from .bexpr import compile_bexpr

    nd = int(_POLY_RE.match(tokens[3]).group(1))
    if nd < 1:
        raise ValueError("POLY dimension must be >= 1")
    tokens = tokens[:4] + _flatten_poly_tokens(tokens[4:])
    if type_char in ("e", "g"):
        need = 2 * nd
        node_toks = tokens[4:4 + need]
        if len(node_toks) < need:
            raise ValueError(
                f"POLY({nd}) needs {need} control node tokens")
        for t in node_toks:
            ckt.nodes.get_or_create(t)  # register control nodes
        xs = [f"v({node_toks[2 * i]},{node_toks[2 * i + 1]})"
              for i in range(nd)]
        coeff_toks = tokens[4 + need:]
    else:
        ctl = tokens[4:4 + nd]
        if len(ctl) < nd:
            raise ValueError(
                f"POLY({nd}) needs {nd} controlling source names")
        xs = [f"i({c})" for c in ctl]
        coeff_toks = tokens[4 + nd:]
    coeffs = [parse_number_with_units(t) for t in coeff_toks]
    if not coeffs:
        raise ValueError("POLY source missing coefficients")
    expr = _poly_expr(xs, coeffs)
    n1 = ckt.nodes.get_or_create(tokens[1])
    n2 = ckt.nodes.get_or_create(tokens[2])
    kind = "v" if type_char in ("e", "h") else "i"
    refs, fn = compile_bexpr(expr)
    ckt.B.append(BSource(name=name, n1=n1, n2=n2, kind=kind,
                         expr=expr, refs=refs, fn=fn))


def js_parse_int(s: str) -> int:
    """JS ``parseInt(s, 10)``: longest decimal-integer prefix."""
    m = re.match(r"^\s*([+-]?\d+)", s)
    if not m:
        raise ValueError(f"invalid integer: {s!r}")
    return int(m.group(1))


def _scan_source_spec(vs: object, tokens: list[str],
                      dialect: str = "spicey") -> None:
    """Shared dc/ac/PULSE/PWL keyword scanner (parseNetlist.ts:344-389),
    applied to VoltageSource and (extended dialect) CurrentSource. The
    extended dialect additionally understands SIN(...) and EXP(...)
    waveforms; under the reference dialect those tokens are skipped one at
    a time, exactly like any unknown keyword (parseNetlist.ts:384-388)."""
    i = 3
    if i < len(tokens) and not re.match(r"^[a-zA-Z]", tokens[i]):
        vs.dc = parse_number_with_units(tokens[i])
        i += 1
    while i < len(tokens):
        key = tokens[i].lower()
        if key == "dc":
            vs.dc = parse_number_with_units(_require(tokens, i + 1, "DC value missing"))
            i += 2
        elif key == "ac":
            vs.ac_mag = parse_number_with_units(
                _require(tokens, i + 1, "AC magnitude missing")
            )
            phase_token = tokens[i + 2] if i + 2 < len(tokens) else None
            if phase_token is not None and re.match(r"^[+-]?\d", phase_token):
                vs.ac_phase_deg = parse_number_with_units(phase_token)
                i += 3
            else:
                i += 2
        elif key.startswith("pulse"):
            arg_token = key if "(" in key else _require(
                tokens, i + 1, "PULSE() missing arguments"
            )
            if not arg_token or not re.search(r"\(.*\)", arg_token):
                raise ValueError("Malformed PULSE() specification")
            vs.waveform = PulseWaveform(parse_pulse_args(arg_token))
            i += 1 if "(" in key else 2
        elif key.startswith("pwl"):
            arg_token = key if "(" in key else _require(
                tokens, i + 1, "PWL() missing arguments"
            )
            if not arg_token or not re.search(r"\(.*\)", arg_token):
                raise ValueError("Malformed PWL() specification")
            vs.waveform = PwlWaveform(parse_pwl_args(arg_token))
            i += 1 if "(" in key else 2
        elif key.startswith("sin") and dialect == "extended":
            arg_token = key if "(" in key else _require(
                tokens, i + 1, "SIN() missing arguments"
            )
            if not arg_token or not re.search(r"\(.*\)", arg_token):
                raise ValueError("Malformed SIN() specification")
            vs.waveform = SinWaveform(parse_sin_args(arg_token))
            i += 1 if "(" in key else 2
        elif key.startswith("exp") and dialect == "extended":
            arg_token = key if "(" in key else _require(
                tokens, i + 1, "EXP() missing arguments"
            )
            if not arg_token or not re.search(r"\(.*\)", arg_token):
                raise ValueError("Malformed EXP() specification")
            vs.waveform = ExpWaveform(parse_exp_args(arg_token))
            i += 1 if "(" in key else 2
        elif key.startswith("sffm") and dialect == "extended":
            arg_token = key if "(" in key else _require(
                tokens, i + 1, "SFFM() missing arguments"
            )
            if not arg_token or not re.search(r"\(.*\)", arg_token):
                raise ValueError("Malformed SFFM() specification")
            vs.waveform = SffmWaveform(parse_sffm_args(arg_token))
            i += 1 if "(" in key else 2
        elif key.startswith("am") and dialect == "extended":
            arg_token = key if "(" in key else _require(
                tokens, i + 1, "AM() missing arguments"
            )
            if not arg_token or not re.search(r"\(.*\)", arg_token):
                raise ValueError("Malformed AM() specification")
            vs.waveform = AmWaveform(parse_am_args(arg_token))
            i += 1 if "(" in key else 2
        else:
            # stray parenthesized groups and unknown keywords are skipped
            # one token at a time (parseNetlist.ts:384-388)
            i += 1


def _parse_voltage_source(ckt: ParsedCircuit, name: str, tokens: list[str],
                          dialect: str = "spicey") -> None:
    """V element with dc/ac/PULSE/PWL keyword scanning (parseNetlist.ts:328-399)."""
    n1 = ckt.nodes.get_or_create(_require(tokens, 1, "Voltage source missing node"))
    n2 = ckt.nodes.get_or_create(_require(tokens, 2, "Voltage source missing node"))
    vs = VoltageSource(name=name, n1=n1, n2=n2)
    _scan_source_spec(vs, tokens, dialect=dialect)
    ckt.V.append(vs)


def _parse_current_source(ckt: ParsedCircuit, name: str, tokens: list[str],
                          dialect: str = "spicey") -> None:
    """Extended-dialect I element; same spec grammar as V."""
    n1 = ckt.nodes.get_or_create(_require(tokens, 1, "Current source missing node"))
    n2 = ckt.nodes.get_or_create(_require(tokens, 2, "Current source missing node"))
    cs = CurrentSource(name=name, n1=n1, n2=n2)
    _scan_source_spec(cs, tokens, dialect=dialect)
    ckt.I.append(cs)


# nodes-per-element for subcircuit flattening: how many tokens after the
# name are node references that must be remapped into the instance scope
_ELEMENT_NODE_COUNT = {
    "r": 2, "c": 2, "l": 2, "v": 2, "i": 2, "d": 2,
    "q": 3, "j": 3, "s": 4, "e": 4, "g": 4, "f": 2, "h": 2, "t": 4,
    "w": 2, "k": 0,  # W's Vctrl and K's L1/L2 are element refs, not nodes
    "u": 3, "z": 3, "o": 4,
}

_MAX_SUBCKT_DEPTH = 20


def _collect_subckt_defs(text: str) -> tuple[dict, list[str]]:
    """Split netlist text into `.subckt` definitions and the main body.

    Returns ({lower_name: (ports, body_lines)}, main_lines). Definitions are
    top-level only; nested `.subckt` definitions raise. Everything after a
    top-level `.end` passes through untouched (the parser ignores it anyway).
    """
    defs: dict[str, tuple] = {}
    main: list[str] = []
    cur_name: str | None = None
    cur_ports: list[str] = []
    cur_body: list[str] = []
    cur_defaults: list[tuple[str, str]] = []
    ended = False
    for raw in re.split(r"\r?\n", text):
        line = re.sub(r";.*$", "", re.sub(r"//.*$", "", raw)).strip()
        if ended:
            main.append(raw)
            continue
        if _END_RE.match(line):
            main.append(raw)
            ended = True
            continue
        if _SUBCKT_RE.match(line):
            if cur_name is not None:
                raise ValueError(
                    f'nested .subckt definitions are not supported: "{line}"')
            toks = line.split()
            if len(toks) < 3:
                raise ValueError(f'malformed .subckt directive: "{line}"')
            # trailing name=expr tokens are default parameters (an optional
            # ngspice-style "params:" marker before them is skipped)
            rest = [t for t in toks[2:] if t.lower() != "params:"]
            cur_ports = [t for t in rest if "=" not in t]
            cur_defaults = []
            for t in rest:
                if "=" in t:
                    pname, pval = t.split("=", 1)
                    pval = pval[1:-1] if pval.startswith("{") else pval
                    cur_defaults.append((pname.lower(), pval))
            cur_name, cur_body = toks[1].lower(), []
            continue
        if _ENDS_RE.match(line):
            if cur_name is None:
                raise ValueError(f'.ends without matching .subckt: "{line}"')
            defs[cur_name] = (cur_ports, cur_body, cur_defaults)
            cur_name = None
            continue
        (cur_body if cur_name is not None else main).append(raw)
    if cur_name is not None:
        raise ValueError(f".subckt {cur_name} is missing its .ends")
    return defs, main


def _expand_instance(inst_name: str, tokens: list[str], defs: dict,
                     depth: int, scope: dict | None = None) -> list[str]:
    """Expand one X line into flattened element lines.

    ngspice-style scoping: ports bind to the instance's outer nodes, every
    other node `n` inside the body becomes `n.<instance-path>`, ground "0"
    stays global, and element names are suffixed `.<instance-path>` (so the
    leading type character is preserved for dispatch). `.model` cards inside
    a body are hoisted to the global model namespace.
    """
    if depth > _MAX_SUBCKT_DEPTH:
        raise ValueError(
            f"subcircuit nesting deeper than {_MAX_SUBCKT_DEPTH} while "
            f"expanding {inst_name} (recursive .subckt definition?)")
    from .params import eval_expr, substitute_braces

    if scope is None:
        scope = {}
    if len(tokens) < 2:
        raise ValueError(f"subcircuit instance {inst_name} missing subcircuit name")
    # trailing name=value tokens override the definition's default params;
    # the subckt name is the last bare (non-assignment) token
    kv_tokens = [t for t in tokens[1:] if "=" in t]
    bare = [t for t in tokens[1:] if "=" not in t]
    if not bare:
        raise ValueError(f"subcircuit instance {inst_name} missing subcircuit name")
    sub_name = bare[-1].lower()
    if sub_name not in defs:
        raise ValueError(
            f"Unknown .subckt {bare[-1]} referenced by {inst_name}")
    ports, body, defaults = defs[sub_name]
    outer = bare[:-1]
    # instance-local parameter scope: defaults (evaluated against the outer
    # scope, in declaration order so later defaults may use earlier ones)
    # overridden by the X line's name=value pairs (evaluated in the OUTER
    # scope, ngspice semantics)
    local = dict(scope)
    for pname, pexpr in defaults:
        local[pname] = eval_expr(pexpr, local)
    for t in kv_tokens:
        pname, pval = t.split("=", 1)
        if pname.lower() not in dict(defaults):
            raise ValueError(
                f"unknown parameter {pname!r} on instance {inst_name} "
                f"(not declared by .subckt {sub_name})")
        pval = pval[1:-1] if pval.startswith("{") else pval
        local[pname.lower()] = eval_expr(pval, scope)
    if len(outer) != len(ports):
        raise ValueError(
            f"{inst_name} connects {len(outer)} nodes but .subckt "
            f"{tokens[-1]} declares {len(ports)} ports")
    node_map = {p.upper(): o for p, o in zip(ports, outer)}

    def map_node(n: str) -> str:
        if n == "0":
            return n
        return node_map.get(n.upper(), f"{n}.{inst_name}")

    def rename(el: str) -> str:
        return f"{el}.{inst_name}"

    out: list[str] = []
    for raw in body:
        line = raw.strip()
        if not line or line.startswith("*"):
            continue
        line = re.sub(r"//.*$", "", line)
        line = re.sub(r";.*$", "", line)
        # scoped {param} substitution: instance-local over globals; unknown
        # names defer to deeper instance scopes (strict at the final pass)
        line = substitute_braces(line, local, strict=False)
        toks = smart_tokens(line)
        if not toks or not toks[0]:
            continue
        first = toks[0]
        if first.startswith("."):
            if first.lower() == ".model":
                out.append(line)  # models are global; hoist unchanged
                continue
            raise ValueError(
                f'directive not allowed inside .subckt {sub_name}: "{line}"')
        tc = first[0].lower()
        if tc == "x" and _X_NAME_RE.match(first):
            inner_kv = [t for t in toks[1:] if "=" in t]
            inner_bare = [t for t in toks[1:] if "=" not in t]
            inner = ([rename(first)]
                     + [map_node(t) for t in inner_bare[:-1]]
                     + [inner_bare[-1]] + inner_kv)
            out.extend(_expand_instance(rename(first), inner, defs,
                                        depth + 1, scope=local))
            continue
        if tc == "b":
            # behavioral source: map its two nodes, then rewrite the
            # v()/i() references inside the expression into this scope
            m = re.match(r"^\s*(\S+)\s+(\S+)\s+(\S+)\s+(.*)$", line)
            if not m:
                raise ValueError(
                    f'malformed behavioral source in .subckt: "{line}"')
            tail = m.group(4)
            tail = re.sub(
                r"\b[vV]\s*\(([^()]*)\)",
                lambda mm: "v(" + ",".join(
                    map_node(x.strip()) for x in mm.group(1).split(",")
                    if x.strip()) + ")",
                tail)
            tail = re.sub(
                r"\b[iI]\s*\(([^()]*)\)",
                lambda mm: "i(" + rename(mm.group(1).strip()) + ")",
                tail)
            out.append(" ".join([rename(first), map_node(m.group(2)),
                                 map_node(m.group(3)), tail]))
            continue
        if (tc in ("e", "g", "f", "h") and len(toks) > 3
                and _POLY_RE.match(toks[3])):
            # POLY sources: nd control node pairs (e/g) or nd controlling
            # source names (f/h) follow the POLY token (paren groups
            # flattened first); coefficients pass through untouched
            nd = int(_POLY_RE.match(toks[3]).group(1))
            flat4 = _flatten_poly_tokens(toks[4:])
            out_nodes = [map_node(toks[1]), map_node(toks[2])]
            if tc in ("e", "g"):
                ctl = [map_node(t) for t in flat4[:2 * nd]]
                rest = flat4[2 * nd:]
            else:
                ctl = [rename(t) for t in flat4[:nd]]
                rest = flat4[nd:]
            out.append(" ".join([rename(first)] + out_nodes + [toks[3]]
                                + ctl + rest))
            continue
        if tc == "m":
            # M d g s [bulk] model [k=v...]: bare tokens after the nodes are
            # [bulk, model] or [model]; k=v params pass through untouched
            nodes = [map_node(t) for t in toks[1:4]]
            rest = toks[4:]
            bare_left = sum(1 for t in rest if "=" not in t) - 1
            mapped_rest = []
            for t in rest:
                if "=" not in t and bare_left > 0:
                    mapped_rest.append(map_node(t))
                    bare_left -= 1
                else:
                    mapped_rest.append(t)
            out.append(" ".join([rename(first)] + nodes + mapped_rest))
            continue
        nn = _ELEMENT_NODE_COUNT.get(tc)
        if nn is None:
            out.append(line)  # unknown element: passes through to `skipped`
            continue
        new = [rename(first)] + [map_node(t) for t in toks[1:1 + nn]]
        rest = toks[1 + nn:]
        if tc in ("f", "h", "w") and rest:
            # controlling V source lives in the same scope; rename with it
            rest = [rename(rest[0])] + rest[1:]
        elif tc == "k" and len(rest) >= 2:
            # coupled inductors live in the same scope; rename both refs
            rest = [rename(rest[0]), rename(rest[1])] + rest[2:]
        out.append(" ".join(new + rest))
    return out


def _flatten_subcircuits(text: str, gparams: dict | None = None) -> str:
    """Flatten `.subckt`/`.ends`/X hierarchy into a flat netlist (extended
    dialect only — the reference drops X lines into `skipped`,
    parseNetlist.ts:444-446). ``gparams`` is the global .param scope used
    to evaluate instance parameter overrides."""
    defs, main = _collect_subckt_defs(text)
    if gparams is None:
        gparams = {}
    out: list[str] = []
    seen_title = False
    ended = False
    for raw in main:
        line = raw.strip()
        if ended or not line or line.startswith("*"):
            out.append(raw)
            continue
        if _END_RE.match(line):
            out.append(raw)
            ended = True
            continue
        stripped = re.sub(r";.*$", "", re.sub(r"//.*$", "", line))
        toks = smart_tokens(stripped)
        first = toks[0] if toks else ""
        if first and _X_NAME_RE.match(first):
            # a real instance names a defined subckt as its last BARE token
            # (trailing name=value tokens are parameter overrides);
            # otherwise an x-word leading an untitled netlist's first free
            # line is a title (mirroring the reference's lenient title rule)
            bare = [t for t in toks[1:] if "=" not in t]
            if bare and bare[-1].lower() in defs:
                out.extend(_expand_instance(first, toks, defs, 1,
                                            scope=gparams))
                continue
            if seen_title:
                raise ValueError(
                    f"Unknown .subckt {bare[-1] if bare else '?'} "
                    f"referenced by {first}")
            seen_title = True
            out.append(raw)
            continue
        if (not seen_title and first and not first.startswith(".")
                and not _ELEMENT_OR_TITLE_EXT_RE.match(first)):
            seen_title = True
            out.append(raw)
            continue
        out.append(raw)
    return "\n".join(out)


_MAX_INCLUDE_DEPTH = 10


def _expand_includes(text: str, base_dir: str | None,
                     depth: int = 0) -> str:
    """Resolve ``.include``/``.inc`` and ``.lib`` file references
    (extended dialect; the reference drops them into `skipped`).

    - ``.include "file"`` / ``.inc file`` splices the file in, relative
      paths resolved against ``base_dir`` (the including file's directory
      for nested includes).
    - ``.lib "file" section`` splices only the ``.lib <section>`` ...
      ``.endl`` block of that file (ngspice library sections); the bare
      ``.lib "file"`` form behaves like ``.include``.
    """
    import os

    if depth > _MAX_INCLUDE_DEPTH:
        raise ValueError(
            f"include nesting deeper than {_MAX_INCLUDE_DEPTH} "
            f"(recursive .include?)")
    out: list[str] = []
    for raw in re.split(r"\r?\n", text):
        line = raw.strip()
        m = re.match(r'^\.(?:include|inc|lib)\b\s*(.*)$', line,
                     re.IGNORECASE)
        if not m:
            out.append(raw)
            continue
        is_lib = line.lower().startswith(".lib")
        toks = smart_tokens(m.group(1))
        if not toks:
            raise ValueError(f'missing filename: "{line}"')
        path = toks[0].strip('"')
        section = toks[1] if is_lib and len(toks) > 1 else None
        if is_lib and not (path.strip('"') and ("." in path or "/" in path
                                                or len(toks) > 1)):
            # ".lib section" inside a library file itself: leave for the
            # section extractor below
            out.append(raw)
            continue
        full = path if os.path.isabs(path) else os.path.join(
            base_dir or os.getcwd(), path)
        if not os.path.exists(full):
            raise ValueError(f'.include file not found: "{full}"')
        with open(full) as fh:
            content = fh.read()
        if section is not None:
            mm = re.search(
                rf'^\s*\.lib\s+{re.escape(section)}\s*$(.*?)^\s*\.endl\b',
                content, re.IGNORECASE | re.MULTILINE | re.DOTALL)
            if mm is None:
                raise ValueError(
                    f'.lib section "{section}" not found in "{full}"')
            content = mm.group(1)
        out.append(_expand_includes(content, os.path.dirname(full),
                                    depth + 1))
    return "\n".join(out)


def _extract_control_blocks(text: str) -> tuple[str, list[str]]:
    """Pull ``.control ... .endc`` blocks out of the deck text.

    ngspice executes these as interpreter scripts after the deck loads
    (batch ``-b`` semantics). Returns the deck with the blocks removed
    plus the inner lines in file order. Extraction happens BEFORE
    parameter substitution and subckt flattening — control scripts are
    not netlist text and must not be brace-substituted or swallowed by a
    ``.subckt`` scan. Extended dialect only: the reference's parser drops
    unknown directives line by line (parseNetlist.ts:291-446), so under
    ``dialect="spicey"`` a ``.control`` deck keeps that exact behavior.
    """
    kept: list[str] = []
    control: list[str] = []
    in_block = False
    for raw in re.split(r"\r?\n", text):
        stripped = raw.strip()
        low = stripped.lower()
        if in_block:
            if low == ".endc" or low.startswith(".endc "):
                in_block = False
            else:
                control.append(stripped)
            continue
        if low == ".control" or low.startswith(".control "):
            in_block = True
            continue
        kept.append(raw)
    if in_block:
        raise ValueError(".control block missing .endc")
    return "\n".join(kept), control


# .control command taxonomy (ngspice batch-mode subset). Analysis commands
# are the dot-directive grammar minus the leading dot; post-processing
# commands execute against the finished result (analysis/control.py);
# no-ops either restate batch behavior (`run` — the deck's analyses always
# run) or are interactive-shell chrome with no batch meaning.
_CONTROL_ANALYSES = frozenset((
    "op", "dc", "ac", "tran", "tf", "noise", "four", "meas", "measure",
    "sens", "pz", "save"))
_CONTROL_POST = frozenset(("print", "echo", "write", "wrdata", "set",
                           "let"))
_CONTROL_NOOPS = frozenset((
    "run", "listing", "setplot", "display", "version", "rusage", "reset",
    "destroy", "unset"))


def _absorb_control(ckt: ParsedCircuit, lines: list[str],
                    dialect: str) -> None:
    """Fold a ``.control`` script into the parsed circuit.

    Analysis commands route through ``_parse_directive`` with the dot
    restored, so control scripts and dot-cards share one grammar and can
    never diverge; when a deck carries both, the control command wins
    (last assignment, matching the engines' one-analysis-per-kind model).
    Post-processing commands queue in ``ckt.control`` for
    ``analysis/control.py`` to execute against the SimulationResult.
    ``quit``/``exit`` ends the script; anything unrecognized lands in
    ``skipped`` like any other unhandled input.
    """
    for line in lines:
        if not line or line.startswith("*"):
            continue
        # ngspice end-of-line comments need whitespace before the marker
        # ($-variable substitution is unsupported; a mid-word `$`/`;` as in
        # `echo price is $5` stays literal)
        line = re.sub(r"(?:^|\s)[;$].*$", "", line).strip()
        if not line:
            continue
        head = line.split(None, 1)[0].lower()
        if head in ("quit", "exit"):
            break
        if head in _CONTROL_NOOPS:
            continue
        if head == "alter":
            # batch semantics: the deck runs once, so alters apply before
            # every analysis (last alter of an element wins). ngspice's
            # interactive alter/run interleaving maps onto .step /
            # the batch APIs instead.
            if not _alter_element(ckt, line.split(None, 1)[1].strip()
                                  if " " in line else ""):
                ckt.skipped.append(line)
            continue
        if head in _CONTROL_ANALYSES:
            dotted = "." + line
            _parse_directive(ckt, smart_tokens(dotted), dotted,
                             dialect=dialect)
            continue
        if head in _CONTROL_POST:
            ckt.control.append(line)
            continue
        ckt.skipped.append(line)


# alter targets: element-family list + the value attribute ngspice's bare
# `alter <name> <value>` changes (R/C/L value; V/I DC level)
_ALTER_ATTRS = {"r": ("R", "R"), "c": ("C", "C"), "l": ("L", "L"),
                "v": ("V", "dc"), "i": ("I", "dc")}


def _alter_element(ckt: ParsedCircuit, rest: str) -> bool:
    """``alter name [=] value`` — returns False (caller skips the line)
    for @device[param] forms, altermod, unknown names, or bad numbers."""
    toks = rest.replace("=", " ").split()
    if len(toks) != 2 or not toks[0] or toks[0].startswith("@"):
        return False
    name, val_tok = toks
    fam = _ALTER_ATTRS.get(name[0].lower())
    if fam is None:
        return False
    value = parse_number_with_units(val_tok)
    if value != value:  # NaN: not a number
        return False
    for el in getattr(ckt, fam[0]):
        if el.name.upper() == name.upper():
            setattr(el, fam[1], value)
            return True
    return False


def parse_netlist(text: str, dialect: str = "spicey",
                  base_dir: str | None = None) -> ParsedCircuit:
    """Parse a netlist.

    dialect="spicey" (default) reproduces the reference exactly (I/G/E/...
    elements land in `skipped`, parseNetlist.ts:444-446);
    dialect="extended" additionally supports independent current sources
    (I elements) with the same dc/ac/PULSE/PWL grammar as V, controlled
    sources, MOSFET/BJT devices, SIN/EXP waveforms, `.op`/`.dc`/`.ic`
    directives, and `.subckt`/`.ends`/X hierarchical netlists (flattened
    before parsing).
    """
    if dialect not in ("spicey", "extended"):
        raise ValueError("dialect must be 'spicey' or 'extended'")
    control_lines: list[str] = []
    if dialect == "extended":
        if re.search(r"^\s*\.(include|inc|lib)\b", text,
                     re.IGNORECASE | re.MULTILINE):
            text = _expand_includes(text, base_dir)
        if re.search(r"^\s*\.control\b", text, re.IGNORECASE | re.MULTILINE):
            text, control_lines = _extract_control_blocks(text)
        gparams: dict = {}
        has_braces = "{" in text
        if has_braces or re.search(r"^\s*\.(param|func)\b", text,
                                   re.IGNORECASE | re.MULTILINE):
            from .params import apply_params

            # lenient first pass: .subckt-local parameters resolve later,
            # at instance expansion, with the instance scope
            text, gparams = apply_params(text, strict=False)
        text = _flatten_subcircuits(text, gparams)
        if has_braces and "{" in text:
            # strict final pass: anything still braced is a genuinely
            # unknown parameter — surface the name, not a number-parse error
            from .params import substitute_braces

            text = "\n".join(
                substitute_braces(line, gparams, strict=True)
                for line in re.split(r"\r?\n", text))
    ckt = ParsedCircuit()
    seen_title = False

    for raw in re.split(r"\r?\n", text):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("*"):
            continue
        if _END_RE.match(line):
            break
        line = re.sub(r"//.*$", "", line)
        line = re.sub(r";.*$", "", line)

        tokens = smart_tokens(line)
        if not tokens:
            continue
        first = tokens[0]
        if not first:
            continue

        elem_re = (_ELEMENT_OR_TITLE_EXT_RE if dialect == "extended"
                   else _ELEMENT_OR_TITLE_RE)
        if (
            not seen_title
            and not elem_re.match(first)
            and not first.startswith(".")
        ):
            seen_title = True
            ckt.title = line
            continue

        if first.startswith("."):
            _parse_directive(ckt, tokens, line, dialect=dialect)
            continue

        type_char = first[0].lower()
        name = first
        try:
            if type_char == "r":
                n1 = ckt.nodes.get_or_create(_require(tokens, 1, "Resistor missing node"))
                n2 = ckt.nodes.get_or_create(_require(tokens, 2, "Resistor missing node"))
                val = parse_number_with_units(_require(tokens, 3, "Resistor missing value"))
                res = Resistor(name=name, n1=n1, n2=n2, R=val)
                if dialect == "extended":
                    # tc1=/tc2= temperature coefficients (trailing k=v
                    # tokens are ignored in the reference dialect)
                    params = _parse_model_params(" ".join(
                        t for t in tokens[4:] if "=" in t))
                    res.tc1 = params.get("tc1", 0.0)
                    res.tc2 = params.get("tc2", 0.0)
                ckt.R.append(res)
            elif type_char == "c":
                n1 = ckt.nodes.get_or_create(_require(tokens, 1, "Capacitor missing node"))
                n2 = ckt.nodes.get_or_create(_require(tokens, 2, "Capacitor missing node"))
                val = parse_number_with_units(_require(tokens, 3, "Capacitor missing value"))
                cap = Capacitor(name=name, n1=n1, n2=n2, C=val)
                if dialect == "extended":
                    cparams = _parse_model_params(" ".join(
                        t for t in tokens[4:] if "=" in t))
                    if "ic" in cparams:
                        cap.ic = cparams["ic"]
                ckt.C.append(cap)
            elif type_char == "l":
                n1 = ckt.nodes.get_or_create(_require(tokens, 1, "Inductor missing node"))
                n2 = ckt.nodes.get_or_create(_require(tokens, 2, "Inductor missing node"))
                val = parse_number_with_units(_require(tokens, 3, "Inductor missing value"))
                ind = Inductor(name=name, n1=n1, n2=n2, L=val)
                if dialect == "extended":
                    lparams = _parse_model_params(" ".join(
                        t for t in tokens[4:] if "=" in t))
                    if "ic" in lparams:
                        ind.ic = lparams["ic"]
                ckt.L.append(ind)
            elif type_char == "v":
                _parse_voltage_source(ckt, name, tokens, dialect=dialect)
            elif type_char == "i" and dialect == "extended":
                _parse_current_source(ckt, name, tokens, dialect=dialect)
            elif type_char == "m" and dialect == "extended":
                nd = ckt.nodes.get_or_create(
                    _require(tokens, 1, "MOSFET missing drain node"))
                ng = ckt.nodes.get_or_create(
                    _require(tokens, 2, "MOSFET missing gate node"))
                ns = ckt.nodes.get_or_create(
                    _require(tokens, 3, "MOSFET missing source node"))
                rest = tokens[4:]
                if not rest:
                    raise ValueError("MOSFET missing model")
                # optional bulk node: present when a second bare token
                # precedes the model name (``d g s b model``)
                kv = [t for t in rest if "=" in t]
                bare = [t for t in rest if "=" not in t]
                if len(bare) == 2:
                    ckt.nodes.get_or_create(bare[0])  # bulk: parsed, unused
                    model_name = bare[1]
                elif len(bare) == 1:
                    model_name = bare[0]
                else:
                    raise ValueError("MOSFET missing model")
                mos = MOSFET(name=name, nd=nd, ng=ng, ns=ns,
                             model_name=model_name.lower())
                params = _parse_model_params(" ".join(kv))
                if "w" in params:
                    mos.W = params["w"]
                if "l" in params:
                    mos.L = params["l"]
                ckt.M.append(mos)
            elif type_char == "q" and dialect == "extended":
                nc = ckt.nodes.get_or_create(
                    _require(tokens, 1, "BJT missing collector node"))
                nb = ckt.nodes.get_or_create(
                    _require(tokens, 2, "BJT missing base node"))
                ne = ckt.nodes.get_or_create(
                    _require(tokens, 3, "BJT missing emitter node"))
                model_name = _require(tokens, 4, "BJT missing model")
                ckt.Q.append(BJT(name=name, nc=nc, nb=nb, ne=ne,
                                 model_name=model_name.lower()))
            elif type_char in ("j", "z") and dialect == "extended":
                # Z = MESFET: same terminals and square law, lowered onto
                # the JFET machinery (model types nmf/pmf)
                nd = ckt.nodes.get_or_create(
                    _require(tokens, 1, "JFET missing drain node"))
                ng = ckt.nodes.get_or_create(
                    _require(tokens, 2, "JFET missing gate node"))
                ns = ckt.nodes.get_or_create(
                    _require(tokens, 3, "JFET missing source node"))
                model_name = _require(tokens, 4, "JFET missing model")
                ckt.J.append(JFET(name=name, nd=nd, ng=ng, ns=ns,
                                  model_name=model_name.lower()))
            elif type_char in ("f", "h") and dialect == "extended":
                if len(tokens) > 3 and _POLY_RE.match(tokens[3]):
                    _parse_poly_source(ckt, name, type_char, tokens)
                    continue
                n1 = ckt.nodes.get_or_create(
                    _require(tokens, 1, "Controlled source missing node"))
                n2 = ckt.nodes.get_or_create(
                    _require(tokens, 2, "Controlled source missing node"))
                ctrl = _require(tokens, 3,
                                "Controlled source missing control source")
                val = parse_number_with_units(
                    _require(tokens, 4, "Controlled source missing value"))
                if type_char == "f":
                    ckt.F.append(CCCS(name=name, n1=n1, n2=n2,
                                      ctrl_name=ctrl, gain=val))
                else:
                    ckt.H.append(CCVS(name=name, n1=n1, n2=n2,
                                      ctrl_name=ctrl, r=val))
            elif type_char in ("g", "e") and dialect == "extended":
                if len(tokens) > 3 and _POLY_RE.match(tokens[3]):
                    _parse_poly_source(ckt, name, type_char, tokens)
                    continue
                n1 = ckt.nodes.get_or_create(
                    _require(tokens, 1, "Controlled source missing node"))
                n2 = ckt.nodes.get_or_create(
                    _require(tokens, 2, "Controlled source missing node"))
                ncp = ckt.nodes.get_or_create(
                    _require(tokens, 3, "Controlled source missing control node"))
                ncn = ckt.nodes.get_or_create(
                    _require(tokens, 4, "Controlled source missing control node"))
                val = parse_number_with_units(
                    _require(tokens, 5, "Controlled source missing value"))
                if type_char == "g":
                    ckt.G.append(VCCS(name=name, n1=n1, n2=n2,
                                      nc_pos=ncp, nc_neg=ncn, gm=val))
                else:
                    ckt.E.append(VCVS(name=name, n1=n1, n2=n2,
                                      nc_pos=ncp, nc_neg=ncn, gain=val))
            elif type_char == "b" and dialect == "extended":
                n1 = ckt.nodes.get_or_create(
                    _require(tokens, 1, "Behavioral source missing node"))
                n2 = ckt.nodes.get_or_create(
                    _require(tokens, 2, "Behavioral source missing node"))
                m = re.match(
                    r"^\s*\S+\s+\S+\s+\S+\s+([vi])\s*=\s*(.+)$",
                    line, re.IGNORECASE)
                if not m:
                    raise ValueError(
                        "Behavioral source needs V=<expr> or I=<expr>")
                from .bexpr import compile_bexpr

                kind = m.group(1).lower()
                expr = m.group(2).strip()
                refs, fn = compile_bexpr(expr)
                ckt.B.append(BSource(name=name, n1=n1, n2=n2, kind=kind,
                                     expr=expr, refs=refs, fn=fn))
            elif type_char == "t" and dialect == "extended":
                nodes_t = [ckt.nodes.get_or_create(
                    _require(tokens, k, "Transmission line missing node"))
                    for k in (1, 2, 3, 4)]
                params = _parse_model_params(
                    " ".join(t for t in tokens[5:] if "=" in t))
                if "z0" not in params:
                    raise ValueError("Transmission line missing Z0=")
                z0 = params["z0"]
                if z0 <= 0:
                    raise ValueError("Transmission line Z0 must be > 0")
                if "td" in params:
                    td = params["td"]
                elif "f" in params:
                    # wavelength form: td = NL/F, NL defaults to 0.25
                    td = params.get("nl", 0.25) / params["f"]
                else:
                    raise ValueError(
                        "Transmission line needs TD= or F= [NL=]")
                if td <= 0:
                    raise ValueError("Transmission line delay must be > 0")
                ckt.T.append(TLine(name=name, n1=nodes_t[0], n2=nodes_t[1],
                                   n3=nodes_t[2], n4=nodes_t[3],
                                   z0=z0, td=td))
            elif type_char == "o" and dialect == "extended":
                nodes_o = [ckt.nodes.get_or_create(
                    _require(tokens, k, "LTRA line missing node"))
                    for k in (1, 2, 3, 4)]
                omodel_name = _require(tokens, 5, "LTRA line missing model")
                ckt.O.append(OLine(
                    name=name, n1=nodes_o[0], n2=nodes_o[1],
                    n3=nodes_o[2], n4=nodes_o[3],
                    model_name=omodel_name.lower()))
            elif type_char == "u" and dialect == "extended":
                n1u = ckt.nodes.get_or_create(
                    _require(tokens, 1, "URC line missing node"))
                n2u = ckt.nodes.get_or_create(
                    _require(tokens, 2, "URC line missing node"))
                ncm = ckt.nodes.get_or_create(
                    _require(tokens, 3, "URC line missing common node"))
                umodel_name = _require(tokens, 4, "URC line missing model")
                uparams = _parse_model_params(
                    " ".join(t for t in tokens[5:] if "=" in t))
                ckt.U.append(URCLine(
                    name=name, n1=n1u, n2=n2u, ncom=ncm,
                    model_name=umodel_name.lower(),
                    length=uparams.get("l", 1.0),
                    lumps=int(uparams.get("n", 0))))
            elif type_char == "k" and dialect == "extended":
                l1 = _require(tokens, 1, "Coupling missing inductor name")
                l2 = _require(tokens, 2, "Coupling missing inductor name")
                kval = parse_number_with_units(
                    _require(tokens, 3, "Coupling missing coefficient"))
                if not (0.0 < abs(kval) <= 1.0):
                    raise ValueError(
                        f"Coupling coefficient must satisfy 0 < |k| <= 1, "
                        f"got {kval}")
                ckt.K.append(MutualCoupling(name=name, l1_name=l1,
                                            l2_name=l2, k=kval))
            elif type_char == "w" and dialect == "extended":
                n1 = ckt.nodes.get_or_create(
                    _require(tokens, 1, "Switch missing node"))
                n2 = ckt.nodes.get_or_create(
                    _require(tokens, 2, "Switch missing node"))
                ctrl = _require(tokens, 3, "Switch missing control source")
                model_name = _require(tokens, 4, "Switch missing model")
                ckt.W.append(CSwitch(name=name, n1=n1, n2=n2, ctrl_name=ctrl,
                                     model_name=model_name.lower()))
            elif type_char == "s":
                n1 = ckt.nodes.get_or_create(_require(tokens, 1, "Switch missing node"))
                n2 = ckt.nodes.get_or_create(_require(tokens, 2, "Switch missing node"))
                nc_pos = ckt.nodes.get_or_create(
                    _require(tokens, 3, "Switch missing control node")
                )
                nc_neg = ckt.nodes.get_or_create(
                    _require(tokens, 4, "Switch missing control node")
                )
                model_name = _require(tokens, 5, "Switch missing model")
                ckt.S.append(
                    Switch(
                        name=name, n1=n1, n2=n2, nc_pos=nc_pos, nc_neg=nc_neg,
                        model_name=model_name.lower(),
                    )
                )
            elif type_char == "d":
                if len(tokens) == 4:
                    n_plus = ckt.nodes.get_or_create(_require(tokens, 1, "Diode missing node"))
                    n_minus = ckt.nodes.get_or_create(_require(tokens, 2, "Diode missing node"))
                    model_name = _require(tokens, 3, "Diode missing model")
                    ckt.D.append(
                        Diode(
                            name=name, n_plus=n_plus, n_minus=n_minus,
                            model_name=model_name.lower(),
                        )
                    )
                else:
                    ckt.skipped.append(line)
            else:
                ckt.skipped.append(line)
        except ValueError as err:
            raise ValueError(f'Parse error on line: "{line}"\n{err}') from err

    if control_lines:
        # after the deck body so control analysis commands win over
        # dot-cards (ngspice script-after-load ordering)
        _absorb_control(ckt, control_lines, dialect)

    # Device ohmic resistances (diode RS, BJT RB/RC/RE) lower to real
    # resistors + internal nodes: the junction keeps its name (current
    # recording unchanged) and is rewired behind the series element.
    # Must run before node counting, like the URC expansion below.
    for d_el in ckt.D:
        model_d = ckt.diode_models.get(d_el.model_name)
        if model_d is not None and getattr(model_d, "RS", 0.0) > 0.0:
            internal = ckt.nodes.get_or_create(f"{d_el.name}#int")
            ckt.R.append(Resistor(name=f"{d_el.name}#rs",
                                  n1=d_el.n_plus, n2=internal,
                                  R=model_d.RS))
            d_el.n_plus = internal
    for q_el in ckt.Q:
        model_q = ckt.bjt_models.get(q_el.model_name)
        if model_q is None:
            continue
        for attr, rattr in (("nb", "RB"), ("nc", "RC"), ("ne", "RE")):
            rv = getattr(model_q, rattr, 0.0)
            if rv > 0.0:
                tag = attr[1]  # b / c / e
                internal = ckt.nodes.get_or_create(f"{q_el.name}#{tag}")
                ckt.R.append(Resistor(name=f"{q_el.name}#r{tag}",
                                      n1=getattr(q_el, attr), n2=internal,
                                      R=rv))
                setattr(q_el, attr, internal)
    for m_el in ckt.M:
        model_m = ckt.mos_models.get(m_el.model_name)
        if model_m is None:
            continue
        for attr, rattr in (("nd", "RD"), ("ns", "RS")):
            rv = getattr(model_m, rattr, 0.0)
            if rv > 0.0:
                tag = attr[1]  # d / s
                internal = ckt.nodes.get_or_create(f"{m_el.name}#{tag}")
                ckt.R.append(Resistor(name=f"{m_el.name}#r{tag}",
                                      n1=getattr(m_el, attr), n2=internal,
                                      R=rv))
                setattr(m_el, attr, internal)

    # URC lines expand into R/C ladders FIRST: their internal nodes must
    # exist before the branch-index bookkeeping counts nodes
    import math as _math

    for u in ckt.U:
        um = ckt.urc_models.get(u.model_name)
        if um is None:
            raise ValueError(
                f"Unknown .model {u.model_name} referenced by URC line "
                f"{u.name}")
        n_lumps = u.lumps
        if n_lumps <= 0:
            # ngspice's sizing rule from fmax; floor 3, cap 100
            arg = (um.Fmax * um.Rperl * um.Cperl * 2 * _math.pi
                   * u.length ** 2 * ((um.K - 1) / um.K) ** 2
                   if um.K > 1 else 0.0)
            n_lumps = (max(3, _math.ceil(_math.log(arg) / _math.log(um.K)))
                       if arg > 1 and um.K > 1 else 3)
        n_lumps = min(n_lumps, 100)
        w = [um.K ** min(i, n_lumps - 1 - i) for i in range(n_lumps)]
        s_w = sum(w)
        r_tot = um.Rperl * u.length
        c_tot = um.Cperl * u.length
        chain = ([u.n1]
                 + [ckt.nodes.get_or_create(f"{u.name}#{k}")
                    for k in range(1, n_lumps)]
                 + [u.n2])
        for i in range(n_lumps):
            ckt.R.append(Resistor(name=f"{u.name}#r{i}", n1=chain[i],
                                  n2=chain[i + 1], R=r_tot * w[i] / s_w))
        caps = ([(u.n1, w[0] / 2.0)]
                + [(chain[j], (w[j - 1] + w[j]) / 2.0)
                   for j in range(1, n_lumps)]
                + [(u.n2, w[n_lumps - 1] / 2.0)])
        for k, (nd, wt) in enumerate(caps):
            ckt.C.append(Capacitor(name=f"{u.name}#c{k}", n1=nd,
                                   n2=u.ncom, C=c_tot * wt / s_w))

    # LTRA O lines lower onto existing primitives (OLine docstring):
    # exact for LC and series-only lines, convergent in nseg for lossy
    # ones. Runs BEFORE the branch-index bookkeeping because it may
    # create T elements (port-current branch unknowns).
    for o in ckt.O:
        lm = ckt.ltra_models.get(o.model_name)
        if lm is None:
            raise ValueError(
                f"Unknown .model {o.model_name} referenced by LTRA line "
                f"{o.name}")
        rt = lm.R * lm.LEN
        lt = lm.L * lm.LEN
        gt = lm.G * lm.LEN
        c_t = lm.C * lm.LEN
        if lt > 0.0 and c_t > 0.0:
            # RLC(G): cascaded [R/2 — lossless T — R/2] sections with the
            # shunt conductance split across the section ports. One exact
            # T when lossless. Internal ports reference n2 (ideal common
            # reference conductor — exact when n2 is n4); the last right
            # port references n4.
            z0 = _math.sqrt(lt / c_t)
            td = _math.sqrt(lt * c_t)
            if rt == 0.0 and gt == 0.0:
                nseg = 1
            else:
                nseg = lm.NSEG or min(
                    32, max(3, _math.ceil(5.0 * (rt / z0 + gt * z0))))
            r_half = rt / (2.0 * nseg)
            g_half = gt / (2.0 * nseg)
            tops = ([o.n1]
                    + [ckt.nodes.get_or_create(f"{o.name}#a{j}")
                       for j in range(1, nseg)]
                    + [o.n3])
            for j in range(nseg):
                a, b2 = tops[j], tops[j + 1]
                ref_l = o.n2
                ref_r = o.n4 if j == nseg - 1 else o.n2
                p = (a if r_half == 0.0
                     else ckt.nodes.get_or_create(f"{o.name}#p{j}"))
                q = (b2 if r_half == 0.0
                     else ckt.nodes.get_or_create(f"{o.name}#q{j}"))
                if r_half > 0.0:
                    ckt.R.append(Resistor(name=f"{o.name}#rl{j}", n1=a,
                                          n2=p, R=r_half))
                    ckt.R.append(Resistor(name=f"{o.name}#rr{j}", n1=q,
                                          n2=b2, R=r_half))
                ckt.T.append(TLine(name=f"{o.name}#t{j}", n1=p, n2=ref_l,
                                   n3=q, n4=ref_r, z0=z0, td=td / nseg))
                if g_half > 0.0:
                    ckt.R.append(Resistor(name=f"{o.name}#gl{j}", n1=p,
                                          n2=ref_l, R=1.0 / g_half))
                    ckt.R.append(Resistor(name=f"{o.name}#gr{j}", n1=q,
                                          n2=ref_r, R=1.0 / g_half))
        elif c_t > 0.0:
            # RC(G) diffusion line (L = 0): uniform R/C(/G) ladder
            if rt <= 0.0:
                raise ValueError(
                    f"LTRA line {o.name} has zero series impedance "
                    f"(r=0, l=0) — not supported")
            nseg = max(3, min(100, lm.NSEG or 10))
            chain = ([o.n1]
                     + [ckt.nodes.get_or_create(f"{o.name}#a{j}")
                        for j in range(1, nseg)]
                     + [o.n3])
            for j in range(nseg):
                ckt.R.append(Resistor(name=f"{o.name}#r{j}", n1=chain[j],
                                      n2=chain[j + 1], R=rt / nseg))
            shunts = ([(o.n1, o.n2, 0.5)]
                      + [(chain[j], o.n2, 1.0) for j in range(1, nseg)]
                      + [(o.n3, o.n4, 0.5)])
            for k, (nd, ref, wt) in enumerate(shunts):
                ckt.C.append(Capacitor(name=f"{o.name}#c{k}", n1=nd,
                                       n2=ref, C=c_t * wt / nseg))
                if gt > 0.0:
                    ckt.R.append(Resistor(
                        name=f"{o.name}#g{k}", n1=nd, n2=ref,
                        R=nseg / (gt * wt)))
        elif lt > 0.0:
            # series RL (C = 0, G = 0; G > 0 rejected at model parse):
            # exact lumped equivalent
            if rt > 0.0:
                mid = ckt.nodes.get_or_create(f"{o.name}#m")
                ckt.R.append(Resistor(name=f"{o.name}#r", n1=o.n1, n2=mid,
                                      R=rt))
                ckt.L.append(Inductor(name=f"{o.name}#l", n1=mid, n2=o.n3,
                                      L=lt))
            else:
                ckt.L.append(Inductor(name=f"{o.name}#l", n1=o.n1,
                                      n2=o.n3, L=lt))
        else:
            # R/G only (no line dynamics)
            if rt <= 0.0:
                raise ValueError(
                    f"LTRA line {o.name} has zero series impedance "
                    f"(r=0, l=0) — not supported")
            if gt == 0.0:
                ckt.R.append(Resistor(name=f"{o.name}#r", n1=o.n1,
                                      n2=o.n3, R=rt))
            else:
                nseg = max(3, min(100, lm.NSEG or 10))
                chain = ([o.n1]
                         + [ckt.nodes.get_or_create(f"{o.name}#a{j}")
                            for j in range(1, nseg)]
                         + [o.n3])
                for j in range(nseg):
                    ckt.R.append(Resistor(name=f"{o.name}#r{j}",
                                          n1=chain[j], n2=chain[j + 1],
                                          R=rt / nseg))
                shunts = ([(o.n1, o.n2, 0.5)]
                          + [(chain[j], o.n2, 1.0)
                             for j in range(1, nseg)]
                          + [(o.n3, o.n4, 0.5)])
                for k, (nd, ref, wt) in enumerate(shunts):
                    ckt.R.append(Resistor(
                        name=f"{o.name}#g{k}", n1=nd, n2=ref,
                        R=nseg / (gt * wt)))

    # Post-pass (parseNetlist.ts:455-479)
    n_nodes = ckt.nodes.count() - 1
    for i, vs in enumerate(ckt.V):
        vs.index = n_nodes + i
    for j, e in enumerate(ckt.E):
        e.index = n_nodes + len(ckt.V) + j
    for j, h in enumerate(ckt.H):
        h.index = n_nodes + len(ckt.V) + len(ckt.E) + j
    bv_branch = n_nodes + len(ckt.V) + len(ckt.E) + len(ckt.H)
    for bsrc in ckt.B:
        if bsrc.kind == "v":
            bsrc.index = bv_branch
            bv_branch += 1
    for ti, tl in enumerate(ckt.T):  # two port-current branches per line
        tl.index = bv_branch + 2 * ti
    v_by_name = {v.name.upper(): v for v in ckt.V}
    for bsrc in ckt.B:
        bsrc.ref_pairs = []
        for kind, a, b2 in bsrc.refs:
            if kind == "v":
                ida = ckt.nodes.get(a)
                if ida is None:
                    raise ValueError(
                        f"Unknown node {a} referenced by {bsrc.name}")
                idb = 0
                if b2 is not None:
                    idb = ckt.nodes.get(b2)
                    if idb is None:
                        raise ValueError(
                            f"Unknown node {b2} referenced by {bsrc.name}")
                bsrc.ref_pairs.append(("nodes", ida, idb))
            else:
                ctrl = v_by_name.get(a.upper())
                if ctrl is None:
                    raise ValueError(
                        f"Unknown controlling source {a} "
                        f"referenced by {bsrc.name}")
                bsrc.ref_pairs.append(("branch", ctrl.index, None))
    for cs in list(ckt.F) + list(ckt.H):
        ctrl = v_by_name.get(cs.ctrl_name.upper())
        if ctrl is None:
            raise ValueError(
                f"Unknown controlling source {cs.ctrl_name} "
                f"referenced by {cs.name}"
            )
        cs.ctrl_index = ctrl.index

    for sw in ckt.S:
        model = ckt.vswitch_models.get(sw.model_name)
        if model is None:
            raise ValueError(
                f"Unknown .model {sw.model_name} referenced by switch {sw.name}"
            )
        sw.model = model

    for wsw in ckt.W:
        cmodel = ckt.cswitch_models.get(wsw.model_name)
        if cmodel is None:
            raise ValueError(
                f"Unknown .model {wsw.model_name} referenced by switch "
                f"{wsw.name}"
            )
        wsw.model = cmodel
        ctrl = v_by_name.get(wsw.ctrl_name.upper())
        if ctrl is None:
            raise ValueError(
                f"Unknown controlling source {wsw.ctrl_name} "
                f"referenced by {wsw.name}"
            )
        wsw.ctrl_index = ctrl.index

    l_by_name = {el.name.upper(): pos for pos, el in enumerate(ckt.L)}
    for kc in ckt.K:
        for attr, lname in (("l1_pos", kc.l1_name), ("l2_pos", kc.l2_name)):
            pos = l_by_name.get(lname.upper())
            if pos is None:
                raise ValueError(
                    f"Unknown inductor {lname} referenced by coupling "
                    f"{kc.name}"
                )
            setattr(kc, attr, pos)
        if kc.l1_pos == kc.l2_pos:
            raise ValueError(
                f"Coupling {kc.name} references inductor "
                f"{kc.l1_name} twice"
            )

    for d in ckt.D:
        model = ckt.diode_models.get(d.model_name)
        if model is None:
            raise ValueError(
                f"Unknown .model {d.model_name} referenced by diode {d.name}"
            )
        d.model = model

    for m in ckt.M:
        model = ckt.mos_models.get(m.model_name)
        if model is None:
            raise ValueError(
                f"Unknown .model {m.model_name} referenced by MOSFET {m.name}"
            )
        m.model = model

    for q in ckt.Q:
        model = ckt.bjt_models.get(q.model_name)
        if model is None:
            raise ValueError(
                f"Unknown .model {q.model_name} referenced by BJT {q.name}"
            )
        q.model = model

    for j in ckt.J:
        jmodel = ckt.jfet_models.get(j.model_name)
        if jmodel is None:
            raise ValueError(
                f"Unknown .model {j.model_name} referenced by JFET {j.name}"
            )
        j.model = jmodel

    return ckt
