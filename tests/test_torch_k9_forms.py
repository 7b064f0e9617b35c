"""The forms and the launch plan of K8 and K9, the fused Monte-Carlo
transients (``ops/mc_tran_fused.py``), on any host.

Each kernel runs in one of two forms chosen by N: "register" (the
variant's elimination in its registers, N a template constant up to the
largest instance, ``REG_MAX_N``) and "shared" (the system in shared memory,
indexed at run time, up to ``FUSED_MAX_N``). Every launch takes its block
size from ``launch_plan``, made from the variants, the card's SMs and the
resident blocks per SM the occupancy API reports for each block size.
These tests hold the choosers to the kernels' instances at every N, the
plan to its promises (every SM gets a block; the most resident threads
per SM; the last wave of a launch of several reaches every SM), and each
form's shared-memory bytes per variant to the kernels' layouts, as the
wrappers check them before they build anything. The card tests (``tests/test_torch_cuda.py``) hold every form to
the plain versions; ``tests/test_torch_mc_tran.py`` holds the plain
versions to the Pallas kernels in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spicey_tpu_torch as st
from spicey_tpu_torch import decks
from spicey_tpu_torch.analysis import mc as tmc
from spicey_tpu_torch.ops import mc_tran_fused as mtf
from spicey_tpu_torch.ops._build import SMEM_MAX

CSRC = Path(mtf.__file__).resolve().parent.parent / "csrc"
N_SM = 132
CHOOSERS = {"K8": mtf.k8_form_for, "K9": mtf.k9_form_for}
CROSSOVERS = {"K8": mtf.K8_REG_MAX_N, "K9": mtf.K9_REG_MAX_N}
# resident blocks per SM by block size, as the occupancy API reports them
# on an H100 for K9's register form at N = 6 (168 registers a thread) and
# its shared form, and for K8's register form at N = 3 (the register file,
# the shared memory and the 32-block limit each binding somewhere)
RESIDENCY = {
    "K9 register N=6": {256: 1, 128: 3, 64: 6, 32: 12},
    "K9 shared N=6": {256: 2, 128: 4, 64: 8, 32: 16},
    "K8 register N=3": {256: 4, 128: 9, 64: 18, 32: 32},
    "shared-memory bound": {256: 0, 128: 1, 64: 3, 32: 7},
}


@pytest.mark.parametrize("kernel", sorted(CHOOSERS))
def test_form_chooser_covers_every_n(kernel):
    """Every N of the fused tier (1-16) has a form with an instance: the
    register form up to the crossover (within the register instances),
    the shared form past it; one crossover."""
    forms = [CHOOSERS[kernel](n) for n in range(1, 17)]
    cross = CROSSOVERS[kernel]
    assert 1 <= cross <= mtf.REG_MAX_N
    assert forms == ["register"] * cross + ["shared"] * (16 - cross)
    assert set(forms) <= set(mtf.FORMS)


@pytest.mark.parametrize("kernel", sorted(CHOOSERS))
@pytest.mark.parametrize("n", [0, 17])
def test_form_chooser_refuses_n_out_of_range(kernel, n):
    with pytest.raises(ValueError, match="1 <= N <= 16"):
        CHOOSERS[kernel](n)


@pytest.mark.parametrize("source", ["mc_tran_fused.cu", "mc_tran_nr.cu"])
def test_register_instances_match_the_kernels(source):
    """The kernel files' register instances are N = 1..REG_MAX_N, the N
    the wrappers let the register form take."""
    text = (CSRC / source).read_text()
    assert re.search(r"constexpr int REG_MAX_N = (\d+);", text).group(1) \
        == str(mtf.REG_MAX_N)
    cases = [int(c) for c in re.findall(
        r"case (\d+): return mc_tran_\w+_kernel<\1>;", text)]
    assert cases == list(range(1, mtf.REG_MAX_N + 1))


@pytest.mark.parametrize("profile", sorted(RESIDENCY))
@pytest.mark.parametrize("B", [1, 31, 4096, 100_000, 1_000_000])
def test_launch_plan_gives_every_sm_work(profile, B):
    resident = RESIDENCY[profile]
    plan = mtf.launch_plan(B, N_SM, resident)
    assert plan.blocks * plan.tpb >= B > (plan.blocks - 1) * plan.tpb
    assert 1 <= plan.tpb <= 256 and plan.resident >= 1
    if B >= N_SM:
        # every SM gets a block
        assert plan.blocks >= N_SM
    if plan.waves > 1:
        # the last wave reaches every SM: no SM idles while others run
        # its blocks
        assert plan.last_wave_blocks >= N_SM
    fits = {t: r for t, r in resident.items() if r >= 1}
    best = max(t * r for t, r in fits.items())
    if B >= N_SM * max(fits):
        # the most resident threads per SM the block sizes offer, in the
        # largest block that keeps the last wave on every SM
        assert plan.tpb * plan.resident == best
        larger = [t for t in fits if t > plan.tpb and t * fits[t] == best]
        for t in larger:
            other = mtf.LaunchPlan(tpb=t, blocks=-(-B // t),
                                   resident=fits[t], n_sm=N_SM)
            assert other.waves > 1 and other.last_wave_blocks < N_SM


def test_launch_plan_at_the_main_path_shapes():
    """ring-4096 gets a block on every SM (the fixed 256-thread blocks
    gave 16 blocks on 16 SMs); at 100k the last wave reaches every SM (the
    256-thread blocks left 5 SMs idle in it)."""
    k9 = RESIDENCY["K9 register N=6"]
    ring = mtf.launch_plan(4096, N_SM, k9)
    assert ring.blocks >= N_SM and ring.tpb == 4096 // N_SM
    big = mtf.launch_plan(100_000, N_SM, k9)
    assert big.tpb == 128 and big.blocks == 782
    assert big.last_wave_blocks >= N_SM
    # the shared form's residency ties at every size; 256-thread blocks
    # would leave the last wave on 127 of the 132 SMs
    shared = mtf.launch_plan(100_000, N_SM, RESIDENCY["K9 shared N=6"])
    assert shared.tpb == 128 and shared.last_wave_blocks >= N_SM
    old = mtf.LaunchPlan(tpb=256, blocks=391, resident=2, n_sm=N_SM)
    assert old.waves > 1 and old.last_wave_blocks < N_SM


def test_launch_plan_refuses_a_kernel_that_fits_nowhere():
    with pytest.raises(ValueError, match="no block size"):
        mtf.launch_plan(4096, N_SM, {256: 0, 128: 0, 64: 0, 32: 0})


def _pattern(net, dialect):
    ckt = st.parse_netlist(net, dialect=dialect)
    return tmc._fused_tran_pattern(ckt, st.build_tensors(ckt), "pallas",
                                   "f32", "be", False, "cpu")


K9_DECKS = {"boost": (decks.BOOST_NET, "spicey"),
            "ring": (decks.RING_NET, "extended"),
            "BJT_NET": (decks.BJT_NET, "extended"),
            "TT diode": (decks.TT_NET, "extended"),
            "CJO diode": (decks.CJ_NET, "extended"),
            "BJT charge": (decks.QC_NET, "extended"),
            "JFET": (decks.JFET_NET, "extended"),
            "PNP": (decks.PNP_NET, "extended")}


@pytest.mark.parametrize("deck", sorted(K9_DECKS))
def test_k9_bytes_per_variant(deck):
    """K9's shared memory per variant, as mc_tran_nr.cu lays a variant
    out: the shared form's state-independent part (n x n), [A | b] (n x
    (n + 1)), x, b_lin and the device terms, then the carried state; the
    register form keeps the state-independent part in registers. Every
    phase-2 deck takes the register form and fits 32 variants a block."""
    p = _pattern(*K9_DECKS[deck])
    counts = mtf.k9_counts(p)
    n_c, n_l, n_s, n_d, n_m, n_q, has_d, has_q = counts
    assert p.nonlinear and mtf.k9_form_for(p.n) == "register"
    state = (n_c + n_l + n_d * (1 + has_d) + 2 * n_m + 2 * n_q * (1 + has_q)
             + n_s)
    shared = mtf.k9_bytes_per_variant("shared", p.n, *counts)
    register = mtf.k9_bytes_per_variant("register", p.n, *counts)
    assert shared == 4 * (p.n * p.n + p.n * (p.n + 1) + 3 * p.n + state)
    assert shared - register == 4 * p.n * p.n
    assert 32 * shared <= SMEM_MAX


@pytest.mark.parametrize("net", ["TRAN_NET", "EXT"])
def test_k8_bytes_per_variant(net):
    """K8's shared memory per variant: [A | I] (n x 2n), then the shared
    form's rhs and x and per C (L) v_prev (i_prev), the register form's
    rhs and per C (L) gc (gl) and v_prev (i_prev)."""
    text = decks.TRAN_NET if net == "TRAN_NET" else decks.EXT_TRAN
    p = _pattern(text, "extended" if net == "EXT" else "spicey")
    n, n_c, n_l = p.n, p.cst.shape[0], p.lst.shape[0]
    assert not p.nonlinear
    assert mtf.k8_bytes_per_variant("shared", n, n_c, n_l) == 4 * (
        2 * n * n + 2 * n + n_c + n_l)
    assert mtf.k8_bytes_per_variant("register", n, n_c, n_l) == 4 * (
        2 * n * n + n + 2 * (n_c + n_l))




@pytest.mark.parametrize("form", ["register", "shared"])
def test_wrappers_refuse_state_past_shared_memory(form):
    """A deck whose per-variant state would not fit 32 variants in one
    block is refused before anything is built: 32 x the bytes per variant
    above the block's shared memory."""
    assert mtf.fits_32_variants(mtf.k9_bytes_per_variant(
        form, 6, 1, 1, 1, 1, 0, 0, 0, 0))
    # N = 8 with 1,800 capacitors: the state alone is 7,200 bytes
    big = mtf.k9_bytes_per_variant(form, 8, 1800, 0, 0, 1, 0, 0, 0, 0)
    assert 32 * big > SMEM_MAX and not mtf.fits_32_variants(big)
    big8 = mtf.k8_bytes_per_variant(form, 8, 1800, 0)
    assert 32 * big8 > SMEM_MAX and not mtf.fits_32_variants(big8)


@pytest.mark.parametrize("form", ["register", "shared", "warp"])
def test_wrapper_checks_the_form_before_the_card(form):
    """A form the kernel has no instance of is refused by name; the
    register form past its largest instance too."""
    p = _pattern(*K9_DECKS["boost"])
    vs = torch.zeros((3, 2), dtype=torch.float32)
    values = torch.ones((p.n_rows, 4), dtype=torch.float32)
    if form == "warp":
        with pytest.raises(ValueError, match="no form 'warp'"):
            mtf._check_form(form, p.n, mtf.k9_form_for(p.n), "K9")
    else:
        assert mtf._check_form(form, p.n, "register", "K9") == form
    with pytest.raises(ValueError, match="no form 'register' at N=9"):
        mtf._check_form("register", 9, "shared", "K9")
    with pytest.raises(ValueError, match="CUDA"):
        mtf.mc_tran_fused_nr_cuda(vs, values, p, 0, form=form)
