"""Smoke run of the PyTorch/CUDA port (spicey_tpu_torch) on one NVIDIA GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It
needs one CUDA card and the CUDA toolkit (nvcc), imports nothing of JAX,
and exits nonzero on the first failure (nothing is caught). Phases, one
line each:

  1. build kernels K1 + K4 (csrc/gj_complex.cu), K2 + K3
     (csrc/gj_real.cu), K5 + K7 (csrc/mc_ac_fused.cu), K8
     (csrc/mc_tran_fused.cu), K9 (csrc/mc_tran_nr.cu), K10a + K10b
     (csrc/mxu_gj.cu) and K11 (csrc/stamp_real.cu) with nvcc, one
     process per source, all started
     together; print the build seconds and the card's name/power limit,
     and the register report of every K7 instance, every instance of
     K5's register and group forms, every register instance of K8 and
     K9 and of K3 (``cuobjdump --dump-resource-usage``: registers, stack,
     local memory), failing if one uses local memory (a spill of its
     register rows or systems);
  2. every kernel instantiation against its plain PyTorch version on the
     card, on the same inputs: K1 at N in {3, 8, 64, 128} with singular
     lanes and at the main path's shapes (the basics01 planes, the N = 64
     ladder's 2048 x 51 systems), K5 in every form that takes N (register,
     group) at every N from 1 to 16 on dense random systems with an
     all-zero, a zero-row and a NaN variant, on the extended deck and at
     the 1M x 201 yield, there also with a NaN and a singular variant, K2
     and K3 at N in {3, 8, 64, 128} with an all-zero and a
     zero-row system and at the main path's shapes (the boost converter's
     100k x 6 Newton systems, the RC transient's 1M x 3 matrices), K8 in
     every form that takes N (register, shared) on an extended linear
     deck, at the 1M x 201 RC transient and on RC batches of 4097 and
     999,999 variants with a NaN and a singular variant; ``valid``
     identical, f64 rtol 1e-12, f32 rtol 1e-5 (nvcc contracts
     multiply-adds into FMAs, the torch ops do not). The f32 ladder is too
     ill-conditioned for 1e-5 between two f32 eliminations; there K1 must
     be as accurate as the plain version against an f64 solve of the same
     planes (see ``k1_vs_plain``). K9 in every form that takes N
     (register, shared; each deck's N and device counts printed) at B =
     4096 on one deck per family
     (the boost converter on its own grid and on DIODE_SWITCH's 10 us
     grid, the bench's MOSFET ring, an NPN and a PNP amplifier, a JFET
     stage, the TT and CJO diode decks, the BJT-charge deck): ``valid``
     identical, every lane within 1e-4 x max|V| (f32 Newton iterates
     rounded differently), or, where a lane lands on the other side of a
     threshold, mean/min/max within 2e-4 with the count of such lanes; K4
     (the complex inverse) at N in {3, 8, 64, 128} and at the .noise
     shapes of phases 16 and 17 (901 x 11, 901 x 64), with an all-zero
     and a zero-row system, f64 at 1e-12 and f32 at 1e-5, and in f64 on
     the .noise planes themselves (the amplifier's and the ladder's 901
     systems at their operating points; in f32 these are beyond single
     precision at the GHz end, so no tolerance tells a right f32 inverse
     from a wrong one there); K7 (the fused full-solution AC) with the
     pattern's RHS and with external RHS planes, f64 and f32, on dense
     random systems at every group width (N in {1, 3, 4, 5, 8, 9, 15,
     16}) with an all-zero, a zero-row and a NaN variant
     (tests/fused_systems.py) and at phase 18's shape (f32 there by
     k1_vs_plain's rule: the ladder is ill-conditioned); K10a and
     K10b (the panel tier) at N in {40, 48, 64, 67, 100, 128}, each batch
     with an all-zero, a zero-row and an MNA zero-diagonal system, and at
     the solver sweep's N = 64 and 128 ladder planes (complex for K10b,
     their real part for K10a), and a complex f64 N = 128 batch of the
     resident slots + 7 (K10's shared-memory bytes equal ops/mxu.py's copy
     at N = 40-128, its workspace slots are the same at any batch):
     ``valid`` identical, f64 at 1e-12, f32 by k1_vs_plain's rule (the
     panel form's 1/pv - 1 step cancels, so two f32 summation orders
     differ beyond 1e-5); K1-K4 at N in {129, 256}
     in f64 and f32 (their global-workspace route) at 1e-12 / 1e-5; every
     tier of K1 (warp, block, panel) and K2 (thread, warp, block, panel),
     forced, in f64 and f32, at N in {3, 8, 16, 17, 31, 32, 33, 64, 128,
     129, 256} and each crossover of ops/gj.py and ops/gj_real.py +- 1,
     each batch with an all-zero, a NaN and a zero-column lane: ``valid``
     identical on every lane, f64 within 1e-12 x max|x|, f32 by
     k1_vs_plain's rule; and the panel and block tiers, with the same
     lanes and rule, on either side of the N past which the panel tier's
     [panel | C] lives in the workspace (``PANEL_SMEM_EDGE``) and at
     complex f64 N = 512 and real f64 N = 1024; every tier of K4 (warp,
     block, panel), forced, in f64 and f32 at ``K4_TIER_NS`` (N = 410:
     past complex f64's [panel | C] edge) with the same three lanes and
     rule; every tier of K3 (register, warp, block, panel),
     forced, in f64 and f32 at ``K3_TIER_NS`` with an all-zero system, a
     zero-row system and a NaN entry, by the same rule;
  3-8. the main path through the public entry points, each phase with
     every launch counter zeroed first and read after: the basics01
     golden on cuda (character-exact); the 1M-variant AC yield at f32
     (K5) against the analytic |1/(1+jwRC)| ensemble at rtol 2e-4, at f64
     at rtol 1e-9, and one on-device-sampled 1M run; the N = 64 RC ladder
     at f32 and f64 (K1), means within 5e-3, and f64 kernel against the
     f64 plain path on a 64-variant subset at 1e-9; the transient goldens
     on cuda (K2 on the nonlinear decks, K3 on the linear ones) against
     the NumPy oracle at tests/test_tran.py's tolerances, and a deck with
     no unknowns (empty .op, .ac and .tran, as on the CPU path); the
     1M-variant
     RC transient at f32 through K8 and through the batched loop (K3),
     at f64 (K3), and one on-device-sampled f32 run, against the exact
     backward-Euler recurrence at 2e-4 (f32) and 1e-9 (f64); the
     100k-variant boost converter at f64 and f32 (K11 and K2 every
     Newton pass), n_valid 100k, a 64-variant subset equal to the CPU path
     at 1e-9; in the transient goldens, the boost-100k runs and phase 19's
     batches K11 must launch exactly once per Newton pass of the time loop
     (``tran.newton_passes`` inside ``profiled()``), and phase 8 must run
     its tile form in f64 and f32;
  10-13. the nonlinear Monte-Carlo through K9 (f32, ``method="pallas"``)
     against the f64 loop (K2): the bench's ring oscillator at B = 4096
     (mean within 5e-3 x scale, a 64-variant f64 subset equal to the CPU
     path at 1e-9) and at 100k; the bench's switch_diode boost at 100k
     (a 64-variant subset) and at DIODE_SWITCH's grid (1001 steps, a
     4096-variant subset); BJT_NET with Q1's Is swept, 100k (a
     4096-variant subset); n_valid == B throughout; then the bench's
     ring and BJT-amplifier latency decks through ``simulate()`` on cuda,
     equal to the CPU path at 1e-9. The decks are
     ``spicey_tpu_torch/decks.py``'s;
  14-17. the operating point and the small-signal analyses through the
     public entry points on cuda, each equal to the CPU path at 1e-9: the
     bench's op/dc/tf deck through ``simulate()`` (K2); the MOSFET output
     characteristics as one 2D .dc of 25,551 points and ``op_batch`` of
     BJT_NET's bias over 100k Is variants (K2; n_valid == B, a 64-lane
     subset against the CPU path, Newton passes per lane); a two-stage BJT
     amplifier through ``simulate()`` with .op, .tf, ``.options acop``
     .ac and .noise over 901 frequencies (K2, K1, K4; failing unless K4
     ran its warp tier); the thermal noise of the N = 64 RC ladder over
     901 frequencies (K4, failing unless it ran its panel tier); each
     .noise run prints how many systems its residual guard solved again
     (K1);
  18-20. the batched corner sweeps through the public entry points on
     cuda, counted the same way: ``simulate_ac_batch(method="pallas")``
     of ``rc_ladder_netlist(14, 201)`` (N = 16) with all 14 R and 14 C at
     U(0.9, 1.1) x nominal over 16,384 variants x 201 frequencies through
     K7 in f64 (every system valid, 64 variants equal the CPU path and
     1024 the K1 route at 1e-9), then the N = 64 ladder of phase 5 with
     full solutions (K1, 2048 x 51, 64 variants against the CPU path);
     ``simulate_tran_batch`` of the RC deck (100k, K3), the boost
     converter (100k, K2) and the ring (4096, K2, Newton to convergence),
     each valid, 64 variants equal to the CPU path at 1e-9; and
     ``decks.STEP_DECK`` through ``simulate(method="pallas")``: .op, .ac
     and .tran over 1,001 ``.step`` lanes equal to the CPU path at 1e-9,
     each lane's .op the divider's closed form;
  21. flat decks past N = 128 through the public entry points on cuda,
     counted the same way, and failing unless flat-256 (K1 f64) and the
     N = 129 decks (K1 and K2 f64) ran the panel tier: ``mc_ac_stats`` of ``rc_ladder_netlist(254)``
     (N = 256, 16 variants x 51 frequencies, f64, K1; 2 variants equal
     the CPU path at 1e-9), and ``rc_ladder_netlist(127)`` (N = 129):
     ``simulate()`` .ac, ``simulate_op`` at 1 V DC and a ``simulate()``
     .tran of the same ladder under a pulse (K3 once), each equal to the
     CPU path at 1e-9; ``mc_tran_stats`` of the N = 64 ladder (2048
     variants) and of flat-256 (16) under the same pulse (K3 once, its
     panel tier required), 2 variants each equal to the CPU path at 1e-9;
  22. the solver sweep, K10's path: ``tools/profile_torch_solver.py``'s
     sweep at N = 32 (K1 and K2 must run their warp tier there), then at
     N = 64 and 128 (2 reps): K1/K2 in their chosen tier, K10a/K10b and
     ``torch.linalg.solve`` in systems/s on the ladder planes, K10 within
     1e-9 of K1/K2 in f64;
  23. K, T and B elements through the public entry points on cuda
     (``spicey_tpu_torch/decks.py``'s copies of the JAX package's test
     decks), each workload counted on its own (the counters zeroed just
     before its main-path calls and read just after, before any
     comparison run) with its wall (the median of three warm calls, each
     ending in synchronize()): (a) the transformer's ``simulate()`` .ac
     (K1 and K3's register form for M^-1; equal to the CPU path and to
     its closed form at 1e-9) and .tran (equal to the CPU path),
     ``mc_ac_stats`` over 100k (rload, l1, l2) at U(0.9, 1.1) x nominal
     (K1 and K3; every variant valid, the statistics equal to the CPU
     path's on the same 100k) and ``simulate_tran_batch`` over 16,384
     coupling coefficients k1 at U(0.3, 0.95), all valid, 64 variants
     equal to the CPU path; each transient launches K3's register form at
     least twice a call (M^-1 and the factor-once matrix) and K2 never;
     (b) the matched line's ``simulate_tran_batch`` over 16,384 (rl, Z0,
     Td) at U(25, 150), U(45, 55), U(4n, 6n), all valid, late v(b) =
     rl / (rs + rl) at 1e-6, 64 equal to the CPU path (K3 at least once a
     call, K2 never), and its .ac delay phase -w Td through
     ``simulate()`` (K1); (c) the uA741 inverting amplifier's ``.step``
     of rfb over 1,001 values (K2 every Newton pass; all valid, the gain
     -rfb/rin x 50 mV at 5e-3, 64 lanes equal to the CPU path) and its
     .op, acop .ac, .noise and .tran through ``simulate()``, each equal to
     the CPU path (K1, K2, K4; two named series at their recorded atol);
     (d) ``mc_tran_stats`` of the tanh amplifier over 100k loads (K2
     every pass, K3 never: a B deck never factors once; n_valid == B,
     the statistics equal to the CPU path's on the same 100k), and with
     ``method="pallas"`` at f32, which must launch neither K8 nor K9 and
     give the ``method="gj"`` f32 statistics at 2e-5;
  24. the post-analyses through ``simulate()`` on cuda (decks in
     ``spicey_tpu_torch/decks.py``), each workload counted and timed as in
     phase 23 (the seconds-long uA741 workloads (a), (b) and (d) with one
     timed call, as phase 23's amplifier), none launching K5, K7, K8 or K9: (a) the uA741 amplifier's
     ``.pz`` and ``.sens`` (K2's panel tier at N = 36, K1, K4): poles and
     zeros equal to the CPU path's as sets, every sensitivity at 1e-9
     with an atol of 1e-12 of the volts per 1% change over its own p / 100,
     d v(out)/d rfb within 2% of -v(in)/rin and within 1e-3 of a central
     difference of two card operating points at rfb +-0.1%, the pole
     nearest the origin within 10% of 2 pi x the -3 dB frequency of the
     deck's acop .ac; (b) its ``.four 10k v(out)`` over a 200 us
     transient: the fundamental within 3% of 0.2 V, THD under 1%, equal to
     the CPU path; (c) ``decks.STEP_MEAS``: three ``.meas tran`` lines over
     STEP_DECK's 1,001 lanes (K3's register form, K1), every value
     finite, lanes 0, 500 and 1000 equal to ``simulate()`` of the deck at
     that r1 alone, 64 lanes equal to the CPU path; (d)
     ``decks.UA741_CONTROL``, every post-analysis and a ``.control`` tail:
     its text equal to the CPU path's (numbers to their last printed
     digit), the binary rawfile it writes read back bit for bit, then
     ``python -m spicey_tpu_torch --raw --binary`` as a subprocess on the
     card with jax blocked, its standard output equal to the in-process
     CLI's, which runs inside ``profiled()`` and must name the pz, sens,
     four, meas and control spans;
  25. the Schur tier and the time-parallel transient (ROADMAP items 6 and
     3) through the public entry points on cuda, each workload counted on
     its own, none launching K4, K5, K7, K8 or K9: (a)
     ``decks.schur_ladder_netlist(64)`` and ``(256)`` (N = 386 / 1538, 64 /
     256 blocks of 4, interfaces of 130 / 514) with ``.ac dec 40 1 1e6``
     (241 points) through ``method="schur"``, the default ``"gj"`` (its
     automatic dispatch past N = 128) and the dense ``"pallas"`` (K1's
     panel tier at N = 386 / 1538), each equal to the CPU path's Schur
     solve at rtol 1e-9 / atol 1e-12 of the largest value (ladder-256 at
     its 7 decade points), walls side by side, the Schur routes failing
     unless K1's multi entry ran; (b) the 64-stage board with a clamp diode
     per stage (``decks.SCHUR_CLAMP``) through ``simulate_op`` and a
     50-step ``simulate_tran``, forced Schur, Newton on K2's multi entry,
     equal to the CPU path; (c) ``mc_ac_stats`` of the 64-stage board over
     256 variants (r1, c1 of every 4th stage), Schur against the dense
     route on the card and 16 variants against the CPU path; then K1's and
     K2's multi entry on the block systems (a) and (b) handed it
     (captured from the run), f64 at 1e-12 and f32 as accurate as the
     plain f32 version against an f64 solve, valid identical, timed beside
     the plain version, ``torch.linalg.solve`` and the bound (the JSON
     line's multi entries), and at ``tools/profile_torch_schur.py``'s
     shapes; (d) ``mc_tran_stats`` of ``decks.tp_rlc_netlist("20m")``
     (tests/test_mc.py:343's RLC, 100,000 steps) over 16 variants, BE and
     trap, through the time-parallel core (K3 once), timed, and over the
     first ``TP_LOOP_STEPS`` steps against the sequential loop on the card
     (mean, max, min at 1e-9, std at 1e-7; the loop is launch-bound, ~0.5
     ms a step), and K3 at that path's shape against the plain inverse,
     timed; (e) ``simulate_tran_batch`` full trajectories (256 x 2,001
     steps), tp against the loop at 1e-9; (f) the crossover sweep
     (``profile_torch_schur.crossover_sweep``): tp and loop walls at S in
     {201, 10k, 100k} x B in {16, 1k, 16k}, the loop to 10k steps;
  26. sensitivity, fitting and the adaptive transient (ROADMAP item 9)
     through the public entry points on cuda
     (``tools/profile_torch_sens.py:phase26``), each workload on its own
     counters: (a) ``sensitivity_ac`` of the N = 66 ladder, 8 targets,
     against the CPU path, forward-mode AD through the plain GJ on the
     card and a central difference; (b) ``sensitivity_tran`` of
     ``decks.BOOST_FINE`` (1001 points, 3 targets); (c) of
     ``decks.TRANSFORMER_TRAN`` (l1, rload); (d) ``fit_ac`` of the ladder's
     r32 and c32 from +20%, 200 Adam steps; (e) ``fit_tran`` of the RC
     deck of tests/test_fit.py:44, 150 steps; (f) ``simulate_tran_adaptive``
     of ``decks.BOOST_NET`` and of ``decks.UA741_AMP``'s first 5 ns,
     counts equal to the CPU path's, and its first 20 ns, voltages only
     (the counts drift there); sensitivities and the boost's
     trajectory at rtol 1e-9 / atol 1e-12 of each series' max, the fits'
     first 20 losses at 1e-6 and their values against the truth (the CPU
     references computed in worker processes while the card runs) and
     the primal of (e) timed. K1/K2/K3 must launch for
     each workload's forward, tangent and adjoint dispatches (the
     derivative rules of ops/linsolve.py, ``RULE_CALLS``; every K1/K2
     launch one of them), the adaptive runs plain K2, and no K4-K10 may
     launch;
  27. the device mesh (ROADMAP item 9) through the four batched entry
     points on cuda (``tools/profile_torch_mesh.py:phase27``), each call
     on its own counters: ``make_mesh()`` holds exactly the card's
     devices; yield-64k (``mc_ac_stats`` f32 pallas, K5), tran-rc-64k
     (K8), boost-8k (K9), tp-rlc-32 (the time-parallel core, K3),
     batch-ac-4096 (``simulate_ac_batch``, K7 and K1) and
     diode-switch-1024 (``simulate_tran_batch``, the K2 loop) unsharded,
     with ``device_put=sharder(make_mesh())`` (bit for bit, the same
     launches) and on meshes that repeat the card, ``{"batch": 4}`` and,
     for ``simulate_ac_batch``, ``{"batch": 2, "freq": 2}`` (equal to the
     unsharded call at the JAX mesh tests' tolerances, each kernel
     launched once per piece, K2 once per pass of each piece), the walls
     sharded and unsharded; then ``warmup(full=True)`` in a new process
     beside the CLI's cold start of phase 24;
  28. K11, the time loop's assembly, against the index_add_ chain it
     replaced on the same values (``tools/profile_torch_k11.py:phase28``):
     the boost's 1M-lane pass at N = 6 in f64 and f32, in the tile form
     and the entry form, bit for bit against the chain on the card (no
     scatter call there adds two contributions to one entry), and the
     uA741's 1,024-lane pass at N = 36 in the entry form, bit for bit
     against the chain on the CPU (the card's atomics add a call's
     duplicate entries in any order); each form and the chain timed with
     CUDA events beside K11's bytes bound (values read once, A and b
     written once, at 3.35 TB/s); the boost's rows are K11's JSON
     entries, and phase 23 (c) must run the entry form in the uA741's
     .tran;
  9. every instantiation launched during 3-8 and 10-27 (printed after
     them; the f32 instances of K4 and K7 are on no main path and are
     checked in phase 2 and timed here only); CUDA-event times of each
     kernel, its plain version and, where one PyTorch call computes the
     same function, that call (``torch.linalg.solve`` for K1/K2,
     ``torch.linalg.inv`` for K3 and, on complex128, K4), at the main
     path's shapes (K3 in every tier that takes N at the four shapes where
     a transient inverts its matrix once: the tran-1M loop's 1M x 3 in f32
     and f64, a ladder-64 Monte-Carlo transient's 2048 x 64, phase 21's
     N = 129 and flat-256's 16 x 256 as transients, ``k3_shapes``, each
     tier first held to the plain inverse of the same matrices, valid
     identical and within TOL, the chosen tier's error in the JSON line;
     K4 f64 at both .noise shapes, K4 f32
     at the amp's,
     each in every tier that takes N; K7 f64 and f32 at phase 18's, its
     library call ``torch.linalg.solve`` on the same systems
     pre-assembled as complex planes), beside the kernel's bound: the
     larger of its bytes over 3.35 TB/s and its
     operations over the H100's peak for the type (67 TFLOP/s in f32
     outside the tensor cores, 67 TFLOP/s in f64 on them; NVIDIA's H100
     SXM data sheet), the operations those of the cheapest direct method
     (``solve_flops``, ``inverse_flops``); every form of K5 at the
     yield-1M shape; K8 in every form at tran-1M; K9 in every form
     against its plain version at each main-path shape of phases 10-12
     (the boost on both grids, the ring at 100k and 4096, BJT_NET; the
     same tolerances as in phase 2), with the Newton passes per lane
     there and each form's time at each, its plain version's time at
     boost-100k, and the bound, its operations counted from the lane
     passes its plain version runs on the same inputs and the pattern's
     device tables (``k9_ops``); each K8 and K9 time beside its launch
     plan (threads a block, blocks, resident blocks per SM, waves); every
     tier of K1 and K2 and K10a/K10b (from N = 40) in f32
     and f64 at the sweep's N = 16, 32, 64 and 128 shapes, and every tier
     of K1 and K2 f64 at phase 21's N = 256 planes and on random systems
     at N = 512 (64 of them) and 1024 (16), each beside the plain
     version, ``torch.linalg.solve`` on the same planes and the bound, with
     the share of the bound reached (the JSON line keeps K10 at N = 64);
     K11 at phase 28's boost shape.
     Every phase prints the launches of each tier of K1-K4 and of
     each form of K5, K8 and K9 beside the kernels' (phase 4 fails unless
     the yield ran K5's register form, phase 7 unless tran-1M ran K8's and
     K3's, phases 6, 19 and 20 unless K3 ran its register form, phases
     10-12 unless K9 ran its register form, phase 16 unless the amp's .ac
     ran K1's warp tier, phase 21 unless the N = 129 transient ran K3's
     panel tier); the JSON line adds them to K1's, K2's, K3's, K4's, K5's,
     K8's, K9's and K11's entries as ``tiers``.

Then a JSON line of the kernels, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BIG = 1_000_000
RC_NET = ("AC bench\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 100 1 100\n.end\n")
BASICS01 = ("Demo of a simple AC circuit\nv1 1 0 dc 0 ac 1\nr1 1 2 30\n"
            "c1 2 0 100u\n.ac dec 100 1 100\n.end\n")
EXT_NET = """* extended fused-tier deck
I1 0 a 1m ac 2 30
R1 a 0 1k
G1 0 b a 0 2m
R2 b 0 500
E1 c 0 b 0 3
R3 c d 100
C1 d 0 1u
V1 e 0 ac 1
R4 e d 200
F1 0 b V1 0.5
H1 f 0 V1 50
R5 f d 300
L1 d 0 10m
.ac dec 10 10 1e5
.end
"""
BOOST_B = 100_000
RING_B = 4096
GOLDENS = ("RC_PULSE", "TWO_PROBES", "SERIES_RLC", "SWITCH_VT_VH",
           "VSWITCH_PWL", "BOOST_CONVERTER", "DIODE_SWITCH")
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TAG = {torch.float64: "f64", torch.float32: "f32"}
# the largest N whose [panel | C] fits in one block's shared memory in the
# panel tier of K1 (complex) and K2 (real), gj_panel.cuh:smem_bytes; past
# it [panel | C] lives in the workspace (gj_panel.cuh:PANEL_GLOBAL)
PANEL_SMEM_EDGE = {(True, torch.float64): 401, (True, torch.float32): 822,
                   (False, torch.float64): 822, (False, torch.float32): 1629}
# (complex, dtype, N) of phase 2's cases on either side of that edge
PAST_PANEL_SMEM = [(c, dt, n) for (c, dt), e in PANEL_SMEM_EDGE.items()
                   for n in (e, e + 1)] + [(True, torch.float64, 512),
                                           (False, torch.float64, 1024)]
# K4's tiers in phase 2: each tier edge, the .noise shapes' N (11, 64),
# past 128 and past complex f64's [panel | C] edge
K4_TIER_NS = (1, 3, 11, 16, 31, 32, 33, 64, 128, 129, 256, 410)
# K3's tiers in phase 2: each tier edge, the transients' N (3, 64, 129,
# 256)
K3_TIER_NS = (1, 3, 8, 9, 16, 17, 32, 33, 64, 129, 256)
# phase 25 (d): the sequential loop's horizon (the time-parallel route
# runs 100,000 steps)
TP_LOOP_STEPS = 5_000
# the H100 SXM's peaks (NVIDIA data sheet): HBM3 bytes/s; FLOP/s for the
# type: f32 outside the tensor cores (their TF32 rounds the operands), f64
# on them (full f64; 34 TFLOP/s outside them)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def solve_flops(n: int, complex_: bool = False) -> float:
    """Real flops of one dense n x n solve by the cheapest direct method:
    an LU factorization (2n^3/3) and two triangular solves (2n^2); a
    complex multiply-add is four real ones."""
    return (4.0 if complex_ else 1.0) * (2.0 * n ** 3 / 3.0 + 2.0 * n * n)


def inverse_flops(n: int, complex_: bool = False) -> float:
    """Real flops of one dense n x n inverse: n^3 multiply-adds, as an
    in-place Gauss-Jordan inverse does them."""
    return (4.0 if complex_ else 1.0) * 2.0 * n ** 3


# K9's operations per device, counted from csrc/mc_tran_nr.cu (adds,
# multiplies, divisions, exponentials and powers one each; compares,
# selects and clamps none): per Newton pass each device's stamp and model
# evaluation (a switch's blend and hysteresis test; a diode's Shockley
# companion, + its junction charge; a level-1 MOSFET; an Ebers-Moll BJT, +
# its two junction charges); per step each linear RHS term (a source, a C,
# an L) and each device's state commit
K9_PASS_OPS = {"s": 8, "d": 15, "dchg": 31, "m": 37, "q": 57, "qchg": 84}
K9_STEP_OPS = {"src": 2, "c": 4, "l": 5, "d": 1, "dchg": 22, "m": 2, "q": 2,
               "qchg": 62}


def k9_ops(pattern, lane_passes: float, lane_steps: float) -> float:
    """K9's operations for ``lane_passes`` Newton passes over
    ``lane_steps`` (variant, step) pairs of ``pattern``: per pass the
    elimination (``solve_flops``), column N and the commit of x (5 per
    unknown) and the device stamps; per step the linear RHS and the state
    commit (K9_PASS_OPS, K9_STEP_OPS)."""
    n = pattern.n
    ns, nd, nm, nq = (t.shape[0] for t in (pattern.slist, pattern.dlist,
                                           pattern.mlist, pattern.qlist))
    dchg, qchg = int(pattern.dchg.shape[0] > 0), int(pattern.qchg.shape[0]
                                                      > 0)
    p, q = K9_PASS_OPS, K9_STEP_OPS
    per_pass = (solve_flops(n) + 5 * n + ns * p["s"]
                + nd * (p["d"] + dchg * p["dchg"]) + nm * p["m"]
                + nq * (p["q"] + qchg * p["qchg"]))
    per_step = (q["src"] * pattern.bsrc.shape[0] + q["c"] * pattern.cst.shape[0]
                + q["l"] * pattern.lst.shape[0]
                + nd * (q["d"] + dchg * q["dchg"]) + nm * q["m"]
                + nq * (q["q"] + qchg * q["qchg"]))
    return lane_passes * per_pass + lane_steps * per_step


def k8_step_ops(pattern) -> float:
    """K8's operations per (variant, step): the product over the RHS rows
    (2 per element), each source term (2), each C (its RHS term 3, its
    state 1) and each L (2 and 3)."""
    n_b = bin(pattern.b_rows).count("1")
    return (2 * pattern.n * n_b + 2 * pattern.bsrc.shape[0]
            + 4 * pattern.cst.shape[0] + 5 * pattern.lst.shape[0])


def bound(flops: float, nbytes: float, dtype: torch.dtype
          ) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate, in ms."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tran_ladder(sections: int) -> str:
    """``decks.rc_ladder_netlist(sections)`` under a pulse, as a transient
    (phase 21's N = 129 deck and phase 9's K3 shapes (b)-(d))."""
    from spicey_tpu_torch.decks import rc_ladder_netlist
    return rc_ladder_netlist(sections).replace(
        "v1 in 0 dc 0 ac 1", "v1 in 0 PULSE(0 5 0 1n 1n 50u 100u)").replace(
        ".ac lin 51 1 10k", ".tran 1u 50u")


def factor_matrix(net: str, over: dict | None, dtype: torch.dtype,
                  dev) -> torch.Tensor:
    """The (B, N, N) matrix a linear transient of ``net`` inverts once
    (backward Euler), B the length of the override arrays (1 without)."""
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import tran as ttran
    from spicey_tpu_torch.analysis.batch import _batch_values
    from spicey_tpu_torch.ir.circuit import effective_time_step
    ckt = st.parse_netlist(net)
    t = st.build_tensors(ckt)
    dt, _ = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    over = over or {}
    nb = len(next(iter(over.values()))) if over else 1

    def vals(base, names):
        return torch.as_tensor(_batch_values(base, names, over, nb),
                               dtype=dtype, device=dev)

    arr = ttran.tran_arrays(t, dev, dtype, r_vals=vals(t.r_vals, t.r_names),
                            c_vals=vals(t.c_vals, t.c_names),
                            l_vals=vals(t.l_vals, t.l_names))
    return ttran.linear_system_matrix(t.nvar, (nb,), dtype, arr,
                                      arr["c_vals"] / dt, dt).contiguous()


def k3_shapes(seed: int, dev, which: str = "abcd"
              ) -> list[tuple[str, torch.dtype, torch.Tensor]]:
    """(label, dtype, matrices) of K3's main-path shapes named in
    ``which``, each drawn from its own generator seeded by ``seed``: (a)
    the tran-1M loop's RC matrices (``decks.TRAN_NET``, R1 and C1 at U(1,
    1.2) x nominal), 1M x 3, f32 and f64; (b) ``tran_ladder(62)``, the
    interconnect Monte-Carlo transient, r1 at 101 x U(1, 1.2), 2048 x 64;
    (c) ``tran_ladder(127)``, one deck through ``simulate()``, 1 x 129; (d)
    ``tran_ladder(254)``, flat-256's deck as a transient, 16 x 256; (b)-(d)
    in f64."""
    from spicey_tpu_torch.decks import TRAN_NET
    out = []
    if "a" in which:
        rng = np.random.default_rng(seed)
        big = 1_000_000
        rc_over = {"R1": 1e3 * (1 + 0.2 * rng.random(big)),
                   "C1": 1e-6 * (1 + 0.2 * rng.random(big))}
        out += [(f"a RC tran ({big}, 3)", dt,
                 factor_matrix(TRAN_NET, rc_over, dt, dev))
                for dt in (torch.float32, torch.float64)]
    f64 = torch.float64
    for k, (label, sections, nb) in enumerate((
            ("b ladder-64 MC tran", 62, 2048), ("c N=129 tran", 127, 1),
            ("d flat-256 tran", 254, 16)), start=1):
        if label[0] not in which:
            continue
        rng = np.random.default_rng(seed + k)
        over = None if nb == 1 else {
            "r1": 101.0 * (1 + 0.2 * rng.random(nb))}
        A = factor_matrix(tran_ladder(sections), over, f64, dev)
        out.append((f"{label} ({nb}, {A.shape[1]})", f64, A))
    return out


_T0 = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of the run, with the seconds since the script started."""
    print(f"[{phase}] {msg} (at {time.perf_counter() - _T0:.1f} s)",
          flush=True)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one warm
    run (none with ``warm=False``, for the plain versions at large N: torch
    ops need no build), by CUDA events around the whole batch of runs."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(got: torch.Tensor, want: torch.Tensor, rtol: float,
                what: str) -> float:
    """Assert |got - want| <= rtol * (|want| + max|want|); return the max
    absolute difference."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    bad = (got - want).abs() > rtol * (want.abs() + scale)
    if bool(bad.any()):
        raise AssertionError(f"{what}: max abs err {err:.3e} above rtol "
                             f"{rtol:g} (scale {scale:.3e})")
    return err


def pair_nearest(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``got`` reordered so that each entry is the nearest unpaired value
    to the ``want`` entry at its position, closest pairs first (poles and
    zeros, as eigenvalues, come in no order of their own)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{got.shape} values against {want.shape}")
    dist = np.abs(got[:, None] - want[None, :])
    out = np.empty_like(want)
    free_g = np.ones(len(got), bool)
    free_w = np.ones(len(want), bool)
    for _ in range(len(want)):
        d = np.where(free_g[:, None] & free_w[None, :], dist, np.inf)
        i, j = np.unravel_index(np.argmin(d), d.shape)
        out[j] = got[i]
        free_g[i] = free_w[j] = False
    return out


def text_gap(got: str, want: str) -> tuple[int, float]:
    """(numbers that differ, the largest relative gap among them) between
    two texts that must agree in everything but their printed numbers;
    raises where they differ otherwise."""
    gl, wl = got.splitlines(), want.splitlines()
    if len(gl) != len(wl):
        raise AssertionError(f"{len(gl)} lines against {len(wl)}")
    n, gap = 0, 0.0
    for g_line, w_line in zip(gl, wl):
        if g_line == w_line:
            continue
        gt, wt = re.split(r"[\s,]+", g_line), re.split(r"[\s,]+", w_line)
        if len(gt) != len(wt):
            raise AssertionError(f"{g_line!r} against {w_line!r}")
        for a, b in zip(gt, wt):
            if a != b:
                fa, fb = float(a), float(b)
                n += 1
                gap = max(gap, abs(fa - fb) / max(abs(fb), 1e-300))
    return n, gap


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain K10 versions' products must be true f32, as the kernel's
    # are (PyTorch's default; set, not assumed)
    torch.backends.cuda.matmul.allow_tf32 = False
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import ac as tac
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.analysis import mc as tmc
    from spicey_tpu_torch.analysis import noise as tnoise
    from spicey_tpu_torch.analysis import tran as ttran
    from spicey_tpu_torch.decks import (AMP_DECK, BJT_AMP_DECK, BJT_NET,
                                        BOOST_FINE, BOOST_NET, CJ_NET,
                                        EXT_TRAN, JFET_NET, LADDER_NOISE,
                                        MOS_IV_DECK, OPDCTF_DECK, PNP_NET,
                                        QC_NET, RING_DECK, RING_NET,
                                        STEP_DECK, TRAN_NET, TT_NET,
                                        rc_ladder_netlist)
    from spicey_tpu_torch.ir.circuit import (effective_time_step,
                                             sample_source_values)
    from spicey_tpu_torch.ops import (_build, gj, gj_real, linsolve,
                                      mc_ac_fused, mc_tran_fused, mxu,
                                      stamp_real)
    from spicey_tpu_torch.utils import profiling
    from tools import profile_torch_solver as solver
    from tests.fixtures import netlists
    from tests.fused_systems import FREQS, dense_pattern, dense_values
    from tests.oracle import oracle_tran

    dev = torch.device("cuda")
    kernels = {k.name: k for k in
               list(gj.K1.values()) + list(mc_ac_fused.K5.values())
               + list(gj_real.K2.values()) + list(gj_real.K3.values())
               + list(mc_tran_fused.K8.values())
               + list(mc_tran_fused.K9.values())
               # the .noise path runs K4 in f64 and the batch AC K7 in
               # f64; their f32 instances exist to be held against the TPU
               # kernels and run in phases 2 and 9 only
               + [gj.K4[torch.float64], mc_ac_fused.K7[torch.float64]]
               # K10's path is the solver sweep of phase 22
               + list(mxu.K10a.values()) + list(mxu.K10b.values())
               # K1's and K2's multi entry, the Schur tier's block solves
               # (phase 25, f64; f32 runs there against the plain version)
               + [gj.K1_MULTI[torch.float64], gj_real.K2_MULTI[torch.float64]]
               # K11, the batched time loop's assembly, every Newton pass
               + list(stamp_real.K11.values())}
    err = {name: 0.0 for name in kernels}
    # name -> (kernel ms, plain ms, library ms or None, bound ms, bound by)
    ms: dict[str, tuple] = {}
    shape: dict[str, str] = {}  # name -> the shape of its ms entry
    launches = {name: 0 for name in kernels}

    # the tiers of K1, K2 and K4: name -> that instantiation's tier
    # counters
    tier_counts = {gj.K1[dt].name: gj.K1_TIERS[dt] for dt in gj.K1}
    tier_counts.update({gj_real.K2[dt].name: gj_real.K2_TIERS[dt]
                        for dt in gj_real.K2})
    tier_counts.update({gj.K4[dt].name: gj.K4_TIERS[dt] for dt in gj.K4})
    tier_counts.update({gj_real.K3[dt].name: gj_real.K3_TIERS[dt]
                        for dt in gj_real.K3})
    # K5's, K8's and K9's forms, counted as their tiers
    tier_counts.update({mc_ac_fused.K5[dt].name: mc_ac_fused.K5_FORMS[dt]
                        for dt in mc_ac_fused.K5})
    tier_counts[mc_tran_fused.K8[torch.float32].name] = \
        mc_tran_fused.K8_FORMS
    tier_counts[mc_tran_fused.K9[torch.float32].name] = \
        mc_tran_fused.K9_FORMS
    tier_counts.update({stamp_real.K11[dt].name: stamp_real.K11_FORMS[dt]
                        for dt in stamp_real.K11})
    tier_launches = {name: dict.fromkeys(c, 0)
                     for name, c in tier_counts.items()}

    def zero_counts() -> None:
        for k in kernels.values():
            k.launches = 0
        for c in tier_counts.values():
            c.update(dict.fromkeys(c, 0))

    def counted(phase: str, expect: list, tiers: tuple = ()) -> None:
        """Add this phase's launches to the totals and fail unless every
        kernel it must drive launched, and every (kernel, tier) of
        ``tiers`` ran that tier; then zero the counters for the next
        phase."""
        got = {name: k.launches for name, k in kernels.items()}
        for name, n in got.items():
            launches[name] += n
        for name, c in tier_counts.items():
            for tier, n in c.items():
                tier_launches[name][tier] += n
        missing = [k.name for k in expect if got[k.name] == 0]
        missing += [f"{k.name} {tier}" for k, tier in tiers
                    if tier_counts[k.name][tier] == 0]
        if missing:
            raise AssertionError(f"{phase}: never launched {missing}")
        say(phase, "launches " + json.dumps(
            {n: c for n, c in got.items() if c}) + "; tiers " + json.dumps(
            {name: {t: n for t, n in c.items() if n}
             for name, c in tier_counts.items() if any(c.values())}))
        zero_counts()

    # ---- 1. build --------------------------------------------------------
    t_start = t0 = time.perf_counter()
    _build.build(list(_build.LIBRARIES))
    for mod in (gj, gj_real, mc_ac_fused, mc_tran_fused, mxu, stamp_real):
        mod.load_library()
    mc_tran_fused.load_nr_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("1 build", f"{time.perf_counter() - t0:.1f} s "
        f"{ {k: round(v, 2) for k, v in _build.build_seconds().items()} } "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")
    # K7's register report: each lane's row lives in registers, so any
    # local memory in an instance is a spill
    dump = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"),
         "--dump-resource-usage", str(_build._target("mc_ac_fused")[1])],
        capture_output=True, text=True, check=True).stdout.splitlines()
    k7_usage, k5_usage = {}, {}
    for line, usage in zip(dump, dump[1:]):
        res = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", usage))
        inst = re.search(r"mc_ac_fused_x_kernelI([df])Li(\d+)ELb(\d)", line)
        if inst:
            dt, g, ext = inst.groups()
            k7_usage[(f"K7 f{'64' if dt == 'd' else '32'} group {g} "
                      f"{'external' if ext == '1' else 'pattern'} RHS")] = res
        # K5's register form (N) and group form (G)
        inst = re.search(r"mc_ac_fused_(reg|group)_kernelI([df])Li(\d+)E",
                         line)
        if inst:
            form, dt, w = inst.groups()
            k5_usage[(f"K5 f{'64' if dt == 'd' else '32'} "
                      f"{'register N' if form == 'reg' else 'group G'}="
                      f"{w}")] = res
    if len(k7_usage) != 2 * 2 * len(mc_ac_fused.K7_GROUPS) or len(
            k5_usage) != 2 * (mc_ac_fused.REG_MAX_N
                              + len(mc_ac_fused.K7_GROUPS)):
        raise AssertionError(f"K5/K7 register report: {len(k5_usage)} / "
                             f"{len(k7_usage)} instances found")
    usage = {**k7_usage, **k5_usage}
    for inst, res in sorted(usage.items()):
        say("1 registers", f"{inst}: {res['REG']} registers, stack "
            f"{res['STACK']} B, local {res['LOCAL']} B")
    # K8's and K9's register forms: each variant's system in registers
    for lib, pat, label in (
            ("mc_tran_fused", r"mc_tran_fused_reg_kernelILi(\d+)E", "K8"),
            ("mc_tran_nr", r"mc_tran_nr_kernelILi([1-9]\d*)E", "K9")):
        dump = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"),
             "--dump-resource-usage", str(_build._target(lib)[1])],
            capture_output=True, text=True, check=True).stdout.splitlines()
        found = {}
        for line, res in zip(dump, dump[1:]):
            inst = re.search(pat, line)
            if inst:
                found[f"{label} f32 register N={inst.group(1)}"] = dict(
                    re.findall(r"(REG|STACK|LOCAL):(\d+)", res))
        if len(found) != mc_tran_fused.REG_MAX_N:
            raise AssertionError(f"{label} register report: {len(found)} "
                                 "instances found")
        usage.update(found)
        for inst, res in sorted(found.items(),
                                key=lambda kv: int(kv[0].split("=")[1])):
            say("1 registers", f"{inst}: {res['REG']} registers, stack "
                f"{res['STACK']} B, local {res['LOCAL']} B")
    # K3's register form: each system's [A | I] in registers; the wrapper
    # chooses every instance (N <= K3_REG_INSTANCES), so local memory in
    # one is a spill on the main path
    dump = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"),
         "--dump-resource-usage", str(_build._target("gj_real")[1])],
        capture_output=True, text=True, check=True).stdout.splitlines()
    k3_usage = {}
    for line, res in zip(dump, dump[1:]):
        inst = re.search(r"gj_real_inv_reg_kernelI([df])Li(\d+)E", line)
        if inst:
            dtype = torch.float64 if inst.group(1) == "d" else torch.float32
            k3_usage[(dtype, int(inst.group(2)))] = dict(
                re.findall(r"(REG|STACK|LOCAL):(\d+)", res))
    if len(k3_usage) != 2 * gj_real.K3_REG_INSTANCES:
        raise AssertionError(f"K3 register report: {len(k3_usage)} "
                             "instances found")
    for (dtype, n), res in sorted(k3_usage.items(),
                                  key=lambda kv: (TAG[kv[0][0]], kv[0][1])):
        say("1 registers", f"K3 {TAG[dtype]} register N={n}: {res['REG']} "
            f"registers, stack {res['STACK']} B, local {res['LOCAL']} B")
        usage[f"K3 {TAG[dtype]} register N={n}"] = res
    spilled = [i for i, r in usage.items() if int(r["LOCAL"])]
    if spilled:
        raise AssertionError(f"K3/K5/K7/K8/K9 instances with local memory: "
                             f"{spilled}")

    # ---- 2. kernels against plain versions ------------------------------
    rng = np.random.default_rng(SEED)

    def k1_vs_plain(planes, dtype, what, main_shape, conditioned=False):
        """K1 against the plain version. ``conditioned``: the systems are
        ill-conditioned enough that two f32 eliminations rounding in a
        different order (FMA or not) legitimately differ by more than
        rtol; then K1 must be as accurate as the plain f32 version: its
        error against an f64 solve of the same planes at most twice the
        plain version's, plus rtol."""
        xr, xi, v = gj.gj_solve_planes_cuda(*planes)
        pr, pi, pv = linsolve.gj_solve_planes(*planes)
        if not torch.equal(v, pv):
            raise AssertionError(f"K1 {what}: valid flags differ")
        if conditioned:
            tr, ti, _ = linsolve.gj_solve_planes(*[p.double()
                                                   for p in planes])
            scale = float(tr[pv].abs().max())
            e_plain = float(torch.maximum((pr.double() - tr)[pv].abs().max(),
                                          (pi.double() - ti)[pv].abs().max()))
            e_k1 = float(torch.maximum((xr.double() - tr)[pv].abs().max(),
                                       (xi.double() - ti)[pv].abs().max()))
            if e_k1 > 2 * e_plain + TOL[dtype] * scale:
                raise AssertionError(
                    f"K1 {what}: error vs f64 {e_k1:.3e}, plain's "
                    f"{e_plain:.3e}")
            say("2 compare", f"K1 {what}: error vs an f64 solve {e_k1:.3e}"
                f", the plain f32 version's {e_plain:.3e}")
            e = float(torch.maximum((xr - pr)[pv].abs().max(),
                                    (xi - pi)[pv].abs().max()))
        else:
            e = max(check_close(xr[pv], pr[pv], TOL[dtype], f"K1 {what} re"),
                    check_close(xi[pv], pi[pv], TOL[dtype],
                                f"K1 {what} im"))
        if main_shape:
            name = gj.K1[dtype].name
            err[name] = max(err[name], e)
        return e, int(pv.sum()), pv.numel()

    for dtype in (torch.float64, torch.float32):
        for n in (3, 8, 64, 128):
            B = 512
            Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
            Ai = rng.standard_normal((B, n, n))
            br, bi = rng.standard_normal((2, B, n))
            Ar[0] = Ai[0] = 0.0             # all-zero system
            Ar[1, n // 2] = Ai[1, n // 2] = 0.0  # one zero row
            planes = [torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in (Ar, Ai, br, bi)]
            e, nv, nt = k1_vs_plain(planes, dtype, f"{TAG[dtype]} N={n}",
                                    False)
            if nv != nt - 2:
                raise AssertionError(f"K1 N={n}: {nv}/{nt} valid")
            say("2 compare", f"K1 {TAG[dtype]} N={n} B={B} valid {nv}/{nt} "
                f"max_abs_err {e:.3e}")

    def k4_vs_plain(Ar, Ai, dtype, what, main_shape):
        """K4 against its plain version: ``valid`` identical, the inverses
        at rtol."""
        mr, mi, v = gj.gj_inverse_planes_cuda(Ar, Ai)
        pr, pi, pv = linsolve.gj_inverse_planes(Ar, Ai)
        if not torch.equal(v, pv):
            raise AssertionError(f"K4 {what}: valid flags differ")
        e = max(check_close(mr[pv], pr[pv], TOL[dtype], f"K4 {what} re"),
                check_close(mi[pv], pi[pv], TOL[dtype], f"K4 {what} im"))
        if main_shape:
            name = gj.K4[dtype].name
            err[name] = max(err[name], e)
        return e, int(pv.sum()), pv.numel()

    # random systems at N in {3, 8, 64, 128} and at the .noise shapes of
    # phases 16 and 17
    for dtype in (torch.float64, torch.float32):
        for B, n in ((512, 3), (512, 8), (512, 64), (512, 128), (901, 11),
                     (901, 64)):
            Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
            Ai = rng.standard_normal((B, n, n))
            Ar[0] = Ai[0] = 0.0             # all-zero system
            Ar[1, n // 2] = Ai[1, n // 2] = 0.0  # one zero row
            e, nv, nt = k4_vs_plain(
                *[torch.as_tensor(a, dtype=dtype, device=dev)
                  for a in (Ar, Ai)], dtype, f"{TAG[dtype]} N={n}", False)
            if nv != nt - 2:
                raise AssertionError(f"K4 N={n}: {nv}/{nt} valid")
            say("2 compare", f"K4 {TAG[dtype]} N={n} B={B} valid {nv}/{nt} "
                f"max_abs_err {e:.3e}")

    # the .noise systems of phases 16 and 17 (the amplifier, N = 11, and
    # the N = 64 ladder, 901 frequencies each) at their operating points,
    # in f64 as .noise runs them
    noise_planes = {}
    for label, net in (("amp", AMP_DECK), ("ladder", LADDER_NOISE)):
        ckt = st.parse_netlist(net, dialect="extended")
        t = st.build_tensors(ckt)
        op = st.simulate_op(ckt, tensors=t, device=dev)
        _f, planes, _e, _p, _n = tnoise.noise_system(ckt, t, op, dev)
        Ar, Ai = (p.contiguous() for p in planes[:2])
        noise_planes[label] = (Ar, Ai)
        e, nv, nt = k4_vs_plain(Ar, Ai, torch.float64,
                                f"f64 {label} noise planes", True)
        if nv != nt:
            raise AssertionError(f"K4 {label}: {nv}/{nt} valid")
        say("2 compare", f"K4 f64 {label} noise planes ({nt}, "
            f"{Ar.shape[1]}) valid {nv}/{nt} max_abs_err {e:.3e}")

    def assembled(net, overrides, B, dtype, dialect="spicey"):
        """The planes the K1 route assembles for a deck, flattened to
        (B*F, N, N) and (B*F, N) as K1 takes them."""
        return solver.assemble_planes(net, overrides, B, dtype, dev,
                                      dialect)

    e, nv, nt = k1_vs_plain(assembled(BASICS01, {}, 1, torch.float64),
                            torch.float64, "basics01", True)
    say("2 compare", f"K1 f64 basics01 planes (201, 3) valid {nv}/{nt} "
        f"max_abs_err {e:.3e}")
    LB = 2048
    ladder = rc_ladder_netlist(62)
    lad_over = {"r1": 101.0 * (1 + 0.2 * rng.random(LB))}
    ladder_planes = {}
    for dtype in (torch.float64, torch.float32):
        planes = assembled(ladder, lad_over, LB, dtype)
        ladder_planes[dtype] = planes
        e, nv, nt = k1_vs_plain(planes, dtype, f"{TAG[dtype]} ladder", True,
                                conditioned=dtype == torch.float32)
        if nv != nt:
            raise AssertionError(f"K1 ladder: {nv}/{nt} valid")
        say("2 compare", f"K1 {TAG[dtype]} ladder planes ({nt}, 64) valid "
            f"{nv}/{nt} max_abs_err {e:.3e}")

    def fused_inputs(net, node, overrides, B, dtype):
        ckt = st.parse_netlist(net)
        t = st.build_tensors(ckt)
        freqs = tac.build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1,
                                          ckt.ac.f2)
        ph = np.deg2rad(t.v_ac_phase_deg)
        iph = np.deg2rad(t.i_ac_phase_deg)

        def vals(base, names):
            return torch.as_tensor(
                tbatch._batch_values(base, names, overrides, B),
                dtype=dtype, device=dev)

        values = mc_ac_fused.combine_values(
            vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
            vals(t.l_vals, t.l_names),
            torch.as_tensor(t.v_ac_mag * np.cos(ph), dtype=dtype,
                            device=dev).expand(B, -1),
            torch.as_tensor(t.v_ac_mag * np.sin(ph), dtype=dtype,
                            device=dev).expand(B, -1),
            ext=tbatch._batched_ext(t, overrides, B, dev, dtype),
            i_re=torch.as_tensor(t.i_ac_mag * np.cos(iph), dtype=dtype,
                                 device=dev),
            i_im=torch.as_tensor(t.i_ac_mag * np.sin(iph), dtype=dtype,
                                 device=dev), dtype=dtype)
        node_idx = [n.upper() for n in t.node_names].index(node.upper())
        packed = tbatch._fused_pattern(ckt, t, "pallas", dev)
        return (torch.as_tensor(freqs, dtype=dtype, device=dev), values,
                packed, node_idx)

    def plain_chunked(freqs, values, packed, node_idx, chunk=125_000):
        parts = [mc_ac_fused.mc_ac_fused_plain(
            freqs, values[:, s:s + chunk].contiguous(), packed, node_idx)
            for s in range(0, values.shape[1], chunk)]
        return (torch.cat([m for m, _ in parts]),
                torch.cat([v for _, v in parts]))

    def k5_forms(n):
        """K5's forms that take N: the register form up to its largest
        instance, the group form at every N."""
        return [f for f in mc_ac_fused.FORMS
                if not (f == "register" and n > mc_ac_fused.REG_MAX_N)]

    def k5_vs_plain(inputs, dtype, what, main_shape):
        """Every form of K5 that takes N against the plain version:
        ``valid`` identical, |x[node]| at rtol. Returns (max abs err over
        the forms, n_valid, systems)."""
        pmag, pv = plain_chunked(*inputs)
        e = 0.0
        for form in k5_forms(inputs[2].n):
            mag, v = mc_ac_fused.mc_ac_fused_cuda(*inputs, form=form)
            if not torch.equal(v, pv):
                raise AssertionError(f"K5 {form} {what}: valid flags differ")
            e = max(e, check_close(mag[pv], pmag[pv], TOL[dtype],
                                   f"K5 {form} {what}"))
            del mag, v
        if main_shape:
            name = mc_ac_fused.K5[dtype].name
            err[name] = max(err[name], e)
        return e, int(pv.sum()), pv.numel()

    # dense random systems (tests/fused_systems.py) at every N of the fused
    # tier, each form that takes N, an all-zero, a zero-row and a NaN
    # variant each, |x| of the middle node
    for dtype in (torch.float64, torch.float32):
        for n in range(1, mc_ac_fused.FUSED_MAX_N + 1):
            B = 512
            vals = dense_values(n, B, SEED + n)
            vals[2 + 2 * (n - 1), 2] = np.nan  # entry (0, n - 1), variant 2
            inputs = (torch.as_tensor(FREQS, dtype=dtype, device=dev),
                      torch.as_tensor(vals, dtype=dtype, device=dev),
                      mc_ac_fused.pack_pattern(dense_pattern(n), n, dev),
                      n // 2)
            e, nv, nt = k5_vs_plain(inputs, dtype, f"{TAG[dtype]} N={n}",
                                    False)
            if nv != nt - 3 * 3:
                raise AssertionError(f"K5 N={n}: {nv}/{nt} valid")
            say("2 compare", f"K5 {TAG[dtype]} N={n} forms "
                f"{'/'.join(k5_forms(n))} (chosen "
                f"{mc_ac_fused.k5_form_for(n, dtype)[0]}) (3, {B}) valid "
                f"{nv}/{nt}, the zero, zero-row and NaN variants flagged; "
                f"max_abs_err {e:.3e}")

    r_big = 30.0 * (1 + 0.2 * rng.random(BIG))
    c_big = 100e-6 * (1 + 0.2 * rng.random(BIG))
    big_over = {"r1": r_big, "c1": c_big}
    ext_over = {"R1": 1e3 * (1 + 0.2 * rng.random(4096)),
                "L1": 1e-2 * (1 + 0.2 * rng.random(4096))}
    big_inputs = {}
    for dtype in (torch.float64, torch.float32):
        inputs = fused_inputs(EXT_NET, "d", ext_over, 4096, dtype)
        e, nv, nt = k5_vs_plain(inputs, dtype, f"{TAG[dtype]} ext", False)
        say("2 compare", f"K5 {TAG[dtype]} extended deck N={inputs[2].n} "
            f"(4096, {inputs[0].shape[0]}) forms "
            f"{'/'.join(k5_forms(inputs[2].n))} valid {nv}/{nt} "
            f"max_abs_err {e:.3e}")
        big_inputs[dtype] = fused_inputs(RC_NET, "2", big_over, BIG, dtype)
        e, nv, nt = k5_vs_plain(big_inputs[dtype], dtype,
                                f"{TAG[dtype]} 1M", True)
        if nv != nt:
            raise AssertionError(f"K5 1M: {nv}/{nt} valid")
        say("2 compare", f"K5 {TAG[dtype]} RC (1M, 201) forms "
            f"{'/'.join(k5_forms(3))} valid {nv}/{nt} max_abs_err {e:.3e}")
        # the same 1M variants with a NaN resistor (variant 0) and node 2
        # left floating (variant 1: R = inf, C = 0), singular at every
        # frequency
        freqs, values, packed, node = big_inputs[dtype]
        bad = values.clone()
        bad[0, 0] = float("nan")
        bad[0, 1] = float("inf")
        bad[1, 1] = 0.0
        e, nv, nt = k5_vs_plain((freqs, bad, packed, node), dtype,
                                f"{TAG[dtype]} 1M NaN/singular", False)
        if nv != nt - 2 * freqs.shape[0]:
            raise AssertionError(f"K5 1M NaN/singular: {nv}/{nt} valid")
        say("2 compare", f"K5 {TAG[dtype]} RC (1M, 201) with a NaN and a "
            f"singular variant: valid {nv}/{nt} (both flagged at every "
            f"frequency) max_abs_err {e:.3e}")
        del bad

    def plain_x_chunked(freqs, values, packed, rhs, chunk=2048):
        """K7's plain version over blocks of ``chunk`` variants (at the
        phase-18 shape its whole planes would take ~14 GB in f64)."""
        parts = [mc_ac_fused.mc_ac_fused_x_plain(
            freqs, values[:, s:s + chunk].contiguous(), packed,
            None if rhs is None else tuple(r[..., s:s + chunk] for r in rhs))
            for s in range(0, values.shape[1], chunk)]
        return tuple(torch.cat([p[k] for p in parts], dim=-1)
                     for k in range(3))

    def k7_vs_plain(inputs, rhs, dtype, what, main_shape,
                    conditioned=False):
        """K7 against its plain version: ``valid`` identical, the full
        solutions of the valid systems at rtol; ``conditioned`` applies
        k1_vs_plain's rule (K7 as accurate as the plain version against
        an f64 solve of the same inputs)."""
        freqs, values, packed = inputs
        xr, xi, v = mc_ac_fused.mc_ac_fused_x_cuda(freqs, values, packed, rhs)
        pr, pi, pv = plain_x_chunked(freqs, values, packed, rhs)
        if not torch.equal(v, pv):
            raise AssertionError(f"K7 {what}: valid flags differ")

        def sel(x):  # (F, N, B) -> (valid systems, N)
            return x.permute(0, 2, 1)[pv]

        if conditioned:
            tr, ti, _ = plain_x_chunked(
                freqs.double(), values.double(), packed,
                None if rhs is None else tuple(r.double() for r in rhs))
            scale = float(sel(tr).abs().max())

            def err_vs(a, b):
                return float(torch.maximum(
                    (sel(a).double() - sel(tr)).abs().max(),
                    (sel(b).double() - sel(ti)).abs().max()))

            e_plain, e_k7 = err_vs(pr, pi), err_vs(xr, xi)
            if e_k7 > 2 * e_plain + TOL[dtype] * scale:
                raise AssertionError(f"K7 {what}: error vs f64 {e_k7:.3e}, "
                                     f"plain's {e_plain:.3e}")
            say("2 compare", f"K7 {what}: error vs an f64 solve "
                f"{e_k7:.3e}, the plain f32 version's {e_plain:.3e}")
            e = float(torch.maximum((sel(xr) - sel(pr)).abs().max(),
                                    (sel(xi) - sel(pi)).abs().max()))
        else:
            e = max(check_close(sel(xr), sel(pr), TOL[dtype],
                                f"K7 {what} re"),
                    check_close(sel(xi), sel(pi), TOL[dtype],
                                f"K7 {what} im"))
        if main_shape:
            name = mc_ac_fused.K7[dtype].name
            err[name] = max(err[name], e)
        return e, int(pv.sum()), pv.numel()

    def rhs_planes(F, n, B, dtype):
        return tuple(torch.as_tensor(rng.standard_normal((F, n, B)),
                                     dtype=dtype, device=dev)
                     for _ in range(2))

    # dense random systems (tests/fused_systems.py) at every group width
    # of K7 (N = 1-4 on 4 lanes, 5-8 on 8, 9-16 on 16), an all-zero, a
    # zero-row and a NaN variant each, in both modes
    for dtype in (torch.float64, torch.float32):
        for n in (1, 3, 4, 5, 8, 9, 15, 16):
            B = 512
            freqs = torch.as_tensor(FREQS, dtype=dtype, device=dev)
            vals = dense_values(n, B, SEED)
            vals[2 + 2 * (n - 1), 2] = np.nan  # entry (0, n - 1), variant 2
            values = torch.as_tensor(vals, dtype=dtype, device=dev)
            for ext_rhs in (False, True):
                packed = mc_ac_fused.pack_pattern(dense_pattern(n), n, dev,
                                                  ext_rhs=ext_rhs)
                rhs = rhs_planes(3, n, B, dtype) if ext_rhs else None
                mode = "external RHS" if ext_rhs else "pattern RHS"
                e, nv, nt = k7_vs_plain((freqs, values, packed), rhs, dtype,
                                        f"{TAG[dtype]} N={n} {mode}", False)
                if nv != nt - 3 * 3:
                    raise AssertionError(f"K7 N={n}: {nv}/{nt} valid")
                say("2 compare", f"K7 {TAG[dtype]} N={n} (group "
                    f"{mc_ac_fused.fused_group_for(n)}) {mode} (3, {B}) "
                    f"valid {nv}/{nt}, the zero, zero-row and NaN variants "
                    f"flagged; max_abs_err {e:.3e}")

    # the phase-18 shape: the N = 16 ladder, 16,384 variants x 201
    # frequencies, every R and C at U(0.9, 1.1) x nominal
    AC16_B = 16_384
    lad16 = rc_ladder_netlist(14, 201)
    lad16_t = st.build_tensors(st.parse_netlist(lad16))
    ac16_over = {n: v * rng.uniform(0.9, 1.1, AC16_B) for n, v in
                 zip(lad16_t.r_names + lad16_t.c_names,
                     np.concatenate([lad16_t.r_vals, lad16_t.c_vals]))}
    lad16_ext = mc_ac_fused.pack_pattern(mc_ac_fused.build_stamp_pattern(
        lad16_t.nvar, lad16_t.r_idx, lad16_t.c_idx, lad16_t.l_idx,
        lad16_t.v_idx), lad16_t.nvar, dev, ext_rhs=True)
    lad16_inputs = {}
    for dtype in (torch.float64, torch.float32):
        freqs, values, packed, _node = fused_inputs(lad16, "n14", ac16_over,
                                                    AC16_B, dtype)
        lad16_inputs[dtype] = (freqs, values, packed)
        F, n = freqs.shape[0], packed.n
        for ext_rhs in (False, True):
            rhs = rhs_planes(F, n, AC16_B, dtype) if ext_rhs else None
            mode = "external RHS" if ext_rhs else "pattern RHS"
            e, nv, nt = k7_vs_plain(
                (freqs, values, lad16_ext if ext_rhs else packed), rhs,
                dtype, f"{TAG[dtype]} ladder-16 {mode}",
                dtype == torch.float64 and not ext_rhs,
                conditioned=dtype == torch.float32)
            if nv != nt:
                raise AssertionError(f"K7 ladder-16: {nv}/{nt} valid")
            say("2 compare", f"K7 {TAG[dtype]} ladder N={n} {mode} "
                f"({AC16_B}, {F}) valid {nv}/{nt} max_abs_err {e:.3e}")
            del rhs
    torch.cuda.empty_cache()
    # K2 and K3: random systems with an all-zero and a zero-row system
    def k2_vs_plain(A, b, dtype, what, main_shape):
        x, v = gj_real.gj_solve_cuda(A, b)
        px, pv = linsolve.gj_solve(A, b)
        if not torch.equal(v, pv):
            raise AssertionError(f"K2 {what}: valid flags differ")
        e = check_close(x[pv], px[pv], TOL[dtype], f"K2 {what}")
        if main_shape:
            err[gj_real.K2[dtype].name] = max(err[gj_real.K2[dtype].name], e)
        return e, int(pv.sum()), pv.numel()

    def k3_vs_plain(A, dtype, what, main_shape):
        inv, v = gj_real.gj_inverse_cuda(A)
        pinv, pv = linsolve.gj_inverse(A)
        if not torch.equal(v, pv):
            raise AssertionError(f"K3 {what}: valid flags differ")
        e = check_close(inv[pv], pinv[pv], TOL[dtype], f"K3 {what}")
        if main_shape:
            err[gj_real.K3[dtype].name] = max(err[gj_real.K3[dtype].name], e)
        return e, int(pv.sum()), pv.numel()

    for dtype in (torch.float64, torch.float32):
        for n in (3, 8, 64, 128):
            B = 512
            A = rng.standard_normal((B, n, n)) + n * np.eye(n)
            b = rng.standard_normal((B, n))
            A[0] = 0.0             # all-zero system
            A[1, n // 2] = 0.0     # one zero row
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            bt = torch.as_tensor(b, dtype=dtype, device=dev)
            e2, nv, nt = k2_vs_plain(At, bt, dtype, f"{TAG[dtype]} N={n}",
                                     False)
            e3, nv3, _ = k3_vs_plain(At, dtype, f"{TAG[dtype]} N={n}", False)
            if nv != nt - 2 or nv3 != nt - 2:
                raise AssertionError(f"K2/K3 N={n}: {nv}, {nv3}/{nt} valid")
            say("2 compare", f"K2/K3 {TAG[dtype]} N={n} B={B} valid "
                f"{nv}/{nt} max_abs_err {e2:.3e} / {e3:.3e}")

    def boost_system(B, dtype):
        """The boost converter's Newton systems (B, 6): RR1 at U(1, 1.1) x
        1k, a random switch state and diode seed voltage per variant, the
        sources at t = 0.5 ms (the switch's gate high)."""
        ckt = st.parse_netlist(BOOST_NET)
        t = st.build_tensors(ckt)
        dt, _ = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
        rr = torch.as_tensor(1e3 * (1 + 0.1 * rng.random((B, 1))),
                             dtype=dtype, device=dev)
        arr = ttran.tran_arrays(t, dev, dtype, r_vals=rr)
        carry = ttran._init_carry((B,), {"c": t.n_c, "l": t.n_l, "d": t.n_d,
                                         "m": 0, "q": 0, "s": t.n_s},
                                  dtype, dev)
        carry[4] = torch.as_tensor(rng.uniform(-1.0, 0.8, (B, t.n_d)),
                                   dtype=dtype, device=dev)
        sw = torch.as_tensor(rng.random((B, t.n_s)) < 0.5, device=dev)
        vs = torch.as_tensor(sample_source_values(ckt, np.array([5e-4]))[0],
                             dtype=dtype, device=dev)
        A, b = ttran._stamp_system(
            arr, t.nvar, dt, vs, torch.zeros((B, t.nvar), dtype=dtype,
                                             device=dev),
            0, carry, sw, vt_scale=1.0)
        return A.contiguous(), b.contiguous()

    r_tran = 1e3 * (1 + 0.2 * rng.random(BIG))
    c_tran = 1e-6 * (1 + 0.2 * rng.random(BIG))
    tran_ckt = st.parse_netlist(TRAN_NET)
    tran_t = st.build_tensors(tran_ckt)
    tran_dt, tran_steps = effective_time_step(tran_ckt.tran.dt,
                                              tran_ckt.tran.tstop)

    def rc_matrix(dtype):
        """The RC transient's factor-once matrices (1M, 3)."""
        arr = ttran.tran_arrays(
            tran_t, dev, dtype,
            r_vals=torch.as_tensor(r_tran[:, None], dtype=dtype, device=dev),
            c_vals=torch.as_tensor(c_tran[:, None], dtype=dtype, device=dev))
        return ttran.linear_system_matrix(
            tran_t.nvar, (BIG,), dtype, arr, arr["c_vals"] / tran_dt,
            tran_dt).contiguous()

    boost_sys, rc_mat = {}, {}
    for dtype in (torch.float64, torch.float32):
        boost_sys[dtype] = boost_system(BOOST_B, dtype)
        e, nv, nt = k2_vs_plain(*boost_sys[dtype], dtype,
                                f"{TAG[dtype]} boost", True)
        if nv != nt:
            raise AssertionError(f"K2 boost: {nv}/{nt} valid")
        say("2 compare", f"K2 {TAG[dtype]} boost Newton systems ({nt}, 6) "
            f"valid {nv}/{nt} max_abs_err {e:.3e}")
        rc_mat[dtype] = rc_matrix(dtype)
        e, nv, nt = k3_vs_plain(rc_mat[dtype], dtype, f"{TAG[dtype]} RC",
                                True)
        if nv != nt:
            raise AssertionError(f"K3 RC: {nv}/{nt} valid")
        say("2 compare", f"K3 {TAG[dtype]} RC transient matrices ({nt}, 3) "
            f"valid {nv}/{nt} max_abs_err {e:.3e}")

    def k8_inputs(net, node, over, B, dialect="spicey"):
        ckt = st.parse_netlist(net, dialect=dialect)
        t = st.build_tensors(ckt)
        dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
        vs = torch.as_tensor(
            sample_source_values(ckt, np.arange(steps + 1) * dt),
            dtype=torch.float32, device=dev)

        def vals(base, names):
            return torch.as_tensor(tbatch._batch_values(base, names, over, B),
                                   dtype=torch.float64, device=dev)

        values = tmc.tran_value_slab(
            t, vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
            vals(t.l_vals, t.l_names),
            tbatch._batched_ext(t, over, B, dev, torch.float64),
            tbatch._batched_nl(t, over, B, dev, torch.float64), dt)
        pattern = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be",
                                          False, dev)
        node_idx = [n.upper() for n in t.node_names].index(node.upper())
        return vs, values, pattern, node_idx

    def tran_forms(n):
        """The forms of K8 and K9 that take N: the register form up to its
        largest instance, the shared form at every N."""
        return [f for f in mc_tran_fused.FORMS
                if not (f == "register" and n > mc_tran_fused.REG_MAX_N)]

    def k8_vs_plain(inputs, what, main_shape):
        """K8 in every form that takes N against its plain version:
        ``valid`` identical, f32 at rtol 1e-5."""
        pout, pv = mc_tran_fused.mc_tran_fused_plain(*inputs)
        chosen = mc_tran_fused.k8_form_for(inputs[2].n)
        errs = {}
        for form in tran_forms(inputs[2].n):
            out, v = mc_tran_fused.mc_tran_fused_cuda(*inputs, form=form)
            if not torch.equal(v, pv):
                raise AssertionError(f"K8 {what} {form}: valid flags differ")
            errs[form] = check_close(out[pv], pout[pv], TOL[torch.float32],
                                     f"K8 {what} {form}")
            del out, v
        if main_shape:
            name = mc_tran_fused.K8[torch.float32].name
            err[name] = max(err[name], errs[chosen])
        return errs, int(pv.sum()), pv.numel()

    def form_errs(errs, chosen):
        return ", ".join(f"{f}{' (chosen)' if f == chosen else ''} "
                         f"{e:.3e}" for f, e in errs.items())

    ext_tran_over = {"R1": 1e3 * (1 + 0.2 * rng.random(4096)),
                     "L1": 1e-2 * (1 + 0.2 * rng.random(4096)),
                     "C1": 1e-6 * (1 + 0.2 * rng.random(4096))}
    inputs = k8_inputs(EXT_TRAN, "d", ext_tran_over, 4096, "extended")
    errs, nv, nt = k8_vs_plain(inputs, "extended deck", False)
    say("2 compare", f"K8 f32 extended deck N={inputs[2].n} (4096, "
        f"{inputs[0].shape[0]} steps) valid {nv}/{nt} max_abs_err "
        f"{form_errs(errs, mc_tran_fused.k8_form_for(inputs[2].n))}")
    tran_big_inputs = k8_inputs(TRAN_NET, "2",
                                {"R1": r_tran, "C1": c_tran}, BIG)
    errs, nv, nt = k8_vs_plain(tran_big_inputs, "RC 1M", True)
    if nv != nt:
        raise AssertionError(f"K8 RC 1M: {nv}/{nt} valid")
    say("2 compare", f"K8 f32 RC transient (1M, {tran_steps + 1} steps) "
        f"valid {nv}/{nt} max_abs_err "
        f"{form_errs(errs, mc_tran_fused.k8_form_for(3))}")
    # K8 on batches that are no multiple of a block (4097 and the first
    # 999,999 variants), lane 1's R1 NaN, lane 2's R1 infinite and C1 0
    # (A's node row zero: singular)
    for nb in (4097, BIG - 1):
        vs_r, values_r, pattern_r, node_r = k8_inputs(
            TRAN_NET, "2", {"R1": r_tran[:nb], "C1": c_tran[:nb]}, nb)
        values_r[0, 1] = float("nan")
        values_r[0, 2], values_r[1, 2] = float("inf"), 0.0
        errs, nv, nt = k8_vs_plain((vs_r, values_r, pattern_r, node_r),
                                   f"RC {nb}", False)
        if nv != nt - 2:
            raise AssertionError(f"K8 RC {nb}: {nv}/{nt} valid")
        say("2 compare", f"K8 f32 RC transient ({nb}, NaN and singular "
            f"lanes) valid {nv}/{nt} max_abs_err "
            f"{form_errs(errs, mc_tran_fused.k8_form_for(3))}")
        del vs_r, values_r

    def k9_inputs(net, node, over, B, dialect="spicey"):
        """K9's inputs as the main path forms them: the f32 value slab
        with the device rows, the packed pattern, the Newton settings."""
        ckt = st.parse_netlist(net, dialect=dialect)
        t = st.build_tensors(ckt)
        dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
        f32 = torch.float32
        vs = torch.as_tensor(
            sample_source_values(ckt, np.arange(steps + 1) * dt),
            dtype=f32, device=dev)

        def vals(base, names):
            return torch.as_tensor(tbatch._batch_values(base, names, over, B),
                                   dtype=f32, device=dev)

        values = tmc.tran_value_slab(
            t, vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
            vals(t.l_vals, t.l_names),
            tbatch._batched_ext(t, over, B, dev, f32),
            tbatch._batched_nl(t, over, B, dev, f32), dt)
        pattern = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be",
                                          False, dev)
        nr, max_nr = tmc._nr_mode(t)
        node_idx = [n.upper() for n in t.node_names].index(node.upper())
        return vs, values, pattern, node_idx, dict(
            vd_scale=float(t.vt) / st.VT_300K, nr=nr, max_nr=max_nr)

    def k9_vs_plain(inputs, what, main_shape, forms=None):
        """K9 in every form that takes N (or ``forms``) against its plain
        version: ``valid`` identical, each valid lane within 1e-4 x
        max|V|; lanes beyond that (a rounding difference that puts a
        switch or Newton exit on the other side of its threshold) are
        counted, and then mean/min/max over the valid lanes must agree at
        2e-4. Returns ({form: (max abs err, lanes beyond)}, the plain
        version's Newton passes per lane, n_valid, B)."""
        vs, values, pattern, node_idx, kw = inputs
        pout, pv, passes = mc_tran_fused.mc_tran_fused_nr_plain(
            vs, values, pattern, node_idx, return_passes=True, **kw)
        scale = float(pout[pv].abs().max())
        errs = {}
        for form in forms or tran_forms(pattern.n):
            out, v = mc_tran_fused.mc_tran_fused_nr_cuda(
                vs, values, pattern, node_idx, form=form, **kw)
            if not torch.equal(v, pv):
                raise AssertionError(f"K9 {what} {form}: valid flags differ")
            lane_err = (out[pv] - pout[pv]).abs().amax(dim=1)
            beyond = int((lane_err > 1e-4 * scale).sum())
            if beyond:
                for f in (torch.mean, torch.amin, torch.amax):
                    check_close(f(out[pv], dim=0), f(pout[pv], dim=0), 2e-4,
                                f"K9 {what} {form} {f.__name__}")
            errs[form] = (float(lane_err.max()), beyond)
            del out, v
        if main_shape:
            name = mc_tran_fused.K9[torch.float32].name
            err[name] = max(err[name],
                            errs[mc_tran_fused.k9_form_for(pattern.n)][0])
        return errs, passes, int(pv.sum()), pv.numel()

    def k9_errs(errs, n):
        chosen = mc_tran_fused.k9_form_for(n)
        return ", ".join(f"{f}{' (chosen)' if f == chosen else ''} {e:.3e} "
                         f"({b} beyond)" for f, (e, b) in errs.items())

    def pass_stats(passes):
        """Newton passes per lane: mean, max, and the mean over warps (32
        consecutive lanes) of the warp's most passes over the mean passes,
        the factor by which divergence stretches a thread-per-variant
        kernel's work."""
        pl = passes.double()
        warps = pl[:pl.numel() // 32 * 32].view(-1, 32).amax(dim=1)
        return (float(pl.mean()), int(passes.max()),
                float(warps.mean() / pl.mean()))

    # one deck per family: (deck, dialect, node, swept element, nominal)
    k9_decks = {
        "boost": (BOOST_NET, "spicey", "N3", "RR1", 1e3),
        "boost 10us grid": (BOOST_FINE, "spicey", "N3", "RR1", 1e3),
        "ring": (RING_NET, "extended", "n1", "c1", 1e-9),
        "BJT_NET": (BJT_NET, "extended", "c1", "RC", 1e3),
        "TT diode": (TT_NET, "extended", "2", "R1", 100.0),
        "CJO diode": (CJ_NET, "extended", "2", "R1", 1e3),
        "BJT charge": (QC_NET, "extended", "c1", "RC", 1e3),
        "JFET": (JFET_NET, "extended", "d1", "RD", 1e4),
        "PNP": (PNP_NET, "extended", "c1", "RC", 1e3),
    }
    def bytes_match(pattern):
        """Each form's shared-memory bytes per variant in the kernel's own
        figure equal the copy the wrapper checks (and the CPU tests hold
        to the layout)."""
        n = pattern.n
        for form in mc_tran_fused.FORMS:
            code = mc_tran_fused.FORMS.index(form)
            if pattern.nonlinear:
                counts = mc_tran_fused.k9_counts(pattern)
                got = mc_tran_fused.load_nr_library(
                    ).mc_tran_nr_bytes_per_variant(code, n, *counts)
                want = mc_tran_fused.k9_bytes_per_variant(form, n, *counts)
            else:
                n_c, n_l = pattern.cst.shape[0], pattern.lst.shape[0]
                got = mc_tran_fused.load_library(
                    ).mc_tran_fused_bytes_per_variant(code, n, n_c, n_l)
                want = mc_tran_fused.k8_bytes_per_variant(form, n, n_c, n_l)
            if got != want:
                raise AssertionError(f"{form} bytes per variant: kernel "
                                     f"{got}, wrapper {want}")

    bytes_match(inputs[2])
    bytes_match(tran_big_inputs[2])
    k9_passes = {}
    for deck, (net, dialect, node, elem, nominal) in k9_decks.items():
        over = {elem: nominal * (1 + 0.1 * rng.random(RING_B))}
        inputs = k9_inputs(net, node, over, RING_B, dialect)
        bytes_match(inputs[2])
        errs, passes, nv, nt = k9_vs_plain(inputs, deck, False)
        pm, px, wf = pass_stats(passes)
        steps1, pat = inputs[0].shape[0], inputs[2]
        k9_passes[deck] = (pm, px, wf, steps1)
        if nv != nt:
            raise AssertionError(f"K9 {deck}: {nv}/{nt} valid")
        say("2 compare", f"K9 f32 {deck} N={pat.n} (S/D/M/Q "
            f"{pat.slist.shape[0]}/{pat.dlist.shape[0]}/"
            f"{pat.mlist.shape[0]}/{pat.qlist.shape[0]}, charge "
            f"{pat.dchg.shape[0] + pat.qchg.shape[0]}; {nt}, {steps1} "
            f"steps, nr={inputs[4]['nr']}) valid {nv}/{nt} max_abs_err "
            f"{k9_errs(errs, pat.n)} of 1e-4 x max|V|; Newton passes per "
            f"lane mean {pm:.1f} max {px} ({pm / steps1:.3f} per step), "
            f"warp max / mean {wf:.2f}")
    torch.cuda.empty_cache()

    # K10a/K10b, the panel tier, against their plain versions. f64 at rtol
    # 1e-12. In f32 the panel form's pivot-row step (1/pv - 1) cancels,
    # amplifying rounding by ~|pv|, so two f32 runs that sum in another
    # order (FMA, the product's order) differ beyond 1e-5 even on
    # well-conditioned systems; there the kernel must be as accurate as
    # the plain f32 version against the plain f64 solve (k1_vs_plain's
    # rule).
    def k10_vs_plain(ts, dtype, what, main_shape, truth=None):
        """K10a (ts = A, b) or K10b (ts = Ar, Ai, br, bi) against its
        plain version; ``truth``, for f32, is the plain f64 answer (by
        default that of ``ts`` in f64). Returns (max abs err, n_valid, B,
        the plain answer)."""
        cplx = len(ts) == 4
        name = (mxu.K10b if cplx else mxu.K10a)[dtype].name
        if cplx:
            got = mxu.mxu_solve_complex(*ts)
            want = mxu.mxu_solve_complex_plain(*ts)
        else:
            got = mxu.mxu_solve_real(*ts)
            want = mxu.mxu_solve_real_plain(*ts)
        pv = want[-1]
        if not torch.equal(got[-1], pv):
            raise AssertionError(f"{name} {what}: valid flags differ")
        if dtype == torch.float64:
            e = max(check_close(g[pv], w_[pv], TOL[dtype],
                                f"{name} {what}")
                    for g, w_ in zip(got[:-1], want[:-1]))
        else:
            if truth is None:
                truth = (mxu.mxu_solve_complex_plain if cplx
                         else mxu.mxu_solve_real_plain)(
                    *[t.double() for t in ts])
            scale = max(float(t[pv].abs().max()) for t in truth[:-1])

            def err_vs(xs):
                return max(float((x.double() - t)[pv].abs().max())
                           for x, t in zip(xs[:-1], truth[:-1]))

            e_plain, e_k = err_vs(want), err_vs(got)
            if e_k > 2 * e_plain + TOL[dtype] * scale:
                raise AssertionError(f"{name} {what}: error vs f64 "
                                     f"{e_k:.3e}, plain's {e_plain:.3e}")
            say("2 compare", f"{name} {what}: error vs the f64 solve "
                f"{e_k:.3e}, the plain f32 version's {e_plain:.3e} (scale "
                f"{scale:.3e})")
            e = max(float((g - w_)[pv].abs().max())
                    for g, w_ in zip(got[:-1], want[:-1]))
        if main_shape:
            err[name] = max(err[name], e)
        return e, int(pv.sum()), pv.numel(), want

    def k10_systems(n, B, cplx):
        """B random systems (+ n I): the first all zero, the second with a
        zero row, the third MNA-shaped, two branch rows with zero
        diagonals (tests/test_pallas_mxu.py:98-118)."""
        A = rng.standard_normal((B, n, n)) + n * np.eye(n)
        A[0] = 0.0
        A[1, n // 2] = 0.0
        A[2] = 0.0
        A[2, :n - 2, :n - 2] = (rng.standard_normal((n - 2, n - 2))
                                + 8 * np.eye(n - 2))
        A[2, n - 2, 0] = A[2, 0, n - 2] = A[2, n - 1, 1] = A[2, 1, n - 1] = 1
        b = rng.standard_normal((B, n))
        if not cplx:
            return [A, b]
        Ai = rng.standard_normal((B, n, n))
        Ai[0] = Ai[2] = 0.0
        Ai[1, n // 2] = 0.0
        return [A, Ai, b, rng.standard_normal((B, n))]

    for n in (40, 48, 64, 67, 100, 128):
        for cplx in (False, True):
            arrays = k10_systems(n, 256, cplx)
            for dtype in (torch.float64, torch.float32):
                ts = [torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in arrays]
                e, nv, nt, _ = k10_vs_plain(ts, dtype, f"{TAG[dtype]} N={n}",
                                            False)
                if nv != nt - 2:
                    raise AssertionError(f"K10 N={n}: {nv}/{nt} valid")
                say("2 compare", f"{'K10b' if cplx else 'K10a'} "
                    f"{TAG[dtype]} N={n} B={nt} (zero, zero-row, MNA) valid "
                    f"{nv}/{nt} max_abs_err {e:.3e}")

    # K10's plan: the kernel's shared-memory bytes at each place equal the
    # copy the CPU tests check (ops/mxu.py:smem_bytes); its workspace is one
    # slot per resident block, the same for any batch past the slots; and a
    # complex f64 N = 128 batch that is not a multiple of the slots (the
    # persistent blocks' last round partial) against the plain version
    mlib = mxu.load_library()
    for n in range(mxu.MXU_MIN_N, mxu.MXU_MAX_N + 1):
        for planes in (1, 2):
            for dtype in (torch.float64, torch.float32):
                item = torch.empty((), dtype=dtype).element_size()
                for place in (mxu.ALL_SMEM, mxu.PLANES_GLOBAL):
                    want = mlib.mxu_gj_smem_bytes(
                        n, mxu.blocked_plan(n)[0], planes, int(item == 8),
                        place)
                    if mxu.smem_bytes(n, planes, item, place) != want:
                        raise AssertionError(
                            f"K10 smem_bytes N={n} planes={planes} {dtype} "
                            f"place {place}: {want} on the card")
    slots = {nb: mlib.mxu_gj_workspace_systems(128, nb, 2, 1, 32)
             for nb in (52_224, 104_448, 1_000_000)}
    if len(set(slots.values())) != 1 or not slots[52_224]:
        raise AssertionError(f"K10 workspace slots by batch: {slots}")
    n_slots = slots[52_224]
    say("2 compare", f"K10b f64 N=128: workspace {n_slots} slots "
        f"({n_slots * 2 * 128 * 129 * 8 / 1e6:.1f} MB) at every batch "
        f"from 52,224 (the one-block-per-system kernel's: "
        f"{52_224 * 2 * 128 * 129 * 8 / 1e9:.1f} GB); shared-memory bytes "
        "equal ops/mxu.py:smem_bytes at N = 40-128")
    arrays = k10_systems(128, n_slots + 7, True)
    ts = [torch.as_tensor(a, dtype=torch.float64, device=dev)
          for a in arrays]
    e, nv, nt, _ = k10_vs_plain(ts, torch.float64,
                                f"f64 N=128 B={n_slots + 7}", False)
    if nv != nt - 2:
        raise AssertionError(f"K10b N=128 B={nt}: {nv}/{nt} valid")
    say("2 compare", f"K10b f64 N=128 B={nt} ({n_slots} slots + 7) valid "
        f"{nv}/{nt} max_abs_err {e:.3e}")
    del ts, arrays

    def sweep_planes(n, dtype):
        """The solver sweep's planes at N (tools/profile_torch_solver.py):
        rc_ladder_netlist(N - 2), 2048 variants (1024 at N = 128) x 51
        frequencies, r1 at 101 x U(1, 1.2) drawn from SEED + N."""
        SB = 1024 if n == 128 else 2048
        r1 = 101.0 * (1 + 0.2 * np.random.default_rng(SEED + n).random(SB))
        return assembled(rc_ladder_netlist(n - 2), {"r1": r1}, SB, dtype)

    # the sweep's ladder shapes: the complex planes (K10b) and their real
    # part (K10a), f64, then the same planes rounded to f32 held to the
    # f64 pass's plain answer
    for n in (64, 128):
        planes = sweep_planes(n, torch.float64)
        for cplx in (True, False):
            ts = planes if cplx else [planes[0], planes[2]]
            e, nv, nt, truth = k10_vs_plain(ts, torch.float64,
                                            f"f64 ladder N={n}", True)
            e32, nv32, _, _ = k10_vs_plain([t.float() for t in ts],
                                           torch.float32,
                                           f"f32 ladder N={n}", True, truth)
            if nv != nt or nv32 != nt:
                raise AssertionError(f"K10 ladder N={n}: {nv}, {nv32}/{nt}")
            say("2 compare", f"{'K10b' if cplx else 'K10a'} ladder planes "
                f"({nt}, {n}) valid {nv}/{nt}; max_abs_err f64 {e:.3e}, f32 "
                f"{e32:.3e}")
            del truth
        del planes, ts
        torch.cuda.empty_cache()

    # K1-K4 past N = 128: the planes overflow shared memory, so each
    # eliminates in its global workspace
    for dtype in (torch.float64, torch.float32):
        for n in (129, 256):
            B = 64
            Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
            Ai = rng.standard_normal((B, n, n))
            br, bi = rng.standard_normal((2, B, n))
            Ar[0] = Ai[0] = 0.0             # all-zero system
            Ar[1, n // 2] = Ai[1, n // 2] = 0.0  # one zero row
            planes = [torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in (Ar, Ai, br, bi)]
            e1, nv1, nt = k1_vs_plain(planes, dtype, f"{TAG[dtype]} N={n}",
                                      False)
            e4, nv4, _ = k4_vs_plain(planes[0], planes[1], dtype,
                                     f"{TAG[dtype]} N={n}", False)
            e2, nv2, _ = k2_vs_plain(planes[0], planes[2], dtype,
                                     f"{TAG[dtype]} N={n}", False)
            e3, nv3, _ = k3_vs_plain(planes[0], dtype, f"{TAG[dtype]} N={n}",
                                     False)
            if {nv1, nv2, nv3, nv4} != {nt - 2}:
                raise AssertionError(f"K1-K4 N={n}: {nv1}, {nv2}, {nv3}, "
                                     f"{nv4}/{nt} valid")
            say("2 compare", f"K1/K2/K3/K4 {TAG[dtype]} N={n} B={B} "
                f"(workspace) valid {nv1}/{nt} max_abs_err {e1:.3e} / "
                f"{e2:.3e} / {e3:.3e} / {e4:.3e}")
    torch.cuda.empty_cache()

    # ---- every tier of K1 and K2 against the plain versions ----------------
    # at the tier edges and past them, each batch with an all-zero lane, a
    # NaN lane and a zero-column lane: valid identical on every lane; f64
    # within 1e-12 x max|x|; f32 by k1_vs_plain's rule (error against an f64
    # solve of the same planes at most twice the plain f32 version's, plus
    # 1e-5 x max|x|: the tiers sum in other orders than the torch ops)
    def tier_lanes(n, B):
        Ar = rng.standard_normal((B, n, n)) + n * np.eye(n)
        Ai = rng.standard_normal((B, n, n))
        br, bi = rng.standard_normal((2, B, n))
        Ar[0] = Ai[0] = 0.0                        # all-zero lane
        Ar[1, n // 2, n - 1] = np.nan              # NaN lane
        Ar[2, :, n // 3] = Ai[2, :, n // 3] = 0.0  # zero-column lane
        return Ar, Ai, br, bi

    def tier_err(got, plain, truth, ok, dtype, what):
        """Max error of ``got`` against ``truth`` over max|truth| on the
        valid lanes, held to the rule above."""
        scale = max(float(t[ok].abs().max()) for t in truth)
        e = max(float((g.double() - t)[ok].abs().max())
                for g, t in zip(got, truth))
        limit = TOL[dtype] * scale
        if dtype == torch.float32:
            limit += 2 * max(float((p.double() - t)[ok].abs().max())
                             for p, t in zip(plain, truth))
        if e > limit:
            raise AssertionError(f"{what}: error {e:.3e} above {limit:.3e}")
        return e / scale

    edges = {3, 8, 16, 17, 31, 32, 33, 64, 128, 129, 256}
    for t in (gj.K1_WARP_MAX, gj.K1_PANEL_MIN, gj_real.K2_WARP_MAX,
              gj_real.K2_PANEL_MIN, *gj_real.K2_THREAD_MAX.values()):
        edges |= {m for m in (t - 1, t, t + 1) if m >= 1}
    t2 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        for n in sorted(edges):
            B = 64 if n > 128 else 256
            planes = [torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in tier_lanes(n, B)]
            pr, pi, pv = linsolve.gj_solve_planes(*planes)
            px, pvx = linsolve.gj_solve(planes[0], planes[2])
            for v in (pv, pvx):
                if v[:3].any() or not v[3:].all():
                    raise AssertionError(f"tiers N={n}: plain flags "
                                         f"{v[:4].tolist()}")
            truth_c, truth_r = (pr, pi), (px,)
            if dtype == torch.float32:
                tr, ti, _ = linsolve.gj_solve_planes(*[p.double()
                                                       for p in planes])
                truth_c = (tr, ti)
                truth_r = (linsolve.gj_solve(planes[0].double(),
                                             planes[2].double())[0],)
            errs = []
            for tier in gj.TIERS:
                if tier == "warp" and n > gj.WARP_MAX_N:
                    continue
                xr, xi, v = gj.gj_solve_planes_cuda(*planes, tier=tier)
                if not torch.equal(v, pv):
                    raise AssertionError(f"K1 {tier} N={n}: valid differs")
                e = tier_err((xr, xi), (pr, pi), truth_c, pv, dtype,
                             f"K1 {tier} {TAG[dtype]} N={n}")
                errs.append(f"K1 {tier} {e:.1e}")
            for tier in gj_real.TIERS:
                if (tier == "warp" and n > gj_real.WARP_MAX_N) or (
                        tier == "thread" and n > gj_real.THREAD_MAX_N):
                    continue
                x, v = gj_real.gj_solve_cuda(planes[0], planes[2], tier=tier)
                if not torch.equal(v, pvx):
                    raise AssertionError(f"K2 {tier} N={n}: valid differs")
                e = tier_err((x,), (px,), truth_r, pvx, dtype,
                             f"K2 {tier} {TAG[dtype]} N={n}")
                errs.append(f"K2 {tier} {e:.1e}")
            say("2 tiers", f"{TAG[dtype]} N={n} B={B}: valid identical, "
                f"lanes 0-2 (zero, NaN, zero column) flagged; error / "
                f"max|x|: {', '.join(errs)}")
            del planes, pr, pi, px, truth_c, truth_r
    torch.cuda.empty_cache()
    # every tier of K4 (the inverse of [A | I]), forced, with the same
    # lanes (their own generator, so the later phases' draws stay as they
    # were) and rule; N = 410 is past complex f64's [panel | C] edge
    # (PANEL_SMEM_EDGE), where the panel tier keeps it in its workspace
    rng4 = np.random.default_rng(SEED + 4)
    for dtype in (torch.float64, torch.float32):
        for n in K4_TIER_NS:
            B, m = (8 if n > 128 else 64), max(n, 3)
            Ar = rng4.standard_normal((B, m, m)) + m * np.eye(m)
            Ai = rng4.standard_normal((B, m, m))
            Ar, Ai = Ar[:, :n, :n].copy(), Ai[:, :n, :n].copy()
            Ar[0] = Ai[0] = 0.0                        # all-zero lane
            Ar[1, n // 2, n - 1] = np.nan              # NaN lane
            Ar[2, :, n // 3] = Ai[2, :, n // 3] = 0.0  # zero-column lane
            planes = [torch.as_tensor(a, dtype=dtype, device=dev)
                      for a in (Ar, Ai)]
            pr, pi, pv = linsolve.gj_inverse_planes(*planes)
            if pv[:3].any() or not pv[3:].all():
                raise AssertionError(f"K4 tiers N={n}: plain flags "
                                     f"{pv[:4].tolist()}")
            truth = (pr, pi) if dtype == torch.float64 else \
                linsolve.gj_inverse_planes(*[p.double() for p in planes])[:2]
            errs = []
            for tier in gj.TIERS:
                if tier == "warp" and n > gj.WARP_MAX_N:
                    continue
                mr, mi, v = gj.gj_inverse_planes_cuda(*planes, tier=tier)
                what = f"K4 {tier} {TAG[dtype]} N={n}"
                if not torch.equal(v, pv):
                    raise AssertionError(f"{what}: valid differs")
                e = tier_err((mr, mi), (pr, pi), truth, pv, dtype, what)
                errs.append(f"{tier} {e:.1e}")
                del mr, mi
            say("2 tiers", f"K4 {TAG[dtype]} N={n} B={B}: valid identical, "
                f"lanes 0-2 (zero, NaN, zero column) flagged; error / "
                f"max|M|: {', '.join(errs)}")
            del planes, pr, pi, truth
    torch.cuda.empty_cache()
    # past the N where the panel tier's [panel | C] fits in shared memory
    # (gj_panel.cuh:PANEL_GLOBAL: complex f64 from 402, real f64 and
    # complex f32 from 823, real f32 from 1630), the panel and block tiers
    # on either side of that edge, 8 systems with the same three lanes
    for cplx, dtype, n in PAST_PANEL_SMEM:
        planes = [torch.as_tensor(a, dtype=dtype, device=dev)
                  for a in tier_lanes(n, 8)]
        solve = linsolve.gj_solve_planes if cplx else linsolve.gj_solve
        some = planes if cplx else planes[::2]
        plain = solve(*some)
        truth = plain if dtype == torch.float64 else solve(
            *[p.double() for p in some])
        pv = plain[-1]
        if pv[:3].any() or not pv[3:].all():
            raise AssertionError(f"tiers N={n}: plain flags "
                                 f"{pv[:4].tolist()}")
        errs = []
        for tier in ("panel", "block"):
            if cplx:
                got = gj.gj_solve_planes_cuda(*planes, tier=tier)
            else:
                got = gj_real.gj_solve_cuda(planes[0], planes[2], tier=tier)
            what = f"{'K1' if cplx else 'K2'} {tier} {TAG[dtype]} N={n}"
            if not torch.equal(got[-1], pv):
                raise AssertionError(f"{what}: valid differs")
            e = tier_err(got[:-1], plain[:-1], truth[:-1], pv, dtype, what)
            errs.append(f"{tier} {e:.1e}")
            del got
        say("2 tiers", f"{'K1' if cplx else 'K2'} {TAG[dtype]} N={n} B=8 "
            f"(past [panel | C]'s shared memory from "
            f"{PANEL_SMEM_EDGE[(cplx, dtype)] + 1}): valid identical, lanes "
            f"0-2 flagged; error / max|x|: {', '.join(errs)}")
        del planes, plain, truth
        torch.cuda.empty_cache()
    # every tier of K3 (the real inverse), forced, at K3_TIER_NS with an
    # all-zero system, a zero-row system and a NaN entry (their own
    # generator): valid identical; f64 within 1e-12 x max|inverse|, f32
    # by tier_err's rule
    rng3 = np.random.default_rng(SEED + 3)
    for dtype in (torch.float64, torch.float32):
        for n in K3_TIER_NS:
            B = 8 if n > 128 else 64
            A = rng3.standard_normal((B, n, n)) + n * np.eye(n)
            A[0] = 0.0                 # all-zero system
            A[1, n // 2] = 0.0         # zero row
            A[2, n // 2, n - 1] = np.nan
            At = torch.as_tensor(A, dtype=dtype, device=dev)
            pinv, pv = linsolve.gj_inverse(At)
            if pv[:3].any() or not pv[3:].all():
                raise AssertionError(f"K3 tiers N={n}: plain flags "
                                     f"{pv[:4].tolist()}")
            truth = pinv if dtype == torch.float64 else \
                linsolve.gj_inverse(At.double())[0]
            errs = []
            for tier in gj_real.inverse_tiers(n):
                inv, v = gj_real.gj_inverse_cuda(At, tier=tier)
                what = f"K3 {tier} {TAG[dtype]} N={n}"
                if not torch.equal(v, pv):
                    raise AssertionError(f"{what}: valid differs")
                e = tier_err((inv,), (pinv,), (truth,), pv, dtype, what)
                errs.append(f"{tier} {e:.1e}")
                del inv
            say("2 tiers", f"K3 {TAG[dtype]} N={n} B={B}: valid identical, "
                f"systems 0-2 (zero, zero row, NaN) flagged; error / "
                f"max|inverse|: {', '.join(errs)}")
            del At, pinv, truth
    torch.cuda.empty_cache()
    say("2 tiers", f"{time.perf_counter() - t2:.1f} s")

    # ---- 3-8. the main path, counted per phase ---------------------------
    f64 = torch.float64
    zero_counts()
    with open("tests/fixtures/basics01_golden.txt") as fh:
        golden = fh.read()
    out = st.format_ac_result(st.simulate(BASICS01, device=dev).ac)
    if out != golden:
        raise AssertionError("basics01 golden mismatch on cuda")
    say("3 golden", "basics01 character-exact on cuda")
    counted("3 golden", [gj.K1[f64]])

    w = 2 * np.pi * tac.build_frequency_array("dec", 100, 1.0, 100.0)

    def analytic(rc: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        wt = torch.as_tensor(w, dtype=torch.float64, device=dev)
        h = 1.0 / torch.sqrt(1.0 + (wt[None, :] * rc[:, None]) ** 2)
        return h.mean(dim=0).cpu().numpy(), h.amax(dim=0).cpu().numpy()

    h_mean, h_max = analytic(torch.as_tensor(r_big * c_big, device=dev))
    yield_s = {}
    for precision, rtol in (("f32", 2e-4), ("f64", 1e-9)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = st.mc_ac_stats(RC_NET, big_over, node="2", method="pallas",
                           precision=precision, device=dev)
        yield_s[precision] = time.perf_counter() - t0
        if s.n_valid != BIG:
            raise AssertionError(f"1M {precision}: n_valid {s.n_valid}")
        np.testing.assert_allclose(s.mean, h_mean, rtol=rtol)
        np.testing.assert_allclose(s.max, h_max, rtol=rtol)
        say("4 yield", f"1M x 201 {precision} n_valid {s.n_valid} mean/max "
            f"within {rtol:g} of analytic; {yield_s[precision]:.3f} s wall "
            "(host clock, incl. host value prep)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = st.mc_ac_sampled(RC_NET, {"r1": 0.2, "c1": 0.2}, BIG, node="2",
                         key=SEED, method="pallas", precision="f32",
                         device=dev)
    sampled_s = time.perf_counter() - t0
    # the same draws, regenerated: the sampler's Generator and call order
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    z = torch.randn((BIG, 2), generator=gen, dtype=torch.float64, device=dev)
    rc = (30.0 * torch.exp(0.2 * z[:, 0])) * (100e-6 * torch.exp(0.2 * z[:, 1]))
    hs_mean, hs_max = analytic(rc)
    if s.n_valid != BIG:
        raise AssertionError(f"sampled 1M: n_valid {s.n_valid}")
    np.testing.assert_allclose(s.mean, hs_mean, rtol=2e-4)
    np.testing.assert_allclose(s.max, hs_max, rtol=2e-4)
    say("4 yield", f"mc_ac_sampled 1M x 201 f32 n_valid {s.n_valid} within "
        f"2e-4 of analytic; {sampled_s:.3f} s wall")
    # the yield's N = 3 runs K5's register form in both precisions
    counted("4 yield", list(mc_ac_fused.K5.values()),
            tiers=[(k, "register") for k in mc_ac_fused.K5.values()])

    lad = {}
    ladder_s = {}
    for precision in ("f32", "f64"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lad[precision] = st.mc_ac_stats(ladder, lad_over, node="n62",
                                        method="pallas",
                                        precision=precision, device=dev)
        ladder_s[precision] = time.perf_counter() - t0
        if lad[precision].n_valid != LB:
            raise AssertionError(f"ladder {precision}: n_valid "
                                 f"{lad[precision].n_valid}")
    np.testing.assert_allclose(lad["f32"].mean, lad["f64"].mean, rtol=5e-3,
                               atol=1e-7)
    sub = {"r1": lad_over["r1"][:64]}
    k_sub = st.mc_ac_stats(ladder, sub, node="n62", method="pallas",
                           precision="f64", device=dev)
    p_sub = st.mc_ac_stats(ladder, sub, node="n62", method="pallas",
                           precision="f64", device="cpu")
    for f in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(getattr(k_sub, f), getattr(p_sub, f),
                                   rtol=1e-9, err_msg=f)
    say("5 ladder", f"N=64 x 2048 x 51: f32/f64 means within 5e-3; f64 "
        f"kernel = plain (cpu) on 64 variants at 1e-9; wall f32 "
        f"{ladder_s['f32']:.3f} s f64 {ladder_s['f64']:.3f} s")

    counted("5 ladder", list(gj.K1.values()))

    def k11_per_pass(label, dtype, fn):
        """``fn()``, failing unless K11 (``dtype``) launched exactly once
        per Newton pass of the batched time loop in it (the
        ``tran.newton_passes`` counter, inside ``profiled()``)."""
        k = stamp_real.K11[dtype]
        before = k.launches
        with profiling.profiled():
            out = fn()
            passes = int(profiling.counters().get("tran.newton_passes", 0))
        if k.launches - before != passes:
            raise AssertionError(f"{label}: K11 launched {k.launches - before}"
                                 f" times in {passes} Newton passes")
        return out

    # ---- 6. transient goldens on cuda -------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for deck in GOLDENS:
        net = getattr(netlists, deck)
        tran = k11_per_pass(f"6 {deck}", f64, lambda: st.simulate(
            net, device=dev).tran)
        text = st.format_tran_result(tran)
        times, nv, ec = oracle_tran(st.parse_netlist(net))
        rtol, atol = ((1e-7, 1e-9) if deck == "BOOST_CONVERTER"
                      else (1e-9, 1e-12))
        np.testing.assert_array_equal(tran.times, times)
        if list(tran.node_voltages) != list(nv) \
                or list(tran.element_currents) != list(ec):
            raise AssertionError(f"{deck}: result keys differ")
        for series, ref in ((tran.node_voltages, nv),
                            (tran.element_currents, ec)):
            for name, want in ref.items():
                np.testing.assert_allclose(series[name], want, rtol=rtol,
                                           atol=atol,
                                           err_msg=f"{deck} {name}")
        if len(text.splitlines()) != len(times) + 1:
            raise AssertionError(f"{deck}: format_tran_result rows")
    gold_s = time.perf_counter() - t0
    say("6 tran golden", f"{len(GOLDENS)} decks on cuda match the oracle "
        f"(1e-9/1e-12, boost 1e-7/1e-9); {gold_s:.2f} s wall, oracle "
        "included")
    # a deck with no unknowns: the JAX package's empty results (nothing is
    # solved, no kernel launches), equal to the CPU path's
    empty_deck = "t\n.op\n.ac oct 10 1 100\n.tran 1u 1m\n"
    got = st.simulate(empty_deck, dialect="extended", device=dev)
    want = st.simulate(empty_deck, dialect="extended", device="cpu")
    if got.op.node_voltages or got.op.element_currents \
            or got.ac.node_voltages or got.tran.node_voltages \
            or len(got.ac.freqs) != 68 or len(got.tran.times) != 1002:
        raise AssertionError("empty deck: results not empty")
    np.testing.assert_array_equal(got.ac.freqs, want.ac.freqs)
    np.testing.assert_array_equal(got.tran.times, want.tran.times)
    say("6 tran golden", "a deck with no unknowns on cuda: empty .op, .ac "
        "(68 frequencies) and .tran (1002 times), as on the CPU path")
    # the linear decks' factor-once inverses run K3's register form
    counted("6 tran golden", [gj_real.K2[f64], gj_real.K3[f64],
                              stamp_real.K11[f64]],
            tiers=[(gj_real.K3[f64], "register")])

    # ---- 7. tran-1M: the RC transient, 1M variants x 201 steps -----------
    vs_rc = torch.as_tensor(sample_source_values(
        tran_ckt, np.arange(tran_steps + 1) * tran_dt)[:, 0], dtype=f64,
        device=dev)

    def be_recurrence(r: torch.Tensor, c: torch.Tensor):
        """Mean and max over the variants of the exact backward-Euler
        recurrence v_n = (v_{n-1} + (dt/RC) vs_n) / (1 + dt/RC), f64."""
        a = tran_dt / (r * c)
        v = torch.zeros_like(a)
        means, maxs = [], []
        for n in range(tran_steps + 1):
            v = (v + a * vs_rc[n]) / (1.0 + a)
            means.append(v.mean())
            maxs.append(v.amax())
        return torch.stack(means), torch.stack(maxs)

    def check_stats(got, mean, mx, rtol, what):
        return max(check_close(torch.as_tensor(got.mean), mean.cpu(), rtol,
                               f"{what} mean"),
                   check_close(torch.as_tensor(got.max), mx.cpu(), rtol,
                               f"{what} max"))

    be_mean, be_max = be_recurrence(
        torch.as_tensor(r_tran, dtype=f64, device=dev),
        torch.as_tensor(c_tran, dtype=f64, device=dev))
    tran_over = {"R1": r_tran, "C1": c_tran}
    tran_s = {}
    for label, method, precision, rtol in (
            ("f32 fused (K8)", "pallas", "f32", 2e-4),
            ("f32 loop (K3)", "gj", "f32", 2e-4),
            ("f64 loop (K3)", "pallas", "f64", 1e-9)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = st.mc_tran_stats(TRAN_NET, tran_over, node="2", method=method,
                              precision=precision, device=dev)
        tran_s[label] = time.perf_counter() - t0
        if ts.n_valid != BIG:
            raise AssertionError(f"tran-1M {label}: n_valid {ts.n_valid}")
        e = check_stats(ts, be_mean, be_max, rtol, f"tran-1M {label}")
        say("7 tran-1M", f"{label}: n_valid {ts.n_valid}, mean/max within "
            f"{rtol:g} of the BE recurrence (max abs err {e:.3e}); "
            f"{tran_s[label]:.3f} s wall (host clock, incl. host value prep)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts = st.mc_tran_sampled(TRAN_NET, {"R1": 0.2, "C1": 0.2}, BIG, node="2",
                            key=SEED, method="pallas", precision="f32",
                            device=dev)
    sampled_tran_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    z = torch.randn((BIG, 2), generator=gen, dtype=f64, device=dev)
    sm, sx = be_recurrence(1e3 * torch.exp(0.2 * z[:, 0]),
                           1e-6 * torch.exp(0.2 * z[:, 1]))
    if ts.n_valid != BIG:
        raise AssertionError(f"sampled tran-1M: n_valid {ts.n_valid}")
    e = check_stats(ts, sm, sx, 2e-4, "sampled tran-1M")
    say("7 tran-1M", f"mc_tran_sampled 1M f32 (K8) n_valid {ts.n_valid} "
        f"within 2e-4 of the BE recurrence (max abs err {e:.3e}); "
        f"{sampled_tran_s:.3f} s wall")
    counted("7 tran-1M", [mc_tran_fused.K8[torch.float32],
                          gj_real.K3[torch.float32], gj_real.K3[f64]],
            ((mc_tran_fused.K8[torch.float32], "register"),
             (gj_real.K3[torch.float32], "register"),
             (gj_real.K3[f64], "register")))
    torch.cuda.empty_cache()

    # ---- 8. boost-100k: the switch+diode converter, 100k variants --------
    boost_over = {"RR1": 1e3 * (1 + 0.1 * rng.random(BOOST_B))}
    boost = {}
    boost_s = {}
    for precision in ("f64", "f32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boost[precision] = k11_per_pass(
            f"8 boost-100k {precision}",
            torch.float64 if precision == "f64" else torch.float32,
            lambda: st.mc_tran_stats(BOOST_NET, boost_over, node="N3",
                                     precision=precision, device=dev))
        boost_s[precision] = time.perf_counter() - t0
        if boost[precision].n_valid != BOOST_B:
            raise AssertionError(f"boost {precision}: n_valid "
                                 f"{boost[precision].n_valid}")
    scale = float(np.abs(boost["f64"].mean).max())
    d32 = float(np.abs(boost["f32"].mean - boost["f64"].mean).max())
    if d32 > 5e-3 * scale:
        raise AssertionError(f"boost f32 mean off f64 by {d32:.3e}")
    sub = {"RR1": boost_over["RR1"][:64]}
    k_sub = st.mc_tran_stats(BOOST_NET, sub, node="N3", device=dev)
    p_sub = st.mc_tran_stats(BOOST_NET, sub, node="N3", device="cpu")
    for f in ("mean", "std", "min", "max"):
        want = getattr(p_sub, f)
        np.testing.assert_allclose(getattr(k_sub, f), want, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(want).max()),
                                   err_msg=f)
    say("8 boost-100k", f"{BOOST_B} variants x 101 steps: n_valid "
        f"{BOOST_B} at f64 and f32; f32 mean within {d32:.2e} of f64 "
        f"(limit {5e-3 * scale:.2e}); f64 kernel = CPU path on 64 variants "
        f"at 1e-9; wall f64 {boost_s['f64']:.3f} s f32 "
        f"{boost_s['f32']:.3f} s")
    counted("8 boost-100k", list(gj_real.K2.values())
            + list(stamp_real.K11.values()),
            tiers=[(k, "tile") for k in stamp_real.K11.values()])
    torch.cuda.empty_cache()

    def f32_vs_f64(f32s, f64s, what):
        """The f32 fused tier's mean within 5e-3 x scale of the f64 loop's
        (bench.py:676-680); returns the difference and the limit."""
        scale = float(np.abs(f64s.mean).max()) + 1e-30
        d = float(np.abs(f32s.mean - f64s.mean).max())
        if d > 5e-3 * scale:
            raise AssertionError(f"{what}: f32 mean off f64 by {d:.3e}")
        return d, 5e-3 * scale

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    k9_kw = dict(method="pallas", precision="f32", device=dev)

    # ---- 10. ring MC: the bench's nonlinear_ring, K9 against the loop ----
    ring_over = {"c1": 1e-9 * (1 + 0.1 * rng.random(BOOST_B)),
                 "c2": 1e-9 * (1 + 0.1 * rng.random(BOOST_B))}
    r4k = {k: v[:RING_B] for k, v in ring_over.items()}
    r32, r32_s = timed(lambda: st.mc_tran_stats(
        RING_NET, r4k, node="n1", dialect="extended", **k9_kw))
    r64, r64_s = timed(lambda: st.mc_tran_stats(
        RING_NET, r4k, node="n1", dialect="extended", device=dev))
    if r32.n_valid != RING_B or r64.n_valid != RING_B:
        raise AssertionError(f"ring: n_valid {r32.n_valid}, {r64.n_valid}")
    d, lim = f32_vs_f64(r32, r64, "ring 4096")
    sub = {k: v[:64] for k, v in r4k.items()}
    k_sub = st.mc_tran_stats(RING_NET, sub, node="n1", dialect="extended",
                             device=dev)
    p_sub = st.mc_tran_stats(RING_NET, sub, node="n1", dialect="extended",
                             device="cpu")
    for f in ("mean", "std", "min", "max"):
        want = getattr(p_sub, f)
        np.testing.assert_allclose(getattr(k_sub, f), want, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(want).max()),
                                   err_msg=f"ring subset {f}")
    r100, r100_s = timed(lambda: st.mc_tran_stats(
        RING_NET, ring_over, node="n1", dialect="extended", **k9_kw))
    if r100.n_valid != BOOST_B:
        raise AssertionError(f"ring 100k: n_valid {r100.n_valid}")
    say("10 ring MC", f"{RING_B} x 101 steps: f32 K9 mean within {d:.2e} "
        f"of the f64 loop (limit {lim:.2e}); f64 cuda = CPU on 64 variants "
        f"at 1e-9; wall f32 K9 {r32_s:.3f} s, f64 loop {r64_s:.3f} s; "
        f"{BOOST_B} variants through K9: n_valid {r100.n_valid}, wall "
        f"{r100_s:.3f} s")
    counted("10 ring MC", [mc_tran_fused.K9[torch.float32],
                           gj_real.K2[f64]],
            ((mc_tran_fused.K9[torch.float32], "register"),))

    # ---- 11. switch-diode MC: the bench's switch_diode, both grids -------
    sw_over = {"RR1": 1e3 * (1 + 0.1 * rng.random(BOOST_B))}
    sw_s = {}
    for label, net, n_sub in (("1 ms grid", BOOST_NET, 64),
                              ("10 us grid", BOOST_FINE, RING_B)):
        s32, sw_s[label] = timed(lambda: st.mc_tran_stats(
            net, sw_over, node="N3", **k9_kw))
        if s32.n_valid != BOOST_B:
            raise AssertionError(f"switch-diode {label}: n_valid "
                                 f"{s32.n_valid}")
        sub = {"RR1": sw_over["RR1"][:n_sub]}
        s32_sub = st.mc_tran_stats(net, sub, node="N3", **k9_kw)
        s64_sub, s64_s = timed(lambda: st.mc_tran_stats(
            net, sub, node="N3", device=dev))
        d, lim = f32_vs_f64(s32_sub, s64_sub, f"switch-diode {label}")
        say("11 switch-diode MC", f"{label}: {BOOST_B} variants x "
            f"{len(s32.grid)} steps through K9, n_valid {s32.n_valid}, wall "
            f"{sw_s[label]:.3f} s; {n_sub}-variant subset f32 mean within "
            f"{d:.2e} of the f64 loop (limit {lim:.2e}, f64 loop "
            f"{s64_s:.3f} s)")
    counted("11 switch-diode MC", [mc_tran_fused.K9[torch.float32],
                                   gj_real.K2[f64]],
            ((mc_tran_fused.K9[torch.float32], "register"),))

    # ---- 12. BJT MC: BJT_NET with Q1's Is swept (_batched_nl) ------------
    q_over = {"Q1": 1e-15 * (1 + 0.2 * rng.random(BOOST_B))}
    q32, q_s = timed(lambda: st.mc_tran_stats(
        BJT_NET, q_over, node="c1", dialect="extended", **k9_kw))
    if q32.n_valid != BOOST_B:
        raise AssertionError(f"BJT MC: n_valid {q32.n_valid}")
    sub = {"Q1": q_over["Q1"][:RING_B]}
    q32_sub = st.mc_tran_stats(BJT_NET, sub, node="c1", dialect="extended",
                               **k9_kw)
    q64_sub, q64_s = timed(lambda: st.mc_tran_stats(
        BJT_NET, sub, node="c1", dialect="extended", device=dev))
    d, lim = f32_vs_f64(q32_sub, q64_sub, "BJT MC")
    say("12 BJT MC", f"{BOOST_B} variants x {len(q32.grid)} steps through "
        f"K9, n_valid {q32.n_valid}, wall {q_s:.3f} s; {RING_B}-variant "
        f"subset f32 mean within {d:.2e} of the f64 loop (limit {lim:.2e}, "
        f"f64 loop {q64_s:.3f} s)")
    counted("12 BJT MC", [mc_tran_fused.K9[torch.float32], gj_real.K2[f64]],
            ((mc_tran_fused.K9[torch.float32], "register"),))

    # ---- 13. single nonlinear decks through simulate() on cuda -----------
    for label, net in (("ring_deck", RING_DECK), ("bjt_amp_deck",
                                                  BJT_AMP_DECK)):
        got, g_s = timed(lambda: st.simulate(net, dialect="extended",
                                             device=dev).tran)
        want = st.simulate(net, dialect="extended", device="cpu").tran
        np.testing.assert_array_equal(got.times, want.times)
        for series, ref in ((got.node_voltages, want.node_voltages),
                            (got.element_currents, want.element_currents)):
            for name, w in ref.items():
                np.testing.assert_allclose(series[name], w, rtol=1e-9,
                                           atol=1e-12,
                                           err_msg=f"{label} {name}")
        say("13 single decks", f"{label} ({len(got.times)} steps) on cuda "
            f"equals the CPU path at 1e-9; {g_s:.3f} s wall")
    counted("13 single decks", [gj_real.K2[f64]])

    def same(got, want, what, rtol=1e-9, atol=1e-12):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)

    def same_op(got, want, what):
        for series, ref in ((got.node_voltages, want.node_voltages),
                            (got.element_currents, want.element_currents)):
            if list(series) != list(ref):
                raise AssertionError(f"{what}: result keys differ")
            for name, v in ref.items():
                same(series[name], v, f"{what} {name}")

    def same_noise(got, want, what):
        """Output PSD and gain at 1e-9; every contribution within 1e-9 of
        its own value or of the total output PSD at its frequency."""
        same(got.output_psd, want.output_psd, f"{what} psd", atol=0.0)
        # the ladder's far-end gain underflows to 0 at the top of the
        # sweep: held at the scale of the sweep there
        same(got.gain, want.gain, f"{what} gain",
             atol=1e-12 * float(np.abs(want.gain).max()))
        for name, c in want.contributions.items():
            bad = (np.abs(got.contributions[name] - c)
                   > 1e-9 * (np.abs(c) + want.output_psd))
            if bad.any():
                raise AssertionError(f"{what} contribution {name}")

    # ---- 14. the bench's op/dc/tf deck through simulate() ----------------
    t_op = time.perf_counter()
    got, g_s = timed(lambda: st.simulate(OPDCTF_DECK, dialect="extended",
                                         device=dev))
    want = st.simulate(OPDCTF_DECK, dialect="extended", device="cpu")
    same_op(got.op, want.op, "opdctf .op")
    for name, v in want.dc.node_voltages.items():
        same(got.dc.node_voltages[name], v, f"opdctf .dc {name}")
    for f in ("transfer_function", "input_impedance", "output_impedance"):
        same(getattr(got.tf, f), getattr(want.tf, f), f"opdctf .tf {f}")
    say("14 op/dc/tf", f".op, .dc ({len(got.dc.sweep)} points, Newton "
        f"passes per point mean {got.dc.passes.mean():.1f} max "
        f"{got.dc.passes.max()}) and .tf on cuda equal the CPU path at "
        f"1e-9; {g_s:.3f} s wall")
    counted("14 op/dc/tf", [gj_real.K2[f64]])

    # ---- 15. dc-2d-25k and op-batch-100k -----------------------------------
    iv, iv_s = timed(lambda: st.simulate(MOS_IV_DECK, dialect="extended",
                                         device=dev).dc)
    n_iv = len(iv.sweep)
    if n_iv != 25_551 or not iv.valid.all():
        raise AssertionError(f"dc-2d: {int(iv.valid.sum())}/{n_iv} valid")
    lanes = np.sort(rng.choice(n_iv, 64, replace=False))
    sub = st.op_batch(MOS_IV_DECK, {"vds": iv.sweep[lanes],
                                    "vgs": iv.sweep2[lanes]},
                      dialect="extended", device="cpu")
    for name in ("d", "gt"):
        same(iv.node_voltages[name][lanes], sub.node_voltage(name),
             f"dc-2d {name}")
    say("15 dc-2d-25k", f"MOSFET output characteristics {iv.shape2d} = "
        f"{n_iv} points on cuda: n_valid {int(iv.valid.sum())}; a 64-point "
        f"subset equals the CPU path at 1e-9; Newton passes per point mean "
        f"{iv.passes.mean():.2f} max {iv.passes.max()}; {iv_s:.3f} s wall")
    ob_over = {"Q1": 1e-15 * (1 + 0.2 * rng.random(BOOST_B)),
               "VIN": np.full(BOOST_B, 0.65)}
    ob, ob_s = timed(lambda: st.op_batch(BJT_NET, ob_over,
                                         dialect="extended", device=dev))
    if not ob.valid.all():
        raise AssertionError(f"op-batch: {int(ob.valid.sum())} valid")
    sub = st.op_batch(BJT_NET, {k: v[:64] for k, v in ob_over.items()},
                      dialect="extended", device="cpu")
    same(ob.x[:64], sub.x, "op-batch subset")
    say("15 op-batch-100k", f"BJT_NET bias (VIN 0.65 V, Q1 Is at U(1, 1.2)"
        f" x 1e-15), {BOOST_B} variants on cuda: n_valid "
        f"{int(ob.valid.sum())}; 64 equal the CPU path at 1e-9; Newton "
        f"passes per variant mean {ob.passes.mean():.2f} max "
        f"{ob.passes.max()}; {ob_s:.3f} s wall")
    counted("15 dc-2d/op-batch", [gj_real.K2[f64]])

    # ---- 16. the two-stage amplifier: .op, .tf, acop .ac, .noise -----------
    amp, amp_s = timed(lambda: st.simulate(AMP_DECK, dialect="extended",
                                           device=dev))
    want = st.simulate(AMP_DECK, dialect="extended", device="cpu")
    same_op(amp.op, want.op, "amp .op")
    for f in ("transfer_function", "input_impedance", "output_impedance"):
        same(getattr(amp.tf, f), getattr(want.tf, f), f"amp .tf {f}")
    for name, z in want.ac.node_voltages.items():
        same(amp.ac.node_voltages[name], z, f"amp .ac {name}")
    same_noise(amp.noise, want.noise, "amp .noise")
    say("16 amp", f"N={st.build_tensors(amp.circuit).nvar}, "
        f"{len(amp.noise.freqs)} frequencies: .op, .tf, .options acop .ac "
        f"and .noise on cuda equal the CPU path at 1e-9; guard re-solves "
        f"{amp.noise.guard_resolves} (CPU path "
        f"{want.noise.guard_resolves}); output noise "
        f"{amp.noise.total_output_rms:.4e} Vrms; {amp_s:.3f} s wall")
    counted("16 amp", [gj.K4[f64], gj.K1[f64], gj_real.K2[f64]],
            tiers=[(gj.K1[f64], "warp"), (gj.K4[f64], "warp")])

    # ---- 17. ladder-64 noise: an RC interconnect's thermal noise -----------
    lad_n, lad_s = timed(lambda: st.simulate(LADDER_NOISE,
                                             dialect="extended",
                                             device=dev).noise)
    want = st.simulate(LADDER_NOISE, dialect="extended", device="cpu").noise
    same_noise(lad_n, want, "ladder .noise")
    say("17 ladder noise", f"N=64, {len(lad_n.freqs)} frequencies on cuda "
        f"equal the CPU path at 1e-9; guard re-solves "
        f"{lad_n.guard_resolves} (CPU path {want.guard_resolves}); output "
        f"noise {lad_n.total_output_rms:.4e} Vrms; {lad_s:.3f} s wall; "
        f"phases 14-17 {time.perf_counter() - t_op:.1f} s with their CPU "
        "comparisons")
    counted("17 ladder noise", [gj.K4[f64]], tiers=[(gj.K4[f64], "panel")])

    def same_x(got, want, what):
        """Complex solutions at rtol 1e-9, atol 1e-12 of the largest
        (the far taps of a ladder are many decades below its input)."""
        same(got, want, what, atol=1e-12 * float(np.abs(want).max()))

    # ---- 18. batch-ac-16k: every tap of the N = 16 ladder (K7) -----------
    ac16, ac16_s = timed(lambda: st.simulate_ac_batch(
        lad16, ac16_over, method="pallas", device=dev))
    if ac16.x.shape != (AC16_B, 201, 16) or not ac16.valid.all():
        raise AssertionError(f"batch-ac-16k: {ac16.x.shape}, "
                             f"{int(ac16.valid.sum())} valid")
    sub = {k: v[:64] for k, v in ac16_over.items()}
    same_x(ac16.x[:64], st.simulate_ac_batch(
        lad16, sub, method="pallas", device="cpu").x, "batch-ac-16k cpu")
    sub = {k: v[:1024] for k, v in ac16_over.items()}
    k1_16, k1_16_s = timed(lambda: st.simulate_ac_batch(
        lad16, sub, method="gj", device=dev))
    same_x(ac16.x[:1024], k1_16.x, "batch-ac-16k K1 route")
    say("18 batch-ac-16k", f"N=16 ladder, {AC16_B} variants x 201 "
        f"frequencies through K7 (f64): valid {int(ac16.valid.sum())}/"
        f"{ac16.valid.size}; 64 variants equal the CPU path and 1024 the K1 "
        f"route at 1e-9; wall {ac16_s:.3f} s (K1 route on 1024: "
        f"{k1_16_s:.3f} s), x {ac16.x.nbytes / 1e6:.0f} MB on the host")
    counted("18 batch-ac-16k", [mc_ac_fused.K7[f64], gj.K1[f64]])
    del ac16, k1_16
    lad64, lad64_s = timed(lambda: st.simulate_ac_batch(
        ladder, lad_over, method="pallas", device=dev))
    if not lad64.valid.all():
        raise AssertionError("batch-ladder-64: invalid systems")
    sub = {"r1": lad_over["r1"][:64]}
    same_x(lad64.x[:64], st.simulate_ac_batch(ladder, sub, device="cpu").x,
           "batch-ladder-64 cpu")
    say("18 batch-ladder-64", f"N=64 ladder, {LB} variants x 51 frequencies "
        f"with full solutions through K1: valid {int(lad64.valid.sum())}/"
        f"{lad64.valid.size}; 64 equal the CPU path at 1e-9; wall "
        f"{lad64_s:.3f} s")
    counted("18 batch-ladder-64", [gj.K1[f64]])
    del lad64
    torch.cuda.empty_cache()

    # ---- 19. batch transient: full trajectories (K3, K2) ------------------
    for label, net, dialect, over in (
            ("RC 100k (K3)", TRAN_NET, "spicey",
             {"R1": r_tran[:BOOST_B], "C1": c_tran[:BOOST_B]}),
            ("boost 100k (K2)", BOOST_NET, "spicey", boost_over),
            ("ring 4096 (K2, Newton to convergence)", RING_NET, "extended",
             r4k)):
        bt, bt_s = timed(lambda: k11_per_pass(
            f"19 batch-tran {label}", f64, lambda: st.simulate_tran_batch(
                net, over, dialect=dialect, device=dev)))
        nb = len(next(iter(over.values())))
        n_sw = st.build_tensors(st.parse_netlist(net, dialect=dialect)).n_s
        if not bt.valid.all() \
                or bt.sw_states.shape != (nb, len(bt.times), n_sw):
            raise AssertionError(f"batch-tran {label}: "
                                 f"{int(bt.valid.sum())} valid, sw_states "
                                 f"{bt.sw_states.shape}")
        cpu = st.simulate_tran_batch(net, {k: v[:64] for k, v in over.items()},
                                     dialect=dialect, device="cpu")
        same(bt.xs[:64], cpu.xs, f"batch-tran {label}",
             atol=1e-12 * float(np.abs(cpu.xs).max()))
        np.testing.assert_array_equal(bt.sw_states[:64], cpu.sw_states)
        say("19 batch-tran", f"{label}: {nb} variants x {len(bt.times)} "
            f"steps, valid {int(bt.valid.sum())}; 64 equal the CPU path at "
            f"1e-9; wall {bt_s:.3f} s, xs {bt.xs.nbytes / 1e6:.0f} MB")
        del bt
    counted("19 batch-tran", [gj_real.K3[f64], gj_real.K2[f64],
                              stamp_real.K11[f64]],
            tiers=[(gj_real.K3[f64], "register")])

    # ---- 20. .step through simulate(): 1,001 corners of an RLC low-pass ---
    stp, stp_s = timed(lambda: st.simulate(STEP_DECK, dialect="extended",
                                           method="pallas", device=dev))
    want = st.simulate(STEP_DECK, dialect="extended", method="pallas",
                       device="cpu").step
    got = stp.step
    if len(got.values) != 1001:
        raise AssertionError(f".step: {len(got.values)} lanes")
    for what, g, w in (("ac", got.ac.x, want.ac.x),
                       ("tran", got.tran.xs, want.tran.xs),
                       ("op", got.op.x, want.op.x)):
        same_x(g, w, f".step {what}")
    if not (got.ac.valid.all() and got.tran.valid.all()
            and got.op.valid.all()):
        raise AssertionError(".step: invalid lanes")
    same(got.op.node_voltage("out"), 10.0 * 1e3 / (got.values + 1e3),
         ".step .op divider")
    say("20 step", f"r1 stepped over {len(got.values)} values: .op, .ac "
        f"({got.ac.x.shape[1]} points, K7) and .tran ({got.tran.xs.shape[1]}"
        f" points) on cuda equal the CPU path at 1e-9, .op the divider's "
        f"closed form; {stp_s:.3f} s wall")
    counted("20 step", [mc_ac_fused.K7[f64], gj_real.K3[f64],
                        gj_real.K2[f64], gj.K1[f64]],
            tiers=[(gj_real.K3[f64], "register")])
    torch.cuda.empty_cache()

    # ---- 21. flat decks past N = 128 through the public entry points ------
    flat256 = rc_ladder_netlist(254)
    f256_over = {"r1": 101.0 * (1 + 0.2 * rng.random(16))}
    s256, s256_s = timed(lambda: st.mc_ac_stats(flat256, f256_over,
                                                node="n254", device=dev))
    if s256.n_valid != 16:
        raise AssertionError(f"flat-256: n_valid {s256.n_valid}")
    # the CPU path's cost grows as N^3: two variants (~30 s of CPU)
    sub = {"r1": f256_over["r1"][:2]}
    k_sub = st.mc_ac_stats(flat256, sub, node="n254", device=dev)
    p_sub, p_s = timed(lambda: st.mc_ac_stats(flat256, sub, node="n254",
                                              device="cpu"))
    if k_sub.n_valid != 2 or p_sub.n_valid != 2:
        raise AssertionError("flat-256 subset: invalid variants")
    for f in ("mean", "std", "min", "max"):
        want = getattr(p_sub, f)
        same(getattr(k_sub, f), want, f"flat-256 {f}",
             atol=1e-12 * float(np.abs(want).max()))
    say("21 past 128", f"mc_ac_stats of rc_ladder_netlist(254), N=256, 16 "
        f"variants x {len(s256.grid)} frequencies (K1 f64, "
        f"{gj.tier_for(256, f64)} tier): n_valid {s256.n_valid}, wall "
        f"{s256_s:.3f} s; 2 variants equal the CPU path at 1e-9 (CPU "
        f"{p_s:.1f} s)")
    counted("21 flat-256", [gj.K1[f64]], tiers=[(gj.K1[f64], "panel")])
    lad129 = rc_ladder_netlist(127)
    ac129, ac129_s = timed(lambda: st.simulate(lad129, device=dev).ac)
    want = st.simulate(lad129, device="cpu").ac
    for series, ref in ((ac129.node_voltages, want.node_voltages),
                        (ac129.element_currents, want.element_currents)):
        for name, z in ref.items():
            same(series[name], z, f"ac-129 {name}")
    dc129 = lad129.replace("v1 in 0 dc 0 ac 1", "v1 in 0 dc 1")
    op129, op129_s = timed(lambda: st.simulate_op(st.parse_netlist(dc129),
                                                  device=dev))
    same_op(op129, st.simulate_op(st.parse_netlist(dc129), device="cpu"),
            "op-129")
    same(op129.node_voltages["n127"], 1.0, "op-129 far tap")
    tr129 = tran_ladder(127)
    got, tr129_s = timed(lambda: st.simulate(tr129, device=dev).tran)
    want = st.simulate(tr129, device="cpu").tran
    np.testing.assert_array_equal(got.times, want.times)
    for series, ref in ((got.node_voltages, want.node_voltages),
                        (got.element_currents, want.element_currents)):
        for name, v in ref.items():
            same(series[name], v, f"tran-129 {name}")
    say("21 past 128", f"rc_ladder_netlist(127), N=129, on cuda equals the "
        f"CPU path at 1e-9: simulate() .ac ({len(ac129.freqs)} points, "
        f"{ac129_s:.3f} s), simulate_op at 1 V DC (refused before; "
        f"{op129_s:.3f} s), simulate() .tran ({len(got.times)} points, "
        f"factor-once; {tr129_s:.3f} s)")
    counted("21 N=129 decks", [gj.K1[f64], gj_real.K2[f64], gj_real.K3[f64]],
            tiers=[(gj.K1[f64], "panel"), (gj_real.K2[f64], "panel"),
                   (gj_real.K3[f64], "panel")])
    del s256, k_sub, got
    torch.cuda.empty_cache()
    # the Monte-Carlo transients of phase 9's K3 shapes (b) and (d): the
    # ladder-64 and flat-256 decks under a pulse through mc_tran_stats
    # (the loop, K3 once in its panel tier), 2 variants each equal to the
    # CPU path at 1e-9
    rng21 = np.random.default_rng(SEED + 21)  # later draws stay as they were
    for label, sections, nb, node in (("ladder-64", 62, 2048, "n62"),
                                      ("flat-256", 254, 16, "n254")):
        net = tran_ladder(sections)
        over = {"r1": 101.0 * (1 + 0.2 * rng21.random(nb))}
        ts, ts_s = timed(lambda: st.mc_tran_stats(net, over, node=node,
                                                  device=dev))
        if ts.n_valid != nb:
            raise AssertionError(f"{label} MC tran: n_valid {ts.n_valid}")
        sub = {"r1": over["r1"][:2]}
        k_sub = st.mc_tran_stats(net, sub, node=node, device=dev)
        p_sub = st.mc_tran_stats(net, sub, node=node, device="cpu")
        for f in ("mean", "std", "min", "max"):
            want = getattr(p_sub, f)
            same(getattr(k_sub, f), want, f"{label} MC tran {f}",
                 atol=1e-12 * float(np.abs(want).max()))
        say("21 MC tran", f"mc_tran_stats of {label} under a pulse, "
            f"{nb} variants x {len(ts.grid)} steps (K3 f64 "
            f"{gj_real.tier_for(sections + 2, f64, inverse=True)} tier): "
            f"n_valid {ts.n_valid}, wall {ts_s:.3f} s; 2 variants equal the "
            f"CPU path at 1e-9")
    counted("21 MC tran", [gj_real.K3[f64]],
            tiers=[(gj_real.K3[f64], "panel")])
    torch.cuda.empty_cache()

    # ---- 22. the solver sweep at N = 32, 64 and 128 (K10's path) ---------
    # N = 32 must run K1 and K2 in their warp tier, N = 64 and 128 each in
    # the tier ops/gj.py and ops/gj_real.py choose
    t22 = time.perf_counter()
    for ns in ((32,), (64, 128)):
        sweep_rows = solver.sweep(ns, reps=2, seed=SEED, dev=dev,
                                  emit=lambda line: say("22 sweep row",
                                                        line))
        for row in sweep_rows:
            mc = row["mc_ac_stats"]
            for tag, sv in row["solvers"].items():
                rows = {r["name"]: r for r in sv["rows"]}
                sps = {k: r["systems_per_s"] for k, r in rows.items()}
                lib_c = next(k for k in sps if k.startswith("linalg.solve c"))
                lib_r = next(k for k in sps if k.startswith("linalg.solve f"))
                k10 = ""
                if "K10b" in sps:
                    if tag == "f64" and max(sv["K10b_vs_K1"],
                                            sv["K10a_vs_K2"]) > 1e-9:
                        raise AssertionError(
                            f"sweep N={row['n']}: K10 off K1/K2 by "
                            f"{sv['K10b_vs_K1']:.2e} / "
                            f"{sv['K10a_vs_K2']:.2e}")
                    k10 = (f"; K10b {sps['K10b']:.4g}, K10a "
                           f"{sps['K10a']:.4g}, K10 - K1/K2 "
                           f"{sv['K10b_vs_K1']:.2e} / "
                           f"{sv['K10a_vs_K2']:.2e} of max|x|")
                say("22 sweep", f"N={row['n']} {tag}, {sv['systems']} "
                    f"systems, systems/s: complex K1 ({rows['K1']['tier']}) "
                    f"{sps['K1']:.4g}, {lib_c} {sps[lib_c]:.4g}; real K2 "
                    f"({rows['K2']['tier']}) {sps['K2']:.4g}, {lib_r} "
                    f"{sps[lib_r]:.4g}{k10} | {smi}")
            say("22 sweep", f"N={row['n']} mc_ac_stats through K1: f32 "
                f"{mc['pallas_f32']['systems_per_s']:.4g}, f64 "
                f"{mc['gj_f64']['systems_per_s']:.4g} systems/s (host "
                "clock)")
        if ns == (32,):
            counted("22 sweep N=32", list(gj.K1.values())
                    + list(gj_real.K2.values()),
                    tiers=[(k, "warp") for k in list(gj.K1.values())
                           + list(gj_real.K2.values())])
        else:
            counted("22 sweep N=64, 128", list(mxu.K10a.values())
                    + list(mxu.K10b.values()) + list(gj.K1.values())
                    + list(gj_real.K2.values()))
        torch.cuda.empty_cache()
    say("22 sweep", f"{time.perf_counter() - t22:.1f} s")

    # ---- 23. K, T and B elements (ROADMAP §1 item 2) ----------------------
    # each workload through the public entry points, its launches counted
    # on their own: the counters are zeroed just before its main-path
    # calls and read just after, before any comparison run; a wall is the
    # median of three warm calls, each ending in synchronize() (host clock)
    from spicey_tpu_torch import decks

    t23 = time.perf_counter()
    rng23 = np.random.default_rng(SEED + 23)  # later draws stay as they were
    K2f, K3f = gj_real.K2[f64], gj_real.K3[f64]

    def workload(phase, fn, expect, tiers=(), reps=3, absent=(),
                 per_call=()):
        """Run ``fn`` once warm and ``reps`` times timed on its own
        counters; fail unless every kernel of ``expect`` (and tier of
        ``tiers``) launched, none of ``absent`` did, and each (kernel, n)
        of ``per_call`` launched at least n times a call. Returns the last
        timed call's result and the median wall."""
        zero_counts()
        timed(fn)  # warm
        runs = [timed(fn) for _ in range(reps)]
        calls = reps + 1
        bad = [k.name for k in absent if k.launches]
        bad += [f"{k.name} {k.launches} < {n} x {calls}"
                for k, n in per_call if k.launches < n * calls]
        if bad:
            raise AssertionError(f"{phase}: launches {bad}")
        counted(phase, expect, tiers)
        return runs[-1][0], float(np.median([s for _, s in runs]))

    def same_tran(got, want, what, known=None):
        """Node voltages and element currents at rtol 1e-9, atol 1e-12 of
        the field's largest value; ``known`` (series name -> atol) names
        the series held to their own recorded atol instead."""
        np.testing.assert_array_equal(got.times, want.times)
        for series, ref in ((got.node_voltages, want.node_voltages),
                            (got.element_currents, want.element_currents)):
            if list(series) != list(ref):
                raise AssertionError(f"{what}: result keys differ")
            scale = max(float(np.abs(v).max()) for v in ref.values())
            for name, v in ref.items():
                atol = (known or {}).get(name, 1e-12 * scale)
                same(series[name], v, f"{what} {name}", atol=atol)

    def same_stats(got, want, what, rtol=1e-9, atol_of_max=1e-12):
        """Mean, std, min and max at ``rtol``, with an atol of
        ``atol_of_max`` of the largest |value| any variant took (the
        statistics' own scale: the std of lanes that are all equal is the
        rounding of the values, not a quantity of its own)."""
        if got.n_valid != want.n_valid:
            raise AssertionError(f"{what}: n_valid {got.n_valid} against "
                                 f"{want.n_valid}")
        atol = atol_of_max * float(max(np.abs(want.min).max(),
                                       np.abs(want.max).max()))
        for f in ("mean", "std", "min", "max"):
            same(getattr(got, f), getattr(want, f), f"{what} {f}",
                 rtol=rtol, atol=atol)

    # (a) transformer-100k: the transformer's .ac against the CPU path and
    # its closed form, the .tran against the CPU path; mc_ac_stats over
    # 100k (rload, l1, l2) variants (K1, M^-1 per variant by K3) against
    # the CPU path on the same 100k, and simulate_tran_batch over 16,384
    # coupling coefficients (K3 twice a call: M^-1 and the factor-once
    # matrix, and no K2: every step multiplies by that inverse)
    X = "extended"
    xac, xac_s = workload(
        "23a transformer .ac", lambda: st.simulate(
            decks.TRANSFORMER_AC, dialect=X, device=dev).ac,
        [gj.K1[f64], K3f], tiers=[(K3f, "register")])
    want = st.simulate(decks.TRANSFORMER_AC, dialect=X, device="cpu").ac
    for series, ref in ((xac.node_voltages, want.node_voltages),
                        (xac.element_currents, want.element_currents)):
        for name, v in ref.items():
            same(series[name], v, f"transformer ac {name}")
    ref = decks.analytic_transformer(xac.freqs)
    same(xac.node_voltages["p"], ref[:, 0], "transformer ac v(p) analytic")
    same(xac.node_voltages["s"], ref[:, 1], "transformer ac v(s) analytic")
    xtr, xtr_s = workload(
        "23a transformer .tran", lambda: st.simulate(
            decks.TRANSFORMER_TRAN, dialect=X, device=dev).tran,
        [K3f], tiers=[(K3f, "register")], absent=[K2f],
        per_call=[(K3f, 2)])
    same_tran(xtr, st.simulate(decks.TRANSFORMER_TRAN, dialect=X,
                               device="cpu").tran, "transformer tran")
    XB = 100_000
    x_over = {k: v * rng23.uniform(0.9, 1.1, XB)
              for k, v in (("rload", 100.0), ("l1", 1.0), ("l2", 4.0))}
    xmc, xmc_s = workload(
        "23a transformer mc_ac_stats 100k", lambda: st.mc_ac_stats(
            decks.TRANSFORMER_AC, x_over, node="s", dialect=X, device=dev),
        [gj.K1[f64], K3f], tiers=[(K3f, "register")])
    if xmc.n_valid != XB:
        raise AssertionError(f"transformer-100k: n_valid {xmc.n_valid}")
    same_stats(xmc, st.mc_ac_stats(decks.TRANSFORMER_AC, x_over, node="s",
                                   dialect=X, device="cpu"),
               "transformer-100k against the CPU path")
    KB = 16_384
    k_over = {"k1": rng23.uniform(0.3, 0.95, KB)}
    xbt, xbt_s = workload(
        "23a transformer k1 sweep 16k", lambda: st.simulate_tran_batch(
            decks.TRANSFORMER_TRAN, k_over, dialect=X, device=dev),
        [K3f], tiers=[(K3f, "register")], absent=[K2f],
        per_call=[(K3f, 2)])
    if not xbt.valid.all():
        raise AssertionError(f"transformer k-sweep: {int(xbt.valid.sum())} "
                             "valid")
    cpu = st.simulate_tran_batch(decks.TRANSFORMER_TRAN,
                                 {"k1": k_over["k1"][:64]}, dialect=X,
                                 device="cpu")
    same(xbt.xs[:64], cpu.xs, "transformer k-sweep 64 lanes",
         atol=1e-12 * float(np.abs(cpu.xs).max()))
    say("23 K, T, B", f"(a) transformer: simulate() .ac ({len(xac.freqs)} "
        f"points) = CPU path and analytic at 1e-9, wall {xac_s:.3f} s; "
        f".tran ({len(xtr.times)} steps) = CPU path, wall {xtr_s:.3f} s; "
        f"mc_ac_stats {XB} variants x {len(xmc.grid)}: n_valid "
        f"{xmc.n_valid}, stats = CPU path on the same {XB}, wall "
        f"{xmc_s:.3f} s; simulate_tran_batch k1 U(0.3, 0.95) {KB} x "
        f"{len(xbt.times)} steps: all valid, 64 = CPU path, wall "
        f"{xbt_s:.3f} s | {smi}")
    del xbt, cpu

    # (b) tline-16k: simulate_tran_batch of the matched line over 16,384
    # (rl, Z0, Td) variants (the swept-delay history; K3 factors once, no
    # K2), late v(b) the divider; the .ac delay phase through simulate()
    # (K1)
    tl_over = {"rl": rng23.uniform(25.0, 150.0, KB),
               "t1.z0": rng23.uniform(45.0, 55.0, KB),
               "t1.td": rng23.uniform(4e-9, 6e-9, KB)}
    tlb, tlb_s = workload(
        "23b tline 16k", lambda: st.simulate_tran_batch(
            decks.TLINE_TRAN, tl_over, dialect=X, device=dev),
        [K3f], tiers=[(K3f, "register")], absent=[K2f],
        per_call=[(K3f, 1)])
    if not tlb.valid.all():
        raise AssertionError(f"tline-16k: {int(tlb.valid.sum())} valid")
    same(tlb.node_voltage("b")[:, -1],
         tl_over["rl"] / (50.0 + tl_over["rl"]), "tline-16k late v(b)",
         rtol=1e-6, atol=0.0)
    cpu = st.simulate_tran_batch(decks.TLINE_TRAN,
                                 {k: v[:64] for k, v in tl_over.items()},
                                 dialect=X, device="cpu")
    same(tlb.xs[:64], cpu.xs, "tline-16k 64 lanes",
         atol=1e-12 * float(np.abs(cpu.xs).max()))
    tac, tac_s = workload(
        "23b tline .ac", lambda: st.simulate(decks.TLINE_AC, dialect=X,
                                             device=dev).ac, [gj.K1[f64]])
    want = st.simulate(decks.TLINE_AC, dialect=X, device="cpu").ac
    for series, ref in ((tac.node_voltages, want.node_voltages),
                        (tac.element_currents, want.element_currents)):
        for name, v in ref.items():
            same(series[name], v, f"tline ac {name}")
    h = tac.node_voltages["b"] / tac.node_voltages["a"]
    same(np.abs(h), 1.0, "tline ac |v(b)/v(a)|")
    same(np.angle(h), np.angle(np.exp(-2j * np.pi * tac.freqs * 5e-9)),
         "tline ac phase", rtol=0.0, atol=1e-9)
    say("23 K, T, B", f"(b) tline: simulate_tran_batch {KB} x "
        f"{len(tlb.times)} steps, rl/Z0/Td swept: all valid, late v(b) = "
        f"rl/(rs+rl) at 1e-6, 64 = CPU path, wall {tlb_s:.3f} s; .ac delay "
        f"phase -w Td at 1e-9 = CPU path, wall {tac_s:.3f} s | {smi}")
    del tlb, cpu

    # (c) ua741-step-1001: the uA741 inverting amplifier's rfb stepped
    # over 1,001 values (op_batch, K2 every Newton pass), and the
    # amplifier's .op, acop .ac (K1), .noise (K4) and .tran (K2) through
    # simulate(), each equal to the CPU path at 1e-9 (two series at their
    # own recorded atol, tools/profile_torch_parity.py: the 1 ohm series
    # resistances of the clamp diodes dc and dlp carry -1.4e-11 and
    # -3.9e-11 A between nodes at ~15 and ~40 V, and the card's and the
    # CPU's differ by up to 2.55e-13 and 2.7e-14 A, their voltages'
    # rounding over 1 ohm)
    ua, ua_s = workload(
        "23c ua741 .step", lambda: st.simulate(
            decks.UA741_STEP, dialect=X, device=dev).step, [K2f])
    if len(ua.values) != 1001 or not ua.op.valid.all():
        raise AssertionError(f"ua741 step: {len(ua.values)} lanes, "
                             f"{int(ua.op.valid.sum())} valid")
    same(ua.op.node_voltage("out"), -ua.values / 1e3 * 0.05,
         "ua741 step gain -rfb/rin x 50 mV", rtol=5e-3, atol=0.0)
    ua_ckt = st.parse_netlist(decks.UA741_STEP, dialect=X)
    cpu = st.op_batch(ua_ckt, {"rfb": ua.values[:64]}, device="cpu")
    same(ua.op.x[:64], cpu.x, "ua741 step 64 lanes",
         atol=1e-12 * float(np.abs(cpu.x).max()))
    amp, amp_s = workload(
        "23c ua741 amp", lambda: st.simulate(decks.UA741_AMP, dialect=X,
                                             device=dev),
        [gj.K1[f64], K2f, gj.K4[f64], stamp_real.K11[f64]], reps=1,
        tiers=[(stamp_real.K11[f64], "entry")])
    want = st.simulate(decks.UA741_AMP, dialect=X, device="cpu")
    same_op(amp.op, want.op, "ua741 .op")
    for series, ref in ((amp.ac.node_voltages, want.ac.node_voltages),
                        (amp.ac.element_currents, want.ac.element_currents)):
        scale = max(float(np.abs(v).max()) for v in ref.values())
        for name, v in ref.items():
            same(series[name], v, f"ua741 acop {name}", atol=1e-12 * scale)
    same_noise(amp.noise, want.noise, "ua741 .noise")
    same_tran(amp.tran, want.tran, "ua741 .tran",
              known={"dc.xamp#rs": 5e-13, "dlp.xamp#rs": 5e-14})
    say("23 K, T, B", f"(c) ua741: .step rfb 5k-20k by 15, "
        f"{len(ua.values)} op lanes, all valid, gain -rfb/rin x 50 mV at "
        f"5e-3, Newton passes per lane max {int(ua.op.passes.max())}, 64 "
        f"= CPU path, wall {ua_s:.3f} s; .op, acop .ac "
        f"({len(amp.ac.freqs)} points), .noise ({len(amp.noise.freqs)} "
        f"points, {amp.noise.guard_resolves} re-solved) and .tran "
        f"({len(amp.tran.times)} steps) through simulate() = CPU path, "
        f"wall {amp_s:.3f} s | {smi}")

    # (d) bsrc-tanh-100k: mc_tran_stats of the tanh amplifier over 100k
    # loads (the loop, K2 every pass; no K3: a B deck never factors once)
    # against the CPU path on the same 100k (v(out) = 2 tanh(5 v(in)) does
    # not depend on rl, so the lanes are equal and their std is rounding);
    # method="pallas" at f32 takes the same loop (K8 and K9 never launch)
    BB = 100_000
    b_over = {"rl": 1e3 * rng23.uniform(0.9, 1.1, BB)}
    bmc, bmc_s = workload(
        "23d bsrc-tanh 100k", lambda: st.mc_tran_stats(
            decks.BSRC_TANH, b_over, node="out", dialect=X, device=dev),
        [K2f, stamp_real.K11[f64]], absent=[K3f])
    if bmc.n_valid != BB:
        raise AssertionError(f"bsrc-tanh-100k: n_valid {bmc.n_valid}")
    same_stats(bmc, st.mc_tran_stats(decks.BSRC_TANH, b_over, node="out",
                                     dialect=X, device="cpu"),
               "bsrc-tanh-100k against the CPU path")
    f32_kw = dict(node="out", dialect=X, precision="f32", device=dev)
    b_gj, _ = workload(
        "23d bsrc-tanh gj f32", lambda: st.mc_tran_stats(
            decks.BSRC_TANH, b_over, method="gj", **f32_kw),
        [gj_real.K2[torch.float32]], reps=1)
    fused = [mc_tran_fused.K8[torch.float32], mc_tran_fused.K9[torch.float32]]
    b_pl, bpl_s = workload(
        "23d bsrc-tanh pallas f32", lambda: st.mc_tran_stats(
            decks.BSRC_TANH, b_over, method="pallas", **f32_kw),
        [gj_real.K2[torch.float32]], reps=1, absent=fused)
    same_stats(b_pl, b_gj, "bsrc-tanh pallas f32 against gj f32", rtol=2e-5,
               atol_of_max=2e-5)
    say("23 K, T, B", f"(d) bsrc-tanh: mc_tran_stats {BB} x "
        f"{len(bmc.grid)} steps f64: n_valid {bmc.n_valid}, stats = CPU "
        f"path on the same {BB}, wall {bmc_s:.3f} s; method='pallas' f32: "
        f"K8/K9 never launched, stats = gj f32 at 2e-5, {bpl_s:.3f} s "
        f"| {smi}")
    say("23 K, T, B", f"{time.perf_counter() - t23:.1f} s")
    torch.cuda.empty_cache()

    # ---- 24. the post-analyses (ROADMAP §1 items 8 and 13) ----------------
    # .pz/.sens, .four, .step + .meas and a .control tail with rawfiles and
    # the CLI through simulate() on cuda, each workload counted on its own
    # (workload(): K5, K7, K8 and K9 must not launch on any of these decks,
    # which run method="gj"), each against the CPU path and its own physics
    import contextlib
    import io
    import os
    import tempfile

    from spicey_tpu_torch.__main__ import main as cli_main

    t24 = time.perf_counter()
    fused = [*mc_ac_fused.K5.values(), mc_ac_fused.K7[f64],
             *mc_tran_fused.K8.values(), *mc_tran_fused.K9.values()]
    K1f, K4f = gj.K1[f64], gj.K4[f64]
    cpu_kw = dict(dialect=X, device="cpu")

    # (a) ua741-pz-sens: poles/zeros and sensitivities at the amplifier's
    # shared operating point (K2 on its panel tier, N = 36), against the
    # CPU path; d v(out)/d rfb against -v(in)/rin and a central difference
    # of two card operating points; the dominant pole against the -3 dB
    # frequency of the same deck's acop .ac
    pzs, pzs_s = workload(
        "24a ua741 pz+sens", lambda: st.simulate(
            decks.UA741_PZ_SENS, dialect=X, device=dev),
        [K2f, K1f, K4f], tiers=[(K2f, "panel")], reps=1, absent=fused)
    want = st.simulate(decks.UA741_PZ_SENS, **cpu_kw)
    pz_gap = 0.0
    for f in ("poles", "zeros"):
        g, w = pair_nearest(getattr(pzs.pz, f), getattr(want.pz, f)), \
            getattr(want.pz, f)
        same(g, w, f"ua741 {f}", atol=1e-12 * float(np.abs(w).max()))
        pz_gap = max(pz_gap, float((np.abs(g - w) / np.abs(w)).max()))
    # every sensitivity on one scale for every unit: 1e-12 of the largest
    # |value * p / 100| (volts per 1% change) over the entry's |p| / 100,
    # a parameter of value 0 taken as 1 of its unit
    scale = 1e-12 * max(abs(v) for v in want.sens.normalized.values())
    if list(pzs.sens.values) != list(want.sens.values):
        raise AssertionError("ua741 .sens: parameters differ")
    sens_gap = 0.0
    for name, v in want.sens.values.items():
        atol = scale * 100.0 / (abs(want.sens.params[name]) or 1.0)
        same(pzs.sens.values[name], v, f"ua741 sens {name}", atol=atol)
        sens_gap = max(sens_gap, abs(pzs.sens.values[name] - v)
                       / (1e-9 * abs(v) + atol))
    s_rfb = pzs.sens.values["rfb"]
    same(s_rfb, -0.05 / 1e3, "sens rfb = -v(in)/rin", rtol=0.02, atol=0.0)

    def vout_at(rfb):
        net = decks.UA741_PZ_SENS.replace("rfb minus out 10k",
                                          f"rfb minus out {rfb!r}")
        return st.simulate_op(st.parse_netlist(net, dialect=X),
                              device=dev).node_voltages["out"]

    fd = (vout_at(1e4 * 1.001) - vout_at(1e4 * 0.999)) / (2 * 10.0)
    same(s_rfb, fd, "sens rfb against a central difference", rtol=1e-3,
         atol=0.0)
    gain = np.abs(pzs.ac.node_voltages["out"] / pzs.ac.node_voltages["in"])
    k = int(np.argmax(gain < gain[0] / np.sqrt(2)))
    f3 = float(np.exp(np.interp(
        np.log(gain[0] / np.sqrt(2)), np.log(gain[[k, k - 1]]),
        np.log(pzs.ac.freqs[[k, k - 1]]))))
    p0 = pzs.pz.poles[np.argmin(np.abs(pzs.pz.poles))]
    same(abs(p0), 2 * np.pi * f3, "dominant pole against the -3 dB "
         "frequency", rtol=0.10, atol=0.0)
    say("24 post-analyses", f"(a) ua741 .pz/.sens (N = 36): "
        f"{len(pzs.pz.poles)} poles, {len(pzs.pz.zeros)} zeros = CPU path "
        f"as sets (largest relative gap {pz_gap:.2e}), "
        f"{len(pzs.sens.values)} sensitivities = CPU path at 1e-9, each "
        f"with its atol of 1e-12 of the volts per 1% (largest gap "
        f"{sens_gap:.2e} of the tolerance); "
        f"d v(out)/d rfb {s_rfb:.6e} V/ohm (-v(in)/rin -5e-5 at 2%, "
        f"central difference {fd:.6e} at 1e-3); dominant pole "
        f"{abs(p0):.6e} rad/s, 2 pi f(-3 dB) {2 * np.pi * f3:.6e} at 10%; "
        f"wall {pzs_s:.3f} s | {smi}")

    # (b) ua741-four: .four 10k v(out) over two periods: the fundamental
    # 20 mV x a closed-loop gain of ~10, THD under 1%, = the CPU path
    fo, fo_s = workload(
        "24b ua741 four", lambda: st.simulate(
            decks.UA741_FOUR, dialect=X, device=dev),
        [K2f, K1f, K4f], tiers=[(K2f, "panel")], reps=1, absent=fused)
    want = st.simulate(decks.UA741_FOUR, **cpu_kw).four
    g, w = fo.four.probes["out"], want.probes["out"]
    same(g.magnitude, w.magnitude, "ua741 four magnitudes",
         atol=1e-12 * float(w.magnitude.max()))
    same(g.magnitude * np.exp(1j * np.radians(g.phase_deg)),
         w.magnitude * np.exp(1j * np.radians(w.phase_deg)),
         "ua741 four harmonics", atol=1e-12 * float(w.magnitude.max()))
    same(g.thd_percent, w.thd_percent, "ua741 THD",
         atol=100e-12 * float(w.magnitude.max()) / float(w.magnitude[1]))
    same(g.magnitude[1], 0.2, "ua741 fundamental", rtol=0.03, atol=0.0)
    if not g.thd_percent < 1.0:
        raise AssertionError(f"ua741 THD {g.thd_percent} %")
    say("24 post-analyses", f"(b) ua741 .four 10k over "
        f"{len(fo.tran.times)} steps: fundamental {g.magnitude[1]:.6e} V "
        f"(0.2 at 3%), THD {g.thd_percent:.3e} % (< 1), = CPU path; wall "
        f"{fo_s:.3f} s | {smi}")

    # (c) step-meas-1001: STEP_DECK's 1,001 lanes reduced by three .meas
    # tran lines (K3's register form factors each lane's matrix once; K1
    # the stepped .ac); first, middle and last lane against simulate() of
    # the deck at that r1 alone, 64 lanes against the CPU path
    sm, sm_s = workload(
        "24c step-meas 1001", lambda: st.simulate(
            decks.STEP_MEAS, dialect=X, device=dev).step,
        [K3f, K1f], tiers=[(K3f, "register")], absent=fused)
    names = ("vmax", "trise", "vavg")
    got = {n: (a.shape, int(np.isfinite(a).sum())) for n, a in sm.meas.items()}
    if got != {n: ((1001,), 1001) for n in names}:
        raise AssertionError(f"step-meas: (shape, finite) {got}")
    base = decks.STEP_MEAS.replace(".step param r1 100 1100 1\n", "")
    for lane in (0, 500, 1000):
        r1 = float(sm.values[lane])
        one = st.simulate(base.replace("r1 in a 100", f"r1 in a {r1!r}"),
                          dialect=X, device=dev).meas
        for n in names:
            same(sm.meas[n][lane], one[n], f"step-meas lane {lane} {n}",
                 atol=0.0)
    ckt = st.parse_netlist(decks.STEP_MEAS, dialect=X)
    cpu = st.meas_batch(ckt, st.simulate_tran_batch(
        ckt, {"r1": sm.values[:64]}, device="cpu"))
    for n in names:
        same(sm.meas[n][:64], cpu[n], f"step-meas 64 lanes {n}",
             atol=1e-12 * float(np.abs(cpu[n]).max()))
    say("24 post-analyses", f"(c) step-meas: {len(sm.values)} lanes x "
        f"{len(sm.tran.times)} steps, .meas vmax {sm.meas['vmax'].min():.4f}"
        f"-{sm.meas['vmax'].max():.4f} V, trise "
        f"{sm.meas['trise'].min():.4e}-{sm.meas['trise'].max():.4e} s, vavg "
        f"{sm.meas['vavg'].min():.4f}-{sm.meas['vavg'].max():.4f} V, all "
        f"finite; lanes 0/500/1000 = simulate() alone, 64 = CPU path at "
        f"1e-9; wall {sm_s:.3f} s | {smi}")

    # (d) control-raw-cli: the uA741 with every post-analysis and a
    # .control tail (print, let, wrdata, binary and ASCII rawfiles): the
    # text against the CPU path's, the binary rawfile read back bit for
    # bit; then python -m spicey_tpu_torch on the card as a subprocess
    # with jax blocked, its standard output the in-process CLI's, which
    # runs inside profiled()
    from spicey_tpu_torch.formatting.rawfile import read_rawfile
    from spicey_tpu_torch.utils import profiling

    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_24_")
    tmp = tmp_dir.name
    ctl, ctl_s = workload(
        "24d control-raw-cli", lambda: st.simulate(
            decks.UA741_CONTROL, dialect=X, device=dev, base_dir=tmp),
        [K2f, K1f, K4f], tiers=[(K2f, "panel")], reps=1, absent=fused)
    raw_bytes = Path(tmp, "ua741.raw").read_bytes()
    # the CLI as a subprocess on the card, jax blocked, started now and
    # read after the host-side comparisons (it is a new process: ~8 s to
    # reach the card)
    cli_dir = Path(tmp, "cli")
    blocker = cli_dir / "block" / "jax"
    blocker.mkdir(parents=True)
    (blocker / "__init__.py").write_text(
        "raise ImportError('jax is blocked')\n")
    deck_path = cli_dir / "ua741.cir"
    deck_path.write_text(decks.UA741_CONTROL)
    argv = [str(deck_path), "--raw", str(cli_dir / "cli.raw"), "--binary"]
    repo = str(Path(__file__).resolve().parent)
    t_cli = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "spicey_tpu_torch", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=cli_dir, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(blocker.parent), repo])))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_24_cpu_") as d:
        want = st.simulate(decks.UA741_CONTROL, base_dir=d, **cpu_kw)
    n_diff, gap = text_gap(ctl.control_output, want.control_output)
    if gap > 1e-6:
        raise AssertionError(f"control text: {n_diff} numbers differ, "
                             f"up to {gap:.3e} relative")
    plots = dict(read_rawfile(raw_bytes))
    expect = {"Operating Point": (None, ctl.op), "AC Analysis":
              (ctl.ac.freqs, ctl.ac), "Transient Analysis":
              (ctl.tran.times, ctl.tran)}
    if list(plots) != list(expect):
        raise AssertionError(f"rawfile plots {list(plots)}")
    n_vec = 0
    for plot, (axis, r) in expect.items():
        series = plots[plot]
        if axis is not None:
            ax = series["frequency" if plot.startswith("AC") else "time"]
            if not np.array_equal(np.real(ax), axis):
                raise AssertionError(f"rawfile {plot} axis")
            n_vec += 1
        for node, v in r.node_voltages.items():
            if not np.array_equal(series[f"v({node})"], np.atleast_1d(v)):
                raise AssertionError(f"rawfile {plot} v({node})")
            n_vec += 1
        for el, i in r.element_currents.items():
            key = f"{el}#branch"
            if key in series:
                if not np.array_equal(series[key], np.atleast_1d(i)):
                    raise AssertionError(f"rawfile {plot} {key}")
                n_vec += 1
    # the in-process CLI on a deck file of its own directory (the .control
    # tail writes beside it), inside profiled()
    own = Path(tmp, "own")
    own.mkdir()
    (own / "ua741.cir").write_text(decks.UA741_CONTROL)
    buf = io.StringIO()
    with profiling.profiled(), contextlib.redirect_stdout(buf):
        cli_main([str(own / "ua741.cir"), "--raw", str(own / "cli.raw"),
                  "--binary"])
    spans = {line.split(", ")[0] for line in profiling.report().splitlines()}
    if not {"pz", "sens", "four", "meas", "control"} <= spans:
        raise AssertionError(f"profiled() spans {sorted(spans)}")
    cli_out, cli_err = proc.communicate(timeout=300)
    cli_s = time.perf_counter() - t_cli
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}: "
                             f"{cli_err[-2000:]}")
    if cli_out != buf.getvalue():
        raise AssertionError("CLI standard output differs from the "
                             "in-process CLI's")
    say("24 post-analyses", f"(d) ua741 .control: text = CPU path "
        f"({n_diff} numbers differ in their last printed digit, up to "
        f"{gap:.2e} relative), binary rawfile: {len(plots)} plots, {n_vec} "
        f"vectors read back bit for bit; wall {ctl_s:.3f} s; python -m "
        f"spicey_tpu_torch --raw --binary with jax blocked: exit 0, stdout "
        f"= in-process ({len(cli_out.splitlines())} lines), "
        f"{cli_s:.1f} s; profiled() spans pz, sens, four, meas, control "
        f"| {smi}")
    tmp_dir.cleanup()
    zero_counts()
    say("24 post-analyses", f"{time.perf_counter() - t24:.1f} s")
    torch.cuda.empty_cache()

    # ---- 25. the Schur tier and the time-parallel transient (items 6, 3) --
    # each workload through the public entry points with its own counters
    # (zeroed before its calls, read after); none may launch K4, K5, K7,
    # K8 or K9. Walls: host clock around a warm call ending in
    # synchronize(). The multi entry is held to its plain version on the
    # very block systems the AC and transient Schur solves hand it
    # (captured in (a) and (b)), f64 and f32, and timed there.
    from spicey_tpu_torch.decks import (SCHUR_CLAMP, SCHUR_TRAN_KW,
                                        schur_ladder_netlist, tp_rlc_netlist)
    from spicey_tpu_torch.ops import schur as schur_mod
    from tools import profile_torch_schur as pschur

    t25 = time.perf_counter()
    K1m, K2m = gj.K1_MULTI[f64], gj_real.K2_MULTI[f64]
    not25 = (list(gj.K4.values()) + list(mc_ac_fused.K5.values())
             + list(mc_ac_fused.K7.values())
             + [mc_tran_fused.K8[torch.float32],
                mc_tran_fused.K9[torch.float32]])

    base25 = {}

    def start25():
        """Zero the counters before a workload (K4 f32 and K7 f32 are no
        main-path kernels and keep their counts: remember them)."""
        zero_counts()
        base25.update({k.name: k.launches for k in not25})

    def counted25(label, expect, tiers=()):
        bad = [k.name for k in not25 if k.launches != base25[k.name]]
        if bad:
            raise AssertionError(f"25 {label}: launched {bad}")
        counted(f"25 {label}", expect, tiers)

    def fields_close(got, want, what):
        """Every series at rtol 1e-9, atol 1e-12 of the field's largest
        value."""
        scale = max(float(np.abs(v).max()) for v in want.values())
        for name, v in want.items():
            same(got[name], v, f"{what} {name}", atol=1e-12 * scale)

    captured = {}

    def capturing(key, fn):
        """``fn`` (a schur-module solve) that keeps its first inputs."""
        def run(*a, **k):
            captured.setdefault(key, [t.clone() for t in a])
            return fn(*a, **k)
        return run

    # (a) schur-ladder-ac: the 64- and 256-stage boards at 241 frequencies
    # through the forced tier, the default method's dispatch and the dense
    # route (K1's panel tier at N = 386 / 1538), each against the CPU
    # path's Schur solve (ladder-256: at its 7 frequencies of decade
    # points, the 40th ones of the card's grid)
    X = "extended"
    schur_walls = {}
    for stages in (64, 256):
        net = schur_ladder_netlist(stages, analysis=".ac dec 40 1 1e6")
        ckt = st.parse_netlist(net, dialect=X)
        tens = st.build_tensors(ckt)
        plan = schur_mod.plan_partition(ckt, tens)
        cpu_net = net if stages == 64 else net.replace("dec 40", "dec 1")
        want = st.simulate_ac(st.parse_netlist(cpu_net, dialect=X),
                              method="schur", device="cpu")
        step = 1 if stages == 64 else 40
        for method in ("schur", "gj", "pallas"):
            real_spm = schur_mod.solve_planes_multi
            if stages == 64 and method == "schur":
                schur_mod.solve_planes_multi = capturing("k1", real_spm)
            start25()
            try:
                st.simulate_ac(st.parse_netlist(net, dialect=X),
                               method=method, device=dev)  # warm
                got, schur_walls[(stages, method)] = timed(
                    lambda: st.simulate_ac(st.parse_netlist(net, dialect=X),
                                           method=method, device=dev))
            finally:
                schur_mod.solve_planes_multi = real_spm
            n_freq = len(got.freqs)
            np.testing.assert_allclose(got.freqs[::step], want.freqs,
                                       rtol=1e-15)
            fields_close({k: v[::step] for k, v in
                          got.node_voltages.items()}, want.node_voltages,
                         f"schur ladder-{stages} {method}")
            dense = method == "pallas"
            counted25(f"schur-ladder-{stages} ac {method}",
                      [gj.K1[f64]] + ([] if dense else [K1m]),
                      tiers=[(gj.K1[f64], "panel" if dense else "multi")])
            del got
            torch.cuda.empty_cache()
        say("25 schur", f"(a) ladder-{stages} .ac ({n_freq} points; "
            f"N = {tens.nvar}, {plan.n_blocks} blocks of "
            f"{plan.n_max}, N_I = {plan.n_interface}): schur "
            f"{schur_walls[(stages, 'schur')]:.3f} s, gj (auto) "
            f"{schur_walls[(stages, 'gj')]:.3f} s, dense (K1 panel, "
            f"N = {tens.nvar}) {schur_walls[(stages, 'pallas')]:.3f} s; each "
            f"= the CPU Schur path at 1e-9 | {smi}")

    # (b) schur-clamp-tran-op: the 64-stage board with a clamp diode per
    # stage through .op and .tran (50 steps): Newton, every pass a real
    # Schur solve on K2's multi entry, against the CPU path's
    net = schur_ladder_netlist(64, stage_extra=SCHUR_CLAMP, **SCHUR_TRAN_KW)
    real_sm = schur_mod.solve_multi
    schur_mod.solve_multi = capturing("k2", real_sm)
    start25()
    try:
        op_k, op_s = timed(lambda: st.simulate_op(
            st.parse_netlist(net, dialect=X), method="schur", device=dev))
        tr_k, tr_s = timed(lambda: st.simulate_tran(
            st.parse_netlist(net, dialect=X), method="schur", device=dev))
    finally:
        schur_mod.solve_multi = real_sm
    counted25("schur-clamp op+tran", [gj_real.K2[f64], K2m],
              tiers=[(gj_real.K2[f64], "multi")])
    same_op(op_k, st.simulate_op(st.parse_netlist(net, dialect=X),
                                 method="schur", device="cpu"), "clamp op")
    tr_c = st.simulate_tran(st.parse_netlist(net, dialect=X),
                            method="schur", device="cpu")
    np.testing.assert_array_equal(tr_k.times, tr_c.times)
    fields_close(tr_k.node_voltages, tr_c.node_voltages, "clamp tran v")
    fields_close(tr_k.element_currents, tr_c.element_currents,
                 "clamp tran i")
    say("25 schur", f"(b) clamp board (N = "
        f"{st.build_tensors(st.parse_netlist(net, dialect=X)).nvar}, "
        f"{len(tr_k.times)} points): .op {op_s:.3f} s, .tran {tr_s:.3f} s, "
        f"= the CPU Schur path at 1e-9 | {smi}")

    # (c) schur-mc-ac: mc_ac_stats over the 64-stage board, 256 variants
    # (r1 and c1 of every 4th stage at U(0.9, 1.1)), the default method
    # (Schur) against the dense route on the card; 16 variants against the
    # CPU path
    net = schur_ladder_netlist(64)
    rng25 = np.random.default_rng(SEED + 25)
    mc_over = {f"{e}.x{s}": base * (0.9 + 0.2 * rng25.random(256))
               for s in range(1, 65, 4) for e, base in (("r1", 1e3),
                                                         ("c1", 1e-9))}
    start25()
    mc_s, mc_s_s = timed(lambda: st.mc_ac_stats(
        net, mc_over, node="o64", dialect=X, chunk=64, device=dev))
    counted25("schur-mc-ac", [gj.K1[f64], K1m],
              tiers=[(gj.K1[f64], "multi")])
    mc_d, mc_d_s = timed(lambda: st.mc_ac_stats(
        net, mc_over, node="o64", dialect=X, chunk=64, method="pallas",
        device=dev))
    zero_counts()
    sub = {k: v[:16] for k, v in mc_over.items()}
    k16 = st.mc_ac_stats(net, sub, node="o64", dialect=X, device=dev)
    c16 = st.mc_ac_stats(net, sub, node="o64", dialect=X, device="cpu")
    zero_counts()
    for f in ("mean", "std", "min", "max"):
        same(getattr(mc_s, f), getattr(mc_d, f), f"schur mc {f}",
             atol=1e-12 * float(np.abs(mc_d.max).max()))
        same(getattr(k16, f), getattr(c16, f), f"schur mc 16 {f}",
             atol=1e-12 * float(np.abs(c16.max).max()))
    if not mc_s.n_valid == mc_d.n_valid == 256:
        raise AssertionError(f"schur mc: n_valid {mc_s.n_valid}")
    say("25 schur", f"(c) mc_ac_stats ladder-64, 256 variants x "
        f"{len(mc_s.grid)} points: schur {mc_s_s:.3f} s, dense "
        f"{mc_d_s:.3f} s, equal at 1e-9; 16 variants = the CPU path | {smi}")

    # the multi entry on the captured block systems: K1 (complex, the
    # ladder-64 AC's 64 x 241 blocks) and K2 (real, a Newton pass of the
    # clamp board), f64 at TOL and f32 as accurate as the plain f32
    # version against an f64 solve, valid identical; then timed beside the
    # plain version, torch.linalg.solve and the bound
    for key, kern, plain_fn in (
            ("k1", gj.gj_solve_planes_multi_cuda,
             linsolve.gj_solve_planes_multi),
            ("k2", gj_real.gj_solve_multi_cuda, linsolve.gj_solve_multi)):
        ins = [t.contiguous() for t in captured[key]]
        complex_ = key == "k1"
        nb, n, r = ins[0].shape[0], ins[0].shape[1], ins[-1].shape[-1]
        name = (K1m if complex_ else K2m).name
        want64 = plain_fn(*ins)
        for dtype in (f64, torch.float32):
            cast = [t.to(dtype) for t in ins]
            got = kern(*cast)
            pw = plain_fn(*cast)
            if not torch.equal(got[-1], pw[-1]):
                raise AssertionError(f"{name} {TAG[dtype]}: valid differs")
            pv = pw[-1]
            if dtype == f64:
                e = max(check_close(g[pv], w[pv], TOL[dtype], name)
                        for g, w in zip(got[:-1], pw[:-1]))
                err[name] = max(err[name], e)
            else:
                e_k = max(float((g.double() - w)[pv].abs().max())
                          for g, w in zip(got[:-1], want64[:-1]))
                e_p = max(float((g.double() - w)[pv].abs().max())
                          for g, w in zip(pw[:-1], want64[:-1]))
                scale = max(float(w[pv].abs().max()) for w in want64[:-1])
                if e_k > 2 * e_p + TOL[dtype] * scale:
                    raise AssertionError(f"{name} f32: error vs f64 "
                                         f"{e_k:.3e}, plain's {e_p:.3e}")
                e = e_k
            say("25 compare", f"{name.replace('f64', TAG[dtype])} at "
                f"({nb}, n={n}, R={r}): valid identical "
                f"({int(pv.sum())}/{nb}), max_abs_err {e:.3e}")
            del got, pw, cast
        if complex_:
            Ac = torch.complex(ins[0], ins[1])
            Bc = torch.complex(ins[2], ins[3])
            lib = cuda_ms(lambda: torch.linalg.solve(Ac, Bc), 5)
            del Ac, Bc
        else:
            lib = cuda_ms(lambda: torch.linalg.solve(ins[0], ins[1]), 5)
        t = (cuda_ms(lambda: kern(*ins), 20), cuda_ms(lambda: plain_fn(*ins),
                                                      3),
             lib, *pschur.multi_bound(nb, n, r, complex_, f64))
        zero_counts()
        shape[name] = (f"{'ladder-64 ac' if complex_ else 'clamp-64 newton'}"
                       f" ({nb}, n={n}, R={r})")
        ms[name] = t
        say("25 times", f"{name} at {shape[name]}: kernel {t[0]:.4f} ms, "
            f"plain {t[1]:.3f} ms, library {t[2]:.4f} ms (linalg.solve, "
            f"{'complex' if complex_ else 'real'} f64), bound {t[3]:.4f} ms "
            f"({t[4]}), {100 * t[3] / t[0]:.2f}% of it (CUDA events) | {smi}")
    for row in pschur.time_multi(dev, 5, SEED, emit=lambda line: say(
            "25 times", line)):
        pass
    zero_counts()

    # (d) tp-rlc-100k: mc_tran_stats of the linear RLC of tests/test_mc.py
    # at 100,000 steps and 16 variants, BE and trap, through the
    # time-parallel core (K3 once); the sequential loop, ~0.5 ms a step on
    # the card (PR 14: 49.5 / 56.2 s at 100k), runs the first TP_LOOP_STEPS
    # steps on the same dt, and the timed 100k run's first TP_LOOP_STEPS + 1
    # points are held against it at the JAX tests' tolerances
    net = tp_rlc_netlist("20m")
    net_loop = tp_rlc_netlist(f"{0.2 * TP_LOOP_STEPS:g}u")
    tp_over = {"R1": 100.0 * (1 + 0.2 * rng25.random(16)),
               "C1": 1e-6 * (1 + 0.2 * rng25.random(16))}
    tp_walls = {}
    for integ in ("be", "trap"):  # one warm call of the tp route each
        st.mc_tran_stats(tp_rlc_netlist("20u"), tp_over, node="b",
                         dialect=X, integration=integ, device=dev)
    head = slice(0, TP_LOOP_STEPS + 1)
    for integ in ("be", "trap"):
        start25()
        tp, tp_walls[(integ, "tp")] = timed(lambda: st.mc_tran_stats(
            net, tp_over, node="b", dialect=X, integration=integ,
            device=dev))
        counted25(f"tp-rlc-100k {integ}", [gj_real.K3[f64]])
        if not (tp.n_valid == 16 and len(tp.grid) == 100_001):
            raise AssertionError(f"tp {integ}: {tp.n_valid} valid, "
                                 f"{len(tp.grid)} points")
        sq, tp_walls[(integ, "loop")] = timed(lambda: st.mc_tran_stats(
            net_loop, tp_over, node="b", dialect=X, integration=integ,
            time_parallel="never", device=dev))
        zero_counts()
        if not (sq.n_valid == 16 and len(sq.grid) == TP_LOOP_STEPS + 1):
            raise AssertionError(f"loop {integ}: {sq.n_valid} valid, "
                                 f"{len(sq.grid)} points")
        same(tp.grid[head], sq.grid, f"tp {integ} grid")
        for f in ("mean", "max", "min"):
            same(getattr(tp, f)[head], getattr(sq, f), f"tp {integ} {f}")
        same(tp.std[head], sq.std, f"tp {integ} std", rtol=1e-7)
        say("25 tp", f"(d) rlc {integ} 16 x 100,001 steps: time-parallel "
            f"{tp_walls[(integ, 'tp')]:.3f} s; its first "
            f"{TP_LOOP_STEPS + 1:,} points = the loop's over them "
            f"({tp_walls[(integ, 'loop')]:.3f} s), mean/max/min at 1e-9, "
            f"std at 1e-7 | {smi}")
        del tp, sq
    # K3 at the time-parallel path's shape: the BE matrices (A^-1's input)
    # of (d)'s 16 variants, captured from the path itself
    real_inv = linsolve.inverse
    linsolve.inverse = capturing("k3", real_inv)
    try:
        st.mc_tran_stats(net.replace("20m", "1u"), tp_over, node="b",
                         dialect=X, device=dev)
    finally:
        linsolve.inverse = real_inv
    Atp = captured["k3"][0].contiguous()
    pinv, pv = linsolve.gj_inverse(Atp)
    inv, v = gj_real.gj_inverse_cuda(Atp)
    if not torch.equal(v, pv):
        raise AssertionError("K3 at the tp shape: valid differs")
    e = check_close(inv, pinv, TOL[f64], "K3 tp shape")
    t = (cuda_ms(lambda: gj_real.gj_inverse_cuda(Atp), 50),
         cuda_ms(lambda: linsolve.gj_inverse(Atp), 5),
         cuda_ms(lambda: torch.linalg.inv(Atp), 20),
         *bound(Atp.shape[0] * inverse_flops(Atp.shape[1]),
                8 * Atp.shape[0] * 2 * Atp.shape[1] ** 2 + Atp.shape[0],
                f64))
    zero_counts()
    say("25 times", f"{gj_real.K3[f64].name} "
        f"({gj_real.tier_for(Atp.shape[1], f64, inverse=True)}) at the tp "
        f"shape ({Atp.shape[0]}, {Atp.shape[1]}): = plain (max_abs_err "
        f"{e:.2e}), kernel {t[0]:.4f} ms, plain {t[1]:.3f} ms, library "
        f"{t[2]:.4f} ms (linalg.inv, f64), bound {t[3]:.5f} ms ({t[4]}), "
        f"{100 * t[3] / t[0]:.2f}% of it (CUDA events) | {smi}")

    # (e) tp-batch: simulate_tran_batch's full trajectories, 256 variants
    # x 2,001 steps, the time-parallel core against the loop at 1e-9 / 1e-12
    net = tp_rlc_netlist("400u")
    b_over = {"R1": 100.0 * (1 + 0.2 * rng25.random(256))}
    start25()
    tb, tb_s = timed(lambda: st.simulate_tran_batch(net, b_over, dialect=X,
                                                    device=dev))
    counted25("tp-batch", [gj_real.K3[f64]])
    sb, sb_s = timed(lambda: st.simulate_tran_batch(
        net, b_over, dialect=X, time_parallel="never", device=dev))
    zero_counts()
    same(tb.xs, sb.xs, "tp batch xs")
    if not (tb.valid.all() and sb.valid.all()):
        raise AssertionError("tp batch: invalid lanes")
    say("25 tp", f"(e) simulate_tran_batch {tb.xs.shape}: time-parallel "
        f"{tb_s:.3f} s, loop {sb_s:.3f} s, equal at 1e-9 | {smi}")
    del tb, sb

    # (f) the crossover: tp against the loop at S in {201, 10k, 100k} x B in
    # {16, 1k, 16k} (tools/profile_torch_schur.py:crossover_sweep; (d)'s
    # BE tp wall is its (100k, 16) cell); the loop runs to 10k steps (at
    # 100k it is ten times its 10k wall: launch-bound, PR 14)
    start25()
    rows = pschur.crossover_sweep(
        dev, seed=SEED, emit=lambda line: say("25 crossover", line),
        known={(100_000, 16): {"tp_s": tp_walls[("be", "tp")]}},
        loop_max_steps=10_000)
    counted25("crossover", [gj_real.K3[f64]])
    wins = [(r["steps"], r["batch"]) for r in rows
            if None not in (r["tp_s"], r["loop_s"])
            and r["tp_s"] < r["loop_s"]]
    picks = [(r["steps"], r["batch"]) for r in rows if r["guard_picks_tp"]]
    say("25 crossover", f"tp faster at (S, B) {wins}; the JAX guard picks "
        f"tp at {picks}")
    say("25 schur+tp", f"{time.perf_counter() - t25:.1f} s")
    torch.cuda.empty_cache()

    # ---- 26. sensitivity, fitting, the adaptive transient (item 9) -------
    # tools/profile_torch_sens.py:phase26's workloads through the public
    # entry points, each on its own counters (zeroed before its call, read
    # after, before any comparison run): K1/K2/K3 must launch for the
    # roles each workload names (forward, tangent, adjoint: the derivative
    # rules' dispatches, ops/linsolve.py:RULE_CALLS), every launch of them
    # must be one of the rules' dispatches (the adaptive transient: plain
    # K2 launches, no rule), and no K4-K10 may launch
    from tools import profile_torch_sens as psens

    t26 = time.perf_counter()
    not26 = (list(gj.K4.values()) + list(mc_ac_fused.K5.values())
             + list(mc_ac_fused.K7.values())
             + list(mc_tran_fused.K8.values())
             + list(mc_tran_fused.K9.values())
             + list(mxu.K10a.values()) + list(mxu.K10b.values()))
    tag26 = {"K1": gj.K1[f64], "K2": gj_real.K2[f64], "K3": gj_real.K3[f64]}
    roles26 = ("forward", "tangent", "adjoint")

    def run26(label, fn, rules):
        zero_counts()
        base = {k.name: k.launches for k in not26}
        calls0 = dict(linsolve.RULE_CALLS)
        out, wall = timed(fn)
        calls = {key: n - calls0[key] for key, n in linsolve.RULE_CALLS.items()}
        bad = [k.name for k in not26 if k.launches != base[k.name]]
        if bad:
            raise AssertionError(f"26 {label}: launched {bad}")
        differentiated = any(role != "launch" for _, role in rules)
        for tag, role in rules:
            if role != "launch" and calls[(tag, role)] == 0:
                raise AssertionError(f"26 {label}: no {tag} {role} dispatch")
        for tag, k in tag26.items():
            # K1 / K2: one launch per rule dispatch; K3's tangent and
            # adjoint are products of its inverse, its launches forwards
            by_rule = calls[(tag, "forward")] + (
                0 if tag == "K3" else calls[(tag, "tangent")]
                + calls[(tag, "adjoint")])
            if differentiated and k.launches != by_rule:
                raise AssertionError(f"26 {label}: {k.name} {k.launches} "
                                     f"launches, {by_rule} by the rules")
            if not differentiated and any(calls[(tag, r)] for r in roles26):
                raise AssertionError(f"26 {label}: a rule ran")
        say("26 " + label, "rule dispatches " + json.dumps(
            {f"{t} {r}": n for (t, r), n in calls.items() if n}))
        counted(f"26 {label}", [tag26[t] for t, _ in rules])
        return out, wall

    walls26 = psens.phase26(dev, run26, lambda line: say("26 sens/fit/adapt",
                                                         line), smi)
    zero_counts()
    say("26 sens/fit/adapt", f"{time.perf_counter() - t26:.1f} s "
        f"(workload walls {json.dumps({k: round(v, 3) for k, v in walls26.items()})})")
    torch.cuda.empty_cache()

    # ---- 27. the device mesh (item 9) --------------------------------------
    # tools/profile_torch_mesh.py:phase27's workloads, each call on its own
    # counters (zeroed before it, read after, before any comparison)
    from tools import profile_torch_mesh as pmesh

    t27 = time.perf_counter()

    def run27(label, fn):
        zero_counts()
        out, wall = timed(fn)
        got = {name: k.launches for name, k in kernels.items() if k.launches}
        counted(f"27 {label}", [])
        return out, wall, got

    pmesh.phase27(dev, run27, lambda line: say("27 mesh", line), smi,
                  cli_s=cli_s)
    zero_counts()
    say("27 mesh", f"{time.perf_counter() - t27:.1f} s")
    torch.cuda.empty_cache()

    # ---- 28. K11 against the index_add_ assembly -------------------------
    # tools/profile_torch_k11.py:phase28: every form bit for bit against
    # the chain it replaced on the same values, then timed beside it; off
    # the main path's counts (zeroed after)
    from tools import profile_torch_k11 as pk11

    t28 = time.perf_counter()
    for row in pk11.phase28(dev, lambda line: say("28 k11", line), smi):
        if row["shape"] != "boost-loop-1M":
            continue
        dtype = getattr(torch, row["dtype"])
        name = stamp_real.K11[dtype].name
        shape[name] = (f"{row['shape']} ({row['lanes']}, N={row['n']}, "
                       f"{row['form']})")
        ms[name] = (row["k11_ms"], row["chain_ms"], None, row["bound_ms"],
                    "bytes")
    zero_counts()
    say("28 k11", f"{time.perf_counter() - t28:.1f} s")
    torch.cuda.empty_cache()

    # ---- 9. launches and times --------------------------------------------
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    say("9 launches", json.dumps(launches))
    for dtype, planes in ladder_planes.items():
        nb, n = planes[0].shape[0], planes[0].shape[1]
        el = planes[0].element_size()
        Ac = torch.complex(planes[0], planes[1])
        bc = torch.complex(planes[2], planes[3])
        name = gj.K1[dtype].name
        shape[name] = f"ladder ({nb}, {n})"
        ms[name] = (cuda_ms(lambda: gj.gj_solve_planes_cuda(*planes), 5),
                    cuda_ms(lambda: linsolve.gj_solve_planes(*planes), 2),
                    cuda_ms(lambda: torch.linalg.solve(Ac, bc), 3),
                    *bound(nb * solve_flops(n, True),
                           el * nb * (2 * n * n + 4 * n) + nb, dtype))
        del Ac, bc
    for dtype, inputs in big_inputs.items():
        freqs, values, packed, _node = inputs
        F, nb, n = freqs.shape[0], values.shape[1], packed.n
        el = values.element_size()
        name = mc_ac_fused.K5[dtype].name
        shape[name] = f"RC ({nb}, {F})"
        plain = cuda_ms(lambda: plain_chunked(*inputs), 1)
        bnd = bound(F * nb * (solve_flops(n, True)
                              + 2 * packed.terms.shape[0]),
                    el * (values.numel() + F) + F * nb * (el + 1), dtype)
        # every form that takes N = 3; the JSON line keeps the chosen one
        chosen = mc_ac_fused.k5_form_for(n, dtype)[0]
        for form in k5_forms(n):
            t_k5 = (cuda_ms(lambda: mc_ac_fused.mc_ac_fused_cuda(
                *inputs, form=form), 5), plain, None, *bnd)
            say("9 times", f"{name} {form}"
                f"{' (chosen)' if form == chosen else ''} at yield-1M "
                f"({nb}, {F}, N={n}): kernel {t_k5[0]:.3f} ms, plain "
                f"{plain:.3f} ms, library none, bound {t_k5[3]:.4f} ms "
                f"({t_k5[4]}), {100 * t_k5[3] / t_k5[0]:.2f}% of it (CUDA "
                f"events) | {smi}")
            if form == chosen:
                ms[name] = t_k5
    def ms_line(name, where, t, lib):
        say("9 times", f"{name} at {where}: kernel {t[0]:.3f} ms, plain "
            f"{t[1]:.3f} ms, library {t[2]:.3f} ms ({lib}), bound "
            f"{t[3]:.4f} ms ({t[4]}), {100 * t[3] / t[0]:.2f}% of it (CUDA "
            f"events) | {smi}")

    for dtype, (A, b) in boost_sys.items():
        nb, n, el = A.shape[0], A.shape[1], A.element_size()
        name = gj_real.K2[dtype].name
        shape[name] = f"boost ({nb}, {n})"
        ms[name] = (cuda_ms(lambda: gj_real.gj_solve_cuda(A, b), 20),
                    cuda_ms(lambda: linsolve.gj_solve(A, b), 5),
                    cuda_ms(lambda: torch.linalg.solve(A, b), 5),
                    *bound(nb * solve_flops(n),
                           el * nb * (n * n + 2 * n) + nb, dtype))
    # K3 in every tier that takes N at the four shapes where the main path
    # inverts a transient's matrix once (k3_shapes): (a) the tran-1M
    # loop's RC matrices (phase 2's, f32 and f64), (b) a ladder-64
    # Monte-Carlo transient, (c) phase 21's N = 129 transient, (d)
    # flat-256's deck as a transient; each tier held to the plain version
    # on the same matrices (valid identical, check_close at TOL; the
    # chosen tier's error goes into the JSON line) and timed beside it,
    # torch.linalg.inv and the bound; the JSON line keeps the chosen
    # tier's times at (a)
    k3_mats = [(f"(a) RC tran ({A.shape[0]}, {A.shape[1]})", A)
               for A in rc_mat.values()]
    k3_mats += [(label[:1].join("()") + label[1:], A)
                for label, _dt, A in k3_shapes(SEED, dev, "bcd")]
    for where, A in k3_mats:
        nb, n, el = A.shape[0], A.shape[1], A.element_size()
        dtype = A.dtype
        name = gj_real.K3[dtype].name
        bnd = bound(nb * inverse_flops(n), el * nb * 2 * n * n + nb, dtype)
        pinv, pv = linsolve.gj_inverse(A)
        if not bool(pv.all()):
            raise AssertionError(f"K3 {where}: plain inverse flags "
                                 f"{int((~pv).sum())} systems")
        plain = cuda_ms(lambda: linsolve.gj_inverse(A), 2)
        lib = cuda_ms(lambda: torch.linalg.inv(A), 5)
        chosen = gj_real.tier_for(n, dtype, inverse=True)
        for tier in gj_real.inverse_tiers(n):
            inv, v = gj_real.gj_inverse_cuda(A, tier=tier)
            what = f"K3 {tier} {where} {TAG[dtype]}"
            if not torch.equal(v, pv):
                raise AssertionError(f"{what}: valid differs")
            e = check_close(inv, pinv, TOL[dtype], what)
            if tier == chosen:
                err[name] = max(err[name], e)
            say("9 compare", f"{what}: valid identical, max_abs_err "
                f"{e:.3e} (max|inverse| {float(pinv.abs().max()):.3e})")
            del inv, v
            first = cuda_ms(lambda: gj_real.gj_inverse_cuda(A, tier=tier), 1)
            reps = max(2, min(100, int(100 / max(first, 1e-3))))
            t = (cuda_ms(lambda: gj_real.gj_inverse_cuda(A, tier=tier), reps),
                 plain, lib, *bnd)
            ms_line(f"{gj_real.K3[dtype].name} {tier}"
                    f"{' (chosen)' if tier == chosen else ''}",
                    f"{where} {TAG[dtype]}", t,
                    f"linalg.inv, {TAG[dtype]}")
            if tier == chosen and where.startswith("(a)"):
                shape[name] = f"{where} ({chosen})"
                ms[name] = t
        del pinv, pv
    del k3_mats
    torch.cuda.empty_cache()
    # K4 at both .noise shapes, every tier that takes N, f64 (the .noise
    # path) and f32 at the amp's: the planes read once, the inverse and
    # valid written once; the JSON line keeps f64's chosen tier at the
    # ladder's shape
    for dtype, labels in ((f64, ("amp", "ladder")),
                          (torch.float32, ("amp",))):
        name = gj.K4[dtype].name
        for label in labels:
            Ar, Ai = (p.to(dtype) for p in noise_planes[label])
            nb, n = Ar.shape[0], Ar.shape[1]
            Ac = torch.complex(Ar, Ai)
            plain = cuda_ms(lambda: linsolve.gj_inverse_planes(Ar, Ai), 2)
            lib = cuda_ms(lambda: torch.linalg.inv(Ac), 5)
            bnd = bound(nb * inverse_flops(n, True),
                        Ar.element_size() * nb * 4 * n * n + nb, dtype)
            for tier in gj.TIERS:
                if tier == "warp" and n > gj.WARP_MAX_N:
                    continue
                t_k4 = (cuda_ms(lambda: gj.gj_inverse_planes_cuda(
                    Ar, Ai, tier=tier), 20), plain, lib, *bnd)
                chosen = tier == gj.tier_for(n, dtype, inverse=True)
                say("9 times", f"{name} {tier}{' (chosen)' if chosen else ''}"
                    f" at {label} noise ({nb}, {n}): kernel {t_k4[0]:.4f} ms,"
                    f" plain {plain:.3f} ms, library {lib:.4f} ms "
                    f"(linalg.inv, {Ac.dtype}), bound {t_k4[3]:.4f} ms "
                    f"({t_k4[4]}), {100 * t_k4[3] / t_k4[0]:.2f}% of it "
                    f"(CUDA events) | {smi}")
                if chosen and label == "ladder":
                    shape[name] = f"ladder noise ({nb}, {n})"
                    ms[name] = t_k4
            del Ac, Ar, Ai
    # K7 at the phase-18 shape, pattern RHS; the library call solves the
    # same systems pre-assembled as complex planes (assembly excluded),
    # built a block of variants at a time into one tensor
    for dtype, inputs in lad16_inputs.items():
        freqs, values, packed = inputs
        F, nb, n = freqs.shape[0], values.shape[1], packed.n
        el = values.element_size()
        cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
        Ac = torch.empty((nb * F, n, n), dtype=cdt, device=dev)
        bc = torch.empty((nb * F, n), dtype=cdt, device=dev)
        for s0 in range(0, nb, 2048):
            part = {k: v[s0:s0 + 2048] for k, v in ac16_over.items()}
            Ar, Ai, br, bi = assembled(lad16, part, len(part["r1"]), dtype)
            Ac[s0 * F:s0 * F + Ar.shape[0]] = torch.complex(Ar, Ai)
            bc[s0 * F:s0 * F + Ar.shape[0]] = torch.complex(br, bi)
            del Ar, Ai, br, bi
        plain = cuda_ms(lambda: plain_x_chunked(*inputs, None), 1)
        lib = cuda_ms(lambda: torch.linalg.solve(Ac, bc), 2)
        del Ac, bc
        torch.cuda.empty_cache()
        bnd = bound(F * nb * (solve_flops(n, True)
                              + 2 * packed.terms.shape[0]),
                    el * (values.numel() + F) + F * nb * (2 * n * el + 1),
                    dtype)
        name = mc_ac_fused.K7[dtype].name
        t_k7 = (cuda_ms(lambda: mc_ac_fused.mc_ac_fused_x_cuda(*inputs), 3),
                plain, lib, *bnd)
        say("9 times", f"{name} at batch-ac-16k ({nb}, {F}, N={n}, group "
            f"{mc_ac_fused.fused_group_for(n)}): kernel {t_k7[0]:.3f} ms, "
            f"plain {plain:.3f} ms, library {lib:.3f} ms (linalg.solve on "
            f"pre-assembled {cdt} planes, assembly excluded), bound "
            f"{t_k7[3]:.4f} ms ({t_k7[4]}), {100 * t_k7[3] / t_k7[0]:.2f}% "
            f"of it (CUDA events) | {smi}")
        if name in kernels:
            shape[name] = f"batch-ac-16k ({nb}, {F}, N={n})"
            ms[name] = t_k7
        torch.cuda.empty_cache()
    def tiers_of(module, n):
        return [t for t in module.TIERS
                if not (t == "warp" and n > module.WARP_MAX_N)
                and not (t == "thread" and n > gj_real.THREAD_MAX_N)]

    def time_tiers(planes, dtype, where, reps, cold):
        """Every tier of K1 on the complex planes and of K2 on their real
        part (and K10b / K10a where N is in their [40, 128]), each beside the plain
        version, torch.linalg.solve on the same planes and the bound;
        returns {kernel name: times} of K10 for the JSON line."""
        Ar, Ai, br, bi = planes
        nb, n, el = Ar.shape[0], Ar.shape[1], Ar.element_size()
        out = {}
        Ac, bc = torch.complex(Ar, Ai), torch.complex(br, bi)
        lib = cuda_ms(lambda: torch.linalg.solve(Ac, bc), 2)
        del Ac, bc
        torch.cuda.empty_cache()
        bnd = bound(nb * solve_flops(n, True),
                    el * nb * (2 * n * n + 4 * n) + nb, dtype)
        plain = cuda_ms(lambda: linsolve.gj_solve_planes(*planes), 1,
                        warm=not cold)
        for tier in tiers_of(gj, n):
            t = (cuda_ms(lambda: gj.gj_solve_planes_cuda(*planes, tier=tier),
                         reps), plain, lib, *bnd)
            chosen = " (chosen)" if tier == gj.tier_for(n, dtype) else ""
            ms_line(f"{gj.K1[dtype].name} {tier}{chosen}", where, t,
                    f"linalg.solve, complex {TAG[dtype]}")
        if mxu.MXU_MIN_N <= n <= mxu.MXU_MAX_N:
            t = out[mxu.K10b[dtype].name] = (
                cuda_ms(lambda: mxu.mxu_solve_complex(*planes), reps),
                cuda_ms(lambda: mxu.mxu_solve_complex_plain(*planes), 1,
                        warm=not cold), lib, *bnd)
            ms_line(mxu.K10b[dtype].name, where, t,
                    f"linalg.solve, complex {TAG[dtype]}")
        lib = cuda_ms(lambda: torch.linalg.solve(Ar, br), 3)
        bnd = bound(nb * solve_flops(n), el * nb * (n * n + 2 * n) + nb,
                    dtype)
        plain = cuda_ms(lambda: linsolve.gj_solve(Ar, br), 1, warm=not cold)
        for tier in tiers_of(gj_real, n):
            t = (cuda_ms(lambda: gj_real.gj_solve_cuda(Ar, br, tier=tier),
                         reps), plain, lib, *bnd)
            chosen = " (chosen)" if tier == gj_real.tier_for(n, dtype) \
                else ""
            ms_line(f"{gj_real.K2[dtype].name} {tier}{chosen}", where, t,
                    f"linalg.solve, real {TAG[dtype]}")
        if mxu.MXU_MIN_N <= n <= mxu.MXU_MAX_N:
            t = out[mxu.K10a[dtype].name] = (
                cuda_ms(lambda: mxu.mxu_solve_real(Ar, br), reps),
                cuda_ms(lambda: mxu.mxu_solve_real_plain(Ar, br), 1,
                        warm=not cold), lib, *bnd)
            ms_line(mxu.K10a[dtype].name, where, t,
                    f"linalg.solve, real {TAG[dtype]}")
        return out

    # every tier of K1 and K2 and K10a/K10b at the sweep's N = 16, 32, 64
    # and 128 shapes, f64 and f32; the JSON line keeps K10 at N = 64,
    # ladder-64's shape, where K1's entry was timed
    t9 = time.perf_counter()
    for n in (16, 32, 64, 128):
        for dtype in (torch.float64, torch.float32):
            planes = sweep_planes(n, dtype)
            t10 = time_tiers(planes, dtype, f"sweep N={n} "
                             f"({planes[0].shape[0]}, {n})", 3, n >= 64)
            if n == 64:
                for name, t in t10.items():
                    shape[name] = f"sweep N=64 ({planes[0].shape[0]}, {n})"
                    ms[name] = t
            del planes
            torch.cuda.empty_cache()
    # every tier of K1 f64 at phase 21's N = 256 planes (16 variants x 51
    # frequencies), and of K2 f64 on their real part
    planes = assembled(flat256, f256_over, 16, f64)
    time_tiers(planes, f64, f"flat-256 ({planes[0].shape[0]}, 256)", 5,
               True)
    del planes
    torch.cuda.empty_cache()
    # every tier of K1 and K2 f64 past the N where the panel tier's
    # [panel | C] fits in shared memory (complex from 402, real from 823),
    # on random well-conditioned systems: the measurement that keeps the
    # panel tier there rather than the block tier
    for n, nb in ((512, 64), (1024, 16)):
        planes = [torch.as_tensor(a, dtype=f64, device=dev) for a in (
            rng.standard_normal((nb, n, n)) + n * np.eye(n),
            rng.standard_normal((nb, n, n)), *rng.standard_normal((2, nb, n)))]
        time_tiers(planes, f64, f"random ({nb}, {n})", 1, True)
        del planes
        torch.cuda.empty_cache()
    say("9 times", f"tiers and K10: {time.perf_counter() - t9:.1f} s")
    def plan_line(plan):
        return (f"{plan.tpb} threads x {plan.blocks} blocks, "
                f"{plan.resident} resident per SM, {plan.waves:.3f} waves")

    # K8 at tran-1M in every form, each with its launch plan; the bound
    # counts the inverse, the assembly and each step's RHS terms, product
    # and state update
    vs, values, pattern, _node = tran_big_inputs
    s1, nb, n = vs.shape[0], values.shape[1], pattern.n
    name = mc_tran_fused.K8[torch.float32].name
    shape[name] = f"RC tran ({nb}, {s1} steps)"
    bnd = bound(nb * (k8_step_ops(pattern) * s1 + inverse_flops(n)
                      + 2 * pattern.terms.shape[0]),
                4 * (values.numel() + vs.numel() + s1 * nb) + nb,
                torch.float32)
    plain = cuda_ms(lambda: mc_tran_fused.mc_tran_fused_plain(
        *tran_big_inputs), 1)
    for form in tran_forms(n):
        plan = mc_tran_fused.k8_launch_plan(values, pattern, form)
        t = (cuda_ms(lambda: mc_tran_fused.mc_tran_fused_cuda(
            *tran_big_inputs, form=form), 5), plain, None, *bnd)
        chosen = form == mc_tran_fused.k8_form_for(n)
        say("9 times", f"{name} {form}{' (chosen)' if chosen else ''} at "
            f"tran-1M ({nb}, {s1} steps, N={n}; {plan_line(plan)}): kernel "
            f"{t[0]:.4f} ms, plain {plain:.3f} ms, library none, bound "
            f"{t[3]:.4f} ms ({t[4]}), {100 * t[3] / t[0]:.2f}% of it (CUDA "
            f"events) | {smi}")
        if chosen:
            ms[name] = t
    # K9 against its plain version at each main-path shape of phases 10-12
    # (the same overrides; ring-4096 the first 4096 ring variants), the
    # Newton passes per lane the plain version ran there, and every form's
    # time with its launch plan beside the bound, whose operations are
    # counted from those lane passes and the pattern's device tables
    # (k9_ops); the JSON line keeps the chosen form at boost-100k
    name = mc_tran_fused.K9[torch.float32].name
    k9_main = {"boost-100k": (BOOST_NET, "N3", sw_over, "spicey"),
               "boost 10us grid 100k": (BOOST_FINE, "N3", sw_over,
                                        "spicey"),
               "ring-100k": (RING_NET, "n1", ring_over, "extended"),
               "ring-4096": (RING_NET, "n1", r4k, "extended"),
               "bjt-100k": (BJT_NET, "c1", q_over, "extended")}
    for label, (net, node, over, dialect) in k9_main.items():
        nt = len(next(iter(over.values())))
        k9_in = k9_inputs(net, node, over, nt, dialect)
        vs, values, pattern, node_idx, kw = k9_in
        t0 = time.perf_counter()
        errs, passes, nv, nt = k9_vs_plain(k9_in, label, True)
        cmp_s = time.perf_counter() - t0
        if nv != nt:
            raise AssertionError(f"K9 {label}: {nv}/{nt} valid")
        pm, px, wf = pass_stats(passes)
        s1, n = vs.shape[0], pattern.n
        bnd = bound(k9_ops(pattern, float(passes.sum()), nt * s1),
                    4 * (values.numel() + vs.numel() + s1 * nt) + nt,
                    torch.float32)
        say("9 K9 main shapes", f"{label} ({nt}, {s1} steps, "
            f"nr={kw['nr']}): valid {nv}/{nt}, max_abs_err "
            f"{k9_errs(errs, n)} of 1e-4 x max|V|; Newton passes per lane "
            f"mean {pm:.1f} max {px}, warp max / mean {wf:.2f}; bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); comparison {cmp_s:.1f} s wall")
        plain = None
        if label == "boost-100k":
            plain = cuda_ms(lambda: mc_tran_fused.mc_tran_fused_nr_plain(
                vs, values, pattern, node_idx, **kw), 1)
        for form in tran_forms(n):
            plan = mc_tran_fused.k9_launch_plan(values, pattern, form)
            t_ms = cuda_ms(lambda: mc_tran_fused.mc_tran_fused_nr_cuda(
                vs, values, pattern, node_idx, form=form, **kw), 5)
            chosen = form == mc_tran_fused.k9_form_for(n)
            say("9 times", f"{name} {form}{' (chosen)' if chosen else ''} "
                f"at {label} (N={n}; {plan_line(plan)}): kernel "
                f"{t_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
                f"{100 * bnd[0] / t_ms:.2f}% of it (CUDA events) | {smi}")
            if chosen and plain is not None:
                shape[name] = (f"boost ({nt}, {s1} steps, {pm:.1f} passes "
                               "per lane)")
                ms[name] = (t_ms, plain, None, *bnd)
        del k9_in, vs, values, passes
        torch.cuda.empty_cache()
    for deck, (pm, px, wf, steps1) in k9_passes.items():
        say("9 passes", f"K9 {deck} (phase 2, B = {RING_B}): {pm:.1f} "
            f"Newton passes per lane over {steps1} steps "
            f"({pm / steps1:.3f} per step), max {px}, warp max / mean "
            f"{wf:.2f}")
    for name, (k_ms, p_ms, lib_ms, b_ms, b_by) in ms.items():
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        say("9 times", f"{name} at {shape[name]}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, library {lib}, bound {b_ms:.4f} ms "
            f"({b_by}) (CUDA events) | {smi}")

    say("done", f"all phases in {time.perf_counter() - t_start:.1f} s "
        "(host clock, builds included)")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name][0],
         "plain_ms": ms[name][1], "bound_ms": ms[name][3],
         "bound_by": ms[name][4], "library_ms": ms[name][2],
         **({"tiers": tier_launches[name]} if name in tier_launches else {})}
        for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
