"""Sensitivity, fitting and the adaptive transient on the card, against the CPU path.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_sens.py
[--out FILE]``; ``chip_smoke.py`` phase 26 runs the same workloads
(``phase26``) with every kernel's launches counted per workload. Imports
nothing of JAX. The CPU path's references run in ``CPU_WORKERS`` worker
processes (``CPU_THREADS`` threads each) while the card runs (e) and (f);
every comparison comes after the card's last workload.

Workloads (each through the public entry points; walls on the host clock
around a call ending in ``torch.cuda.synchronize()``):
  (a) sens-ac-ladder64: ``sensitivity_ac`` of ``decks.rc_ladder_netlist(64)``
      (N = 66, 51 frequencies) at its far end, 8 targets (r and c at both
      ends and the middle), against the CPU path (rtol 1e-9, atol 1e-12 of
      each series' largest |value|), against forward-mode AD through the
      plain Gauss-Jordan run on the same device (the same rule), and
      against a central difference of ``simulate_ac`` (h = ``FD_H`` of
      each value; within ``FD_TOL`` of each series' largest |value|, a
      physics check: the difference's truncation and rounding);
  (b) sens-tran-boost: ``sensitivity_tran(decks.BOOST_FINE, "N3", ["LL1",
      "CC1", "RR1"])``, 1001 points (switch, diode and Newton on K2);
  (c) sens-tran-transformer: ``decks.TRANSFORMER_TRAN`` (502 points), the
      primary winding's L and the load (M^-1 and the factor-once inverse,
      K3, whose tangents are products of the inverse);
  (d) fit-ac-ladder64: ``fit_ac`` of the ladder's far-end magnitude for
      r32 and c32 from a 20% start, 200 Adam steps (one K1 launch and one
      adjoint K1 launch a step): the values recovered within 1e-4, the
      first ``FIT_CPU_STEPS`` losses = the CPU path's at rtol 1e-6;
  (e) fit-tran-rc: ``fit_tran`` of tests/test_fit.py:44's RC deck for C1
      from 1 uF (true 2.2 uF), 150 steps: C1 within 5e-3, converged, the
      first ``FIT_CPU_STEPS`` losses = the CPU path's at rtol 1e-6; beside
      it the primal ``simulate_tran`` of the same deck, timed, and (this
      script only, not ``chip_smoke.py``) one fit step and one primal run
      under ``torch.profiler``
      (``tools/profile_torch_ac.py:device_breakdown``, ``host_counts``):
      launches, synchronizations, device busy time and idle share;
  (f) adaptive-boost, adaptive-ua741, adaptive-ua741-long:
      ``simulate_tran_adaptive`` of ``decks.BOOST_NET`` (its whole 0.1 s)
      and of ``decks.UA741_AMP`` over its first ``UA741_HORIZON`` and
      ``UA741_LONG`` from rest (the power-up transient, where the
      controller takes most of its steps; the whole 50 us is held against
      the JAX package on the CPU by ``tools/profile_torch_adaptive.py``):
      counts and flags equal to the CPU path's (over ``UA741_LONG`` only
      the flags: the controller amplifies the card's last-bit differences
      into its step sizes, and the counts drift, ROADMAP §3); the boost's
      times and node voltages at rtol 1e-9 / atol 1e-12 of the max, the
      uA741's by tests/test_torch_adaptive.py's rule for decks whose
      controller amplifies rounding (first and last times at 1e-9, the
      voltages against the CPU series interpolated at the card's times
      within ``UA741_GAP`` of the largest |node voltage|); and (this script
      only) the boost and the short uA741 over a cut horizon
      (``PROFILE_TRAN``) under the profiler, per attempt.
Every line carries the card's nvidia-smi name and power limit; the lines
also go to ``--out`` (default ``build/profile_torch_sens.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.profile_torch_schur import smi  # noqa: E402

LADDER_WRT = ["r1", "c1", "r32", "c32", "r33", "c33", "r64", "c64"]
BOOST_WRT = ["LL1", "CC1", "RR1"]
FIT_CPU_STEPS = 20
UA741_HORIZON = "0.005u"
UA741_LONG = "0.02u"
UA741_GAP = 1e-4
FD_H = 1e-3     # the central difference's step, of each value
FD_TOL = 1e-4   # of each series' largest |value|
CPU_WORKERS, CPU_THREADS = 2, 3
# (f)'s profiled runs: the deck's .tran line -> the cut one they run
PROFILE_TRAN = {"boost": (".tran 0.001 0.1 uic", ".tran 0.001 0.02 uic"),
                "ua741": (f".tran 1u {UA741_HORIZON}", ".tran 1u 0.0002u")}
RC_TRUE = "t\nV1 1 0 dc 5\nR1 1 2 1k\nC1 2 0 2.2u\n.tran 20u 5m\n"


def timed(fn):
    """(fn(), host seconds), the call ending in a synchronize."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def series_close(got: dict, want: dict, what: str, rtol: float = 1e-9,
                 atol_of_max: float = 1e-12) -> float:
    """Every series at ``rtol`` with an atol of ``atol_of_max`` of its
    largest |value|; returns the largest |got - want| over that max."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: keys {list(got)} != {list(want)}")
    worst = 0.0
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_of_max * scale,
                                   err_msg=f"{what} {name}")
        if scale:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def plain_native(fn):
    """``fn()`` with the AC sweep's solve replaced by the plain Gauss-
    Jordan called directly, so forward-mode AD differentiates its
    elimination op by op on the same device (no rule, no kernel)."""
    from spicey_tpu_torch.analysis import ac as tac
    from spicey_tpu_torch.ops import linsolve

    def direct(A_re, A_im, b_re, b_im, method="gj", eps=linsolve.EPS,
               plan=None):
        return linsolve.gj_solve_planes(A_re, A_im, b_re, b_im, eps=eps)

    saved = tac.solve_planes
    tac.solve_planes = direct
    try:
        return fn()
    finally:
        tac.solve_planes = saved


def central_difference(st, ckt, node: str, wrt: list, dev) -> dict:
    """d|V(node)|/d(value) by central differences of ``simulate_ac``."""
    tensors = st.build_tensors(ckt)
    out = {}
    for name in wrt:
        group = {"r": "r", "c": "c"}[name[0].lower()]
        names = [n.upper() for n in getattr(tensors, f"{group}_names")]
        i = names.index(name.upper())
        base = getattr(tensors, f"{group}_vals")
        h = FD_H * base[i]
        mags = []
        for sign in (1.0, -1.0):
            vals = base.copy()
            vals[i] += sign * h
            t = dataclasses.replace(tensors, **{f"{group}_vals": vals})
            mags.append(np.abs(st.simulate_ac(ckt, tensors=t, device=dev)
                               .node_voltages[node]))
        out[name] = (mags[0] - mags[1]) / (2 * h)
    return out


def adaptive_close(got, want, what: str, amplified: bool,
                   counts: bool = True) -> float:
    """Counts (unless not ``counts``) and flags equal; the times and node
    voltages at the rule, or for ``amplified`` decks first/last times at
    1e-9 and each voltage within ``UA741_GAP`` of its max against the
    reference interpolated at ``got``'s times. Returns the largest gap over
    the max."""
    for f in ("n_accepted", "n_rejected", "n_attempts", "exhausted"):
        if (counts or f == "exhausted") and getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{what} {f}: {getattr(got, f)} against "
                                 f"{getattr(want, f)}")
    if not amplified:
        series_close({"t": got.times}, {"t": want.times}, f"{what} times")
        return series_close(got.node_voltages, want.node_voltages, what)
    series_close({"t": got.times[[0, 1, -1]]},
                 {"t": want.times[[0, 1, -1]]}, f"{what} times")
    scale = max(float(np.abs(v).max()) for v in want.node_voltages.values())
    worst = 0.0
    for name, v in want.node_voltages.items():
        ref = np.interp(got.times, want.times, v)
        gap = float(np.abs(got.node_voltages[name] - ref).max()) / scale
        if gap > UA741_GAP:
            raise AssertionError(f"{what} v({name}): gap {gap:.3e} over "
                                 f"{UA741_GAP:g}")
        worst = max(worst, gap)
    return worst


def cpu_reference(entry: str, net: str, dialect: str, args: tuple,
                  kwargs: dict):
    """``spicey_tpu_torch.<entry>(parse_netlist(net), *args, device="cpu",
    **kwargs)`` in a worker process: (result, seconds)."""
    torch.set_num_threads(CPU_THREADS)
    import spicey_tpu_torch as st

    ckt = st.parse_netlist(net, dialect=dialect)
    t0 = time.perf_counter()
    out = getattr(st, entry)(ckt, *args, device="cpu", **kwargs)
    return out, time.perf_counter() - t0


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` for the device's busy
    time and idle share, one more for its launches and synchronizations."""
    from tools.profile_torch_ac import device_breakdown, host_counts

    brk = device_breakdown(fn, top=3)
    return {**{k: brk[k] for k in ("wall_ms", "device_busy_ms",
                                   "idle_share")}, **host_counts(fn)}


def per(p: dict, n: int, what: str) -> str:
    """A profile's numbers per ``what`` (``n`` of them)."""
    return (f"per {what}: {p['wall_ms'] / n:.3f} ms wall (profiled), "
            f"{p['launches'] / n:.1f} launches, {p['syncs'] / n:.1f} syncs, "
            f"{p['d2h_copies'] / n:.1f} host reads, device busy "
            f"{p['device_busy_ms'] / n:.4f} ms (idle {p['idle_share']:.1%}; "
            f"{p['launches']} launches in {p['wall_ms']:.1f} ms)")


def phase26(dev, run, emit, card: str, profile: bool = False) -> dict:
    """The workloads. ``run(label, fn, rules)`` calls ``fn`` once, timed,
    and returns (result, wall): chip_smoke's counts the kernels' launches
    around it and requires each (kernel, role) of ``rules`` to have run.
    ``emit(line)`` prints; ``card`` is appended to every line. ``profile``:
    also (e)'s and (f)'s profiled runs (this script's; ``chip_smoke.py``
    leaves them out, as their traces take ~100 s to read). Returns {label:
    wall}."""
    import multiprocessing as mp

    import spicey_tpu_torch as st
    from spicey_tpu_torch import decks

    ext, sp = "extended", "spicey"
    ladder_net = decks.rc_ladder_netlist(64)
    ladder = st.parse_netlist(ladder_net)
    ac_target = np.abs(st.simulate_ac(ladder, device="cpu")
                       .node_voltages["n64"])
    x0 = {"r32": 1.2 * 132.0, "c32": 1.2e-6}   # r32 132 ohm, c32 1 uF
    rc_start = RC_TRUE.replace("2.2u", "1u")
    tran_target = st.simulate_tran(st.parse_netlist(RC_TRUE), device="cpu"
                                   ).node_voltages["2"]

    def ua(tstop):
        return decks.UA741_AMP.replace(".tran 1u 50u", f".tran 1u {tstop}")

    # name -> (deck, dialect, amplified, counts held equal)
    adaptive = {"boost": (decks.BOOST_NET, sp, False, True),
                "ua741": (ua(UA741_HORIZON), ext, True, True),
                "ua741-long": (ua(UA741_LONG), ext, True, False)}
    walls, got, prof = {}, {}, {}

    # one warm call: the first forward-mode pass through the AC sweep
    # (its dual dispatch) costs seconds on its own
    st.sensitivity_ac(ladder, "n64", LADDER_WRT, device=dev)
    # the card's workloads, each on its own counters
    got["a"], walls["a"] = run("a sens-ac-ladder64", lambda: (
        st.sensitivity_ac(ladder, "n64", LADDER_WRT, device=dev)),
        [("K1", "forward"), ("K1", "tangent")])
    native = plain_native(lambda: st.sensitivity_ac(
        ladder, "n64", LADDER_WRT, device=dev))
    _, ac_primal_s = timed(lambda: st.simulate_ac(ladder, device=dev))
    fd = central_difference(st, ladder, "n64", LADDER_WRT, dev)

    bckt = st.parse_netlist(decks.BOOST_FINE)
    got["b"], walls["b"] = run("b sens-tran-boost", lambda: (
        st.sensitivity_tran(bckt, "N3", BOOST_WRT, device=dev)),
        [("K2", "forward"), ("K2", "tangent")])
    _, b_primal_s = timed(lambda: st.simulate_tran(bckt, device=dev))

    xckt = st.parse_netlist(decks.TRANSFORMER_TRAN, dialect=ext)
    got["c"], walls["c"] = run("c sens-tran-transformer", lambda: (
        st.sensitivity_tran(xckt, "s", ["l1", "rload"], device=dev)),
        [("K3", "forward"), ("K3", "tangent")])

    got["d"], walls["d"] = run("d fit-ac-ladder64", lambda: st.fit_ac(
        ladder, "n64", ac_target, ["r32", "c32"], x0=x0, steps=200,
        device=dev), [("K1", "forward"), ("K1", "adjoint")])

    # the CPU path's references, in worker processes beside the card's last
    # and longest workloads, (e) and (f); compared after them
    with mp.get_context("spawn").Pool(CPU_WORKERS) as pool:
        def cpu(entry, net, dialect, *args, **kwargs):
            return pool.apply_async(cpu_reference,
                                    (entry, net, dialect, args, kwargs))

        ref = {f"f {name}": cpu("simulate_tran_adaptive", net, dialect)
               for name, (net, dialect, _, _) in reversed(adaptive.items())}
        ref["b"] = cpu("sensitivity_tran", decks.BOOST_FINE, sp, "N3",
                       BOOST_WRT)
        ref["e"] = cpu("fit_tran", rc_start, sp, "2", tran_target, ["C1"],
                       steps=FIT_CPU_STEPS)
        ref["d"] = cpu("fit_ac", ladder_net, sp, "n64", ac_target,
                       ["r32", "c32"], x0=x0, steps=FIT_CPU_STEPS)
        ref["c"] = cpu("sensitivity_tran", decks.TRANSFORMER_TRAN, ext, "s",
                       ["l1", "rload"])
        ref["a"] = cpu("sensitivity_ac", ladder_net, sp, "n64", LADDER_WRT)

        rc = st.parse_netlist(rc_start)
        got["e"], walls["e"] = run("e fit-tran-rc", lambda: st.fit_tran(
            rc, "2", tran_target, ["C1"], steps=150, device=dev),
            [("K3", "forward"), ("K3", "tangent")])
        _, e_primal_s = timed(lambda: st.simulate_tran(rc, device=dev))
        if profile:
            prof["e step"] = profiled(lambda: st.fit_tran(
                rc, "2", tran_target, ["C1"], steps=1, device=dev))
            prof["e primal"] = profiled(lambda: st.simulate_tran(
                rc, device=dev))

        for name, (net, dialect, _, _) in adaptive.items():
            key = f"f {name}"
            ckt = st.parse_netlist(net, dialect=dialect)
            got[key], walls[key] = run(
                f"f adaptive-{name}", lambda: st.simulate_tran_adaptive(
                    ckt, device=dev), [("K2", "launch")])
            if not profile or name not in PROFILE_TRAN:
                continue
            old, new = PROFILE_TRAN[name]
            assert old in net, (name, old)
            cut = st.parse_netlist(net.replace(old, new), dialect=dialect)
            first = st.simulate_tran_adaptive(cut, device=dev)
            prof[key] = (profiled(lambda: st.simulate_tran_adaptive(
                cut, device=dev)), first.n_accepted + first.n_rejected, new)

        cpu_s = {}
        for key in ref:
            ref[key], cpu_s[key] = ref[key].get()
    emit("the CPU path's references (s, in worker processes): "
         + json.dumps({k: round(v, 3) for k, v in cpu_s.items()}))

    gap = series_close(got["a"], ref["a"], "a sens-ac-ladder64 vs CPU")
    gap_n = series_close(got["a"], native, "a rule vs native AD")
    gap_fd = series_close(got["a"], fd, "a rule vs central difference",
                          rtol=0.0, atol_of_max=FD_TOL)
    emit(f"(a) sens-ac-ladder64 (N = 66, 51 freqs, 8 targets): wall "
         f"{walls['a']:.4f} s; = CPU path (largest gap {gap:.2e} of max), "
         f"= forward-mode AD through the plain GJ on the same device "
         f"({gap_n:.2e}), central difference within {gap_fd:.2e} of max "
         f"(limit {FD_TOL:g}); d|V(n64)|/d r64 at 1 Hz "
         f"{got['a']['r64'][0]:.6e}; the primal simulate_ac "
         f"{ac_primal_s:.4f} s | {card}")

    sens = got["b"]
    gap = series_close(sens, ref["b"], "b sens-tran-boost vs CPU")
    emit(f"(b) sens-tran-boost ({len(sens['RR1'])} points, 3 targets): wall "
         f"{walls['b']:.3f} s (the primal simulate_tran {b_primal_s:.3f} s);"
         f" = CPU path (largest gap {gap:.2e} of max); at the end d v(N3) "
         f"/ d (LL1, CC1, RR1) = "
         f"{[float(f'{sens[k][-1]:.6e}') for k in BOOST_WRT]} | {card}")

    gap = series_close(got["c"], ref["c"], "c sens-tran-transformer vs CPU")
    emit(f"(c) sens-tran-transformer ({len(got['c']['l1'])} points, l1 and "
         f"rload): wall {walls['c']:.3f} s; = CPU path (largest gap "
         f"{gap:.2e} of max) | {card}")

    fit = got["d"]
    series_close({"loss": fit.loss_history[:FIT_CPU_STEPS]},
                 {"loss": ref["d"].loss_history}, "d loss history",
                 rtol=1e-6, atol_of_max=0.0)
    err = max(abs(fit.values["r32"] / 132.0 - 1),
              abs(fit.values["c32"] / 1e-6 - 1))
    if not (fit.converged and err < 1e-4):
        raise AssertionError(f"d fit-ac-ladder64: {fit.values}, converged "
                             f"{fit.converged}")
    emit(f"(d) fit-ac-ladder64 (200 Adam steps, r32 and c32 from +20%):"
         f" wall {walls['d']:.3f} s ({walls['d'] / 200 * 1e3:.2f} ms a "
         f"step); recovered within {err:.2e}, loss {fit.loss_history[0]:.3e}"
         f" -> {fit.loss:.3e}; first {FIT_CPU_STEPS} losses = CPU path at "
         f"1e-6 | {card}")

    fit = got["e"]
    series_close({"loss": fit.loss_history[:FIT_CPU_STEPS]},
                 {"loss": ref["e"].loss_history}, "e loss history",
                 rtol=1e-6, atol_of_max=0.0)
    err = abs(fit.values["C1"] / 2.2e-6 - 1)
    if not (fit.converged and err < 5e-3):
        raise AssertionError(f"e fit-tran-rc: {fit.values}")
    emit(f"(e) fit-tran-rc (150 Adam steps, 251 points): wall "
         f"{walls['e']:.3f} s ({walls['e'] / 150 * 1e3:.1f} ms a step; the "
         f"primal simulate_tran {e_primal_s * 1e3:.1f} ms); C1 "
         f"{fit.values['C1']:.6e} ({err:.2e} off 2.2u), loss "
         f"{fit.loss_history[0]:.3e} -> {fit.loss:.3e}; first "
         f"{FIT_CPU_STEPS} losses = CPU path at 1e-6 | {card}")
    for key, what in (("e step", "one fit step"),
                      ("e primal", "one primal simulate_tran")):
        if key in prof:
            emit(f"(e) profiled, {what} (250 time steps): "
                 f"{per(prof[key], 250, 'time step')} | {card}")

    for name, (_, _, amplified, counts) in adaptive.items():
        key = f"f {name}"
        r, w = got[key], ref[key]
        gap = adaptive_close(r, w, key, amplified, counts)
        emit(f"(f) adaptive-{name}: {r.n_accepted} accepted, {r.n_rejected} "
             f"rejected of {r.n_attempts}, exhausted {r.exhausted}, to t = "
             f"{r.times[-1]:.6g} s: wall {walls[key]:.3f} s (the CPU path "
             f"{cpu_s[key]:.3f} s, in a worker beside the card's runs); "
             + ("counts = CPU path, " if counts else
                f"the CPU path {w.n_accepted} accepted, {w.n_rejected} "
                "rejected (not held equal), ")
             + f"{'voltages within ' if amplified else 'largest gap '}"
             f"{gap:.2e} of max | {card}")
        if key not in prof:
            continue
        p, n, tran = prof[key]
        emit(f"(f) adaptive-{name} profiled over `{tran}` ({n} attempts): "
             f"{per(p, n, 'attempt')} | {card}")
    return walls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "profile_torch_sens.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_sens: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    def run(label, fn, rules):
        return timed(fn)

    walls = phase26(torch.device("cuda"), run, emit, card, profile=True)
    emit(json.dumps({"walls_s": walls, "device": card}))
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
