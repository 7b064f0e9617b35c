"""The device mesh on the card: the four batched entry points sharded.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_mesh.py
[--out FILE]``; ``chip_smoke.py`` phase 27 runs the same workloads
(``phase27``) with every kernel's launches counted per call. Imports
nothing of JAX.

Workloads, each through the public entry points (walls on the host clock
around a call ending in ``torch.cuda.synchronize()``):
  yield-64k        ``mc_ac_stats`` of the RC deck, 65,536 x 201, f32,
                   ``method="pallas"`` (K5);
  tran-rc-64k      ``mc_tran_stats`` of ``decks.TRAN_NET``, 65,536
                   variants x 201 steps, f32, ``"pallas"`` (K8);
  boost-8k         ``mc_tran_stats`` of ``decks.BOOST_NET``, 8,192, f32,
                   ``"pallas"`` (K9);
  tp-rlc-32        ``mc_tran_stats`` of ``decks.tp_rlc_netlist("20m")``,
                   32 variants x 100,001 steps, f64, the time-parallel
                   core (K3);
  batch-ac-4096    ``simulate_ac_batch`` of ``rc_ladder_netlist(14, 201)``
                   (N = 16), 4,096 x 201, ``"pallas"`` (K7) and ``"gj"``
                   (K1);
  diode-switch-1024 ``simulate_tran_batch`` of DIODE_SWITCH over its first
                   2 ms (200 steps), 1,024 loads (K11 and K2 every
                   Newton pass).
Each is called unsharded; with ``device_put=sharder(make_mesh())`` (every
CUDA device of the machine), which must give the unsharded result bit for
bit with the same launches; and on meshes that repeat the first card,
``{"batch": 4}`` everywhere and ``{"batch": 2, "freq": 2}`` for
``simulate_ac_batch``, which must equal the unsharded call at the JAX mesh
tests' tolerances (``tests/test_torch_mesh.py``) and launch each kernel
once per piece (a Newton loop: once per pass of each piece, so between
the unsharded count and the pieces times it). Each line prints the walls
sharded and unsharded (the cost of splitting and gathering on one card,
not a multi-card figure) beside the card's name and power limit. Then
``warmup(full=True)`` in a new process: the seconds of its first round
trip, of the whole call and of the process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.profile_torch_schur import smi  # noqa: E402
from tools.profile_torch_sens import timed  # noqa: E402

SEED = 27
RC_AC = ("AC bench\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
         ".ac dec 100 1 100\n.end\n")
WARMUP = ("import json, time\nt0 = time.perf_counter()\n"
          "import spicey_tpu_torch as st\nt1 = time.perf_counter()\n"
          "s = st.warmup(full=True)\n"
          "print(json.dumps({'import_s': t1 - t0, 'round_trip_s': s,"
          " 'warmup_s': time.perf_counter() - t1}))\n")


def kernels() -> dict:
    """Every kernel counter of the port, by name."""
    from spicey_tpu_torch.ops import gj, gj_real, mc_ac_fused, mc_tran_fused
    from spicey_tpu_torch.ops import mxu, stamp_real

    ks = (list(gj.K1.values()) + list(gj.K4.values())
          + list(gj_real.K2.values()) + list(gj_real.K3.values())
          + list(mc_ac_fused.K5.values()) + list(mc_ac_fused.K7.values())
          + list(mc_tran_fused.K8.values()) + list(mc_tran_fused.K9.values())
          + list(mxu.K10a.values()) + list(mxu.K10b.values())
          + list(stamp_real.K11.values()))
    return {k.name: k for k in ks}


def arrays(res) -> dict:
    """The numbers of a result (MCStats or a batch result), by field."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}[{k}]": np.asarray(x) for k, x in v.items()})
        elif isinstance(v, (np.ndarray, int, float)):
            out[f.name] = np.asarray(v)
    return out


def same(a, b, what: str) -> None:
    """Bit for bit (NaN where NaN)."""
    for k, x in arrays(b).items():
        y = arrays(a)[k]
        if x.shape != y.shape or not np.array_equal(
                y, x, equal_nan=x.dtype.kind in "fc"):
            raise AssertionError(f"{what}: {k} differs from the unsharded "
                                 "call")


def close(got, want, what: str, rule: str, dev) -> float:
    """``got`` against the unsharded ``want`` by the JAX mesh tests' rule
    (``tests/test_torch_mesh.py``): "f64" rtol 1e-13 on the statistics
    and 1e-10 on quantiles, "tp" 1e-12 / 1e-10, "f32" rtol 1e-6 / atol
    1e-7 on means and 1e-4 / 1e-8 on std (both packages' f32 fused
    tiers), "x" rtol 1e-12 / atol 1e-15 on solutions; counts, flags and
    grids equal. Compared on the card; returns the largest absolute gap."""
    tol = {"f64": {"mean": (1e-13, 0.0), "q": (1e-10, 0.0)},
           "tp": {"mean": (1e-12, 0.0), "q": (1e-10, 0.0)},
           "f32": {"mean": (1e-6, 1e-7), "std": (1e-4, 1e-8)},
           "x": {"x": (1e-12, 1e-15), "xs": (1e-12, 1e-15)}}[rule]
    gap = 0.0
    a, b = arrays(got), arrays(want)
    for k, y in b.items():
        x = a[k]
        if x.dtype.kind in "biu" or k in ("grid", "freqs", "times"):
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: {k} differs")
            continue
        key = "q" if k.startswith("quantiles") else k
        if key not in tol:
            continue
        rtol, atol = tol[key]
        xt = torch.as_tensor(x, device=dev)
        yt = torch.as_tensor(y, device=dev)
        d = (xt - yt).abs()
        if bool((d > atol + rtol * yt.abs()).any()):
            raise AssertionError(f"{what}: {k} off by {float(d.max()):.3e}")
        gap = max(gap, float(d.max()) if d.numel() else 0.0)
    return gap


def phase27(dev, run, emit, card: str, cli_s: float | None = None) -> dict:
    """The workloads of the module docstring. ``run(label, fn)`` calls
    ``fn`` and returns (its result, wall seconds, {kernel name: launches
    in that call}); ``emit`` prints a line. Returns the walls."""
    import spicey_tpu_torch as st
    from spicey_tpu_torch.decks import (BOOST_NET, TRAN_NET,
                                        rc_ladder_netlist, tp_rlc_netlist)
    from spicey_tpu_torch.ops import (gj, gj_real, mc_ac_fused, mc_tran_fused,
                                      stamp_real)
    from tests.fixtures import netlists

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED)
    u = rng.random((2, 65536))
    mesh = st.make_mesh()
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if list(mesh.devices.ravel()) != cards or mesh.axis_names != ("batch",):
        raise AssertionError(f"make_mesh(): {mesh.devices}, "
                             f"{mesh.axis_names}")
    first = mesh.first

    def repeat(axes: dict):
        n = int(np.prod(list(axes.values())))
        return st.sharder(st.make_mesh(axes, devices=[first] * n))

    b4 = ("{batch: 4} on one card", repeat({"batch": 4}), 4)
    b22 = ("{batch: 2, freq: 2} on one card",
           repeat({"batch": 2, "freq": 2}), 4)
    lad = rc_ladder_netlist(14, 201)
    lad_over = {n: v * rng.uniform(0.9, 1.1, 4096)
                for n, v in _ladder_values(st, lad).items()}
    f32p = dict(method="pallas", precision="f32")
    k2 = gj_real.K2[f64]
    # the kernels of a Newton loop: K2 and K11 launch once per pass
    per_pass = {k2.name, stamp_real.K11[f64].name}
    # (label, the kernel it must launch, the comparison rule, the
    # repeated-card meshes, the call)
    workloads = [
        ("yield-64k", mc_ac_fused.K5[f32], "f32", [b4],
         lambda put: st.mc_ac_stats(
             RC_AC, {"r1": 30.0 * (1 + 0.2 * u[0]),
                     "c1": 100e-6 * (1 + 0.2 * u[1])}, node="2",
             device=first, device_put=put, **f32p)),
        ("tran-rc-64k", mc_tran_fused.K8[f32], "f32", [b4],
         lambda put: st.mc_tran_stats(
             TRAN_NET, {"R1": 1e3 * (1 + 0.2 * u[0]),
                        "C1": 1e-6 * (1 + 0.2 * u[1])}, node="2",
             device=first, device_put=put, **f32p)),
        ("boost-8k", mc_tran_fused.K9[f32], "f32", [b4],
         lambda put: st.mc_tran_stats(
             BOOST_NET, {"RR1": 1e3 * (1 + 0.1 * u[0, :8192])}, node="N3",
             device=first, device_put=put, **f32p)),
        ("tp-rlc-32", gj_real.K3[f64], "tp", [b4],
         lambda put: st.mc_tran_stats(
             tp_rlc_netlist("20m"), {"R1": 100.0 * (1 + 0.2 * u[0, :32]),
                                     "C1": 1e-6 * (1 + 0.2 * u[1, :32])},
             node="b", dialect="extended", device=first, device_put=put)),
        ("batch-ac-4096 pallas", mc_ac_fused.K7[f64], "x", [b4, b22],
         lambda put: st.simulate_ac_batch(lad, lad_over, method="pallas",
                                          device=first, device_put=put)),
        ("batch-ac-4096 gj", gj.K1[f64], "x", [b4, b22],
         lambda put: st.simulate_ac_batch(lad, lad_over, method="gj",
                                          device=first, device_put=put)),
        ("diode-switch-1024", k2, "x", [b4],
         lambda put: st.simulate_tran_batch(
             netlists.DIODE_SWITCH.replace(".tran 0.00001 0.01",
                                           ".tran 0.00001 0.002"),
             {"RR1": 1e3 * (1 + 0.1 * u[0, :1024])}, device=first,
             device_put=put)),
    ]
    walls = {}
    for label, must, rule, meshes, fn in workloads:
        base, base_s, base_l = run(label, lambda: fn(None))
        one, one_s, one_l = run(f"{label} make_mesh()",
                                lambda: fn(st.sharder(mesh)))
        same(one, base, f"27 {label} make_mesh()")
        if one_l != base_l:
            raise AssertionError(f"27 {label} make_mesh(): launches {one_l}"
                                 f" against the unsharded {base_l}")
        if not base_l.get(must.name):
            raise AssertionError(f"27 {label}: {must.name} never launched "
                                 f"({base_l})")
        walls[label] = {"unsharded": base_s, "make_mesh()": one_s}
        for mlabel, put, pieces in meshes:
            got, got_s, got_l = run(f"{label} {mlabel}", lambda: fn(put))
            gap = close(got, base, f"27 {label} {mlabel}", rule, first)
            if set(got_l) != set(base_l):
                raise AssertionError(f"27 {label} {mlabel}: kernels "
                                     f"{sorted(got_l)} against "
                                     f"{sorted(base_l)}")
            for n, c in base_l.items():
                ok = (c <= got_l[n] <= pieces * c if n in per_pass
                      else got_l[n] == pieces * c)
                if not ok:
                    raise AssertionError(
                        f"27 {label} {mlabel}: {n} {got_l[n]} launches, "
                        f"unsharded {c}, {pieces} pieces")
            walls[label][mlabel] = got_s
            emit(f"{label} {mlabel}: = unsharded (rule {rule}, max gap "
                 f"{gap:.3e}); wall sharded {got_s:.3f} s, unsharded "
                 f"{base_s:.3f} s, make_mesh() {one_s:.3f} s (bit for bit, "
                 f"same launches); launches {json.dumps(got_l)} against "
                 f"{json.dumps(base_l)} | {card}")
        del base, one, got
        torch.cuda.empty_cache()
    proc_s = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", WARMUP], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    proc_s = time.perf_counter() - proc_s
    if proc.returncode != 0:
        raise AssertionError(f"warmup: {proc.stderr[-2000:]}")
    w = json.loads(proc.stdout.strip().splitlines()[-1])
    walls["warmup"] = dict(w, process_s=proc_s)
    cli = "" if cli_s is None else (f"; the CLI's cold start (phase 24 (d))"
                                    f" {cli_s:.1f} s")
    emit(f"warmup(full=True) in a new process: first round trip "
         f"{w['round_trip_s']:.3f} s, the whole call {w['warmup_s']:.3f} s "
         f"(import {w['import_s']:.2f} s, process {proc_s:.1f} s){cli} "
         f"| {card}")
    return walls


def _ladder_values(st, net: str) -> dict:
    """Every R and C of the ladder at its netlist value."""
    t = st.build_tensors(st.parse_netlist(net))
    return dict(zip(t.r_names + t.c_names,
                    np.concatenate([t.r_vals, t.c_vals])))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "profile_torch_mesh.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mesh: no CUDA device", file=sys.stderr)
        return 1
    from spicey_tpu_torch.ops import _build

    _build.build(list(_build.LIBRARIES))  # out of the first calls' walls
    card = smi()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    ks = kernels()

    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    def run(label, fn):
        for k in ks.values():
            k.launches = 0
        res, wall = timed(fn)
        return res, wall, {n: k.launches for n, k in ks.items()
                           if k.launches}

    walls = phase27(torch.device("cuda"), run, emit, card)
    emit(json.dumps({"walls_s": walls, "device": card}))
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
