"""K1, K2, K4, K5, K7, K8 and K9 at ``chip_smoke.py`` phase 9's shapes, in
one tree.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_trees.py
[--root DIR] [--reps 20]``. Imports nothing of JAX.

``--root`` names the checkout whose ``spicey_tpu_torch`` is imported and
built (default: this one), so that two trees can be timed on one card in
one call, alternating (parent, change, change, parent): the way to show a
change left these kernels' times where they were, since two calls may
land on different cards. The inputs are made from a seed with numpy, at
the shapes phase 9 times them on the main path:

  K1  complex planes (2048 x 51 systems, N = 64, the ladder-64 cell), f32
      and f64, random and diagonally dominant (the chosen tier's time does
      not depend on the values);
  K2  real systems (100,000, N = 6, the boost converter's Newton systems),
      f32 and f64, the same way;
  K4  complex planes (901 systems, N = 64, the ladder-64 noise cell), f64,
      the same way;
  K5  the RC yield deck of phase 3 (1M variants x 201 frequencies, N = 3),
      R and C at U(1, 1.2) x nominal, f32 and f64;
  K7  the N = 16 RC ladder of phase 18 (16,384 variants x 201 frequencies,
      every R and C at U(0.9, 1.1) x nominal, the pattern's RHS), f64 and
      f32;
  K8  tran-1M (the RC pulse deck, 1M variants x 201 steps, R1 and C1 at
      U(1, 1.2) x nominal);
  K9  boost-100k and boost-10us-100k (the switch-diode boost on its 1 ms
      and on DIODE_SWITCH's 10 us grid, RR1 at U(1, 1.1) x 1k), ring-100k
      and ring-4096 (the MOSFET ring, c1 and c2 at U(1, 1.1) x 1 nF),
      bjt-100k (BJT_NET, Q1's Is at U(1, 1.2) x 1e-15), each through the
      wrapper in the form the tree chooses (``tools/profile_torch_k9.py``
      makes the inputs).

Each line: the kernel's instantiation, its shape and the mean device
milliseconds over ``--reps`` calls after a warm one (CUDA events); then
the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

RC_NET = ("AC bench\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 100 1 100\n.end\n")


def cuda_ms(fn, reps: int) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_trees: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import ac as tac
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.decks import rc_ladder_netlist
    from spicey_tpu_torch.ops import gj, gj_real, mc_ac_fused
    if not os.path.abspath(st.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {st.__file__}, not from {root}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def dominant(nb, n, planes):
        return [torch.as_tensor(
            rng.standard_normal((nb, n, n)) + (n * np.eye(n) if c == 0
                                               else 0.0))
            for c in range(planes)]

    def emit(name, shape, ms):
        print(json.dumps({"root": root, "kernel": name, "shape": shape,
                          "ms": ms}), flush=True)

    Ar, Ai = dominant(2048 * 51, 64, 2)
    br, bi = (torch.as_tensor(rng.standard_normal((2048 * 51, 64)))
              for _ in range(2))
    A64 = dominant(901, 64, 2)
    for dtype in (torch.float64,):
        planes = [p.to(dtype=dtype, device=dev) for p in A64]
        emit(gj.K4[dtype].name, [901, 64], cuda_ms(
            lambda: gj.gj_inverse_planes_cuda(*planes), args.reps))
        del planes
    A6 = dominant(100_000, 6, 1)[0]
    b6 = torch.as_tensor(rng.standard_normal((100_000, 6)))
    ckt = st.parse_netlist(RC_NET)
    t = st.build_tensors(ckt)
    B = 1_000_000
    over = {"r1": 30.0 * (1 + 0.2 * rng.random(B)),
            "c1": 100e-6 * (1 + 0.2 * rng.random(B))}
    freqs64 = tac.build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1,
                                        ckt.ac.f2)
    node = [nm.upper() for nm in t.node_names].index("2")
    for dtype in (torch.float64, torch.float32):
        planes = [p.to(dtype=dtype, device=dev) for p in (Ar, Ai, br, bi)]
        emit(gj.K1[dtype].name, [2048 * 51, 64], cuda_ms(
            lambda: gj.gj_solve_planes_cuda(*planes), args.reps))
        del planes
        A, b = (p.to(dtype=dtype, device=dev) for p in (A6, b6))
        emit(gj_real.K2[dtype].name, [100_000, 6], cuda_ms(
            lambda: gj_real.gj_solve_cuda(A, b), args.reps))

        def vals(base, names):
            return torch.as_tensor(tbatch._batch_values(base, names, over, B),
                                   dtype=dtype, device=dev)

        ph = np.deg2rad(t.v_ac_phase_deg)
        values = mc_ac_fused.combine_values(
            vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
            vals(t.l_vals, t.l_names),
            torch.as_tensor(t.v_ac_mag * np.cos(ph), dtype=dtype,
                            device=dev).expand(B, -1),
            torch.as_tensor(t.v_ac_mag * np.sin(ph), dtype=dtype,
                            device=dev).expand(B, -1), dtype=dtype)
        packed = mc_ac_fused.pack_pattern(mc_ac_fused.build_stamp_pattern(
            t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx), t.nvar, dev)
        freqs = torch.as_tensor(freqs64, dtype=dtype, device=dev)
        emit(mc_ac_fused.K5[dtype].name, [B, len(freqs64)], cuda_ms(
            lambda: mc_ac_fused.mc_ac_fused_cuda(freqs, values, packed,
                                                 node), max(args.reps // 4,
                                                            1)))
        del values
        torch.cuda.empty_cache()
    lad = st.parse_netlist(rc_ladder_netlist(14, 201))
    lt = st.build_tensors(lad)
    B16 = 16_384
    over16 = {nm: v * rng.uniform(0.9, 1.1, B16) for nm, v in
              zip(lt.r_names + lt.c_names,
                  np.concatenate([lt.r_vals, lt.c_vals]))}
    for dtype in (torch.float64, torch.float32):
        def vals16(base, names):
            return torch.as_tensor(tbatch._batch_values(base, names, over16,
                                                        B16),
                                   dtype=dtype, device=dev)

        ph = np.deg2rad(lt.v_ac_phase_deg)
        values = mc_ac_fused.combine_values(
            vals16(lt.r_vals, lt.r_names), vals16(lt.c_vals, lt.c_names),
            vals16(lt.l_vals, lt.l_names),
            torch.as_tensor(lt.v_ac_mag * np.cos(ph), dtype=dtype,
                            device=dev).expand(B16, -1),
            torch.as_tensor(lt.v_ac_mag * np.sin(ph), dtype=dtype,
                            device=dev).expand(B16, -1), dtype=dtype)
        packed = mc_ac_fused.pack_pattern(mc_ac_fused.build_stamp_pattern(
            lt.nvar, lt.r_idx, lt.c_idx, lt.l_idx, lt.v_idx), lt.nvar, dev)
        freqs = torch.as_tensor(tac.build_frequency_array(
            lad.ac.mode, lad.ac.N, lad.ac.f1, lad.ac.f2), dtype=dtype,
            device=dev)
        emit(mc_ac_fused.K7[dtype].name, [B16, freqs.shape[0], lt.nvar],
             cuda_ms(lambda: mc_ac_fused.mc_ac_fused_x_cuda(
                 freqs, values, packed), max(args.reps // 4, 1)))
        del values
        torch.cuda.empty_cache()
    # K8 and K9: the fused transients' wrappers, the tree's chosen form
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    from profile_torch_k9 import fused_inputs
    from spicey_tpu_torch.decks import (BJT_NET, BOOST_FINE, BOOST_NET,
                                        RING_NET, TRAN_NET)
    from spicey_tpu_torch.ops import mc_tran_fused as mtf
    B = 100_000
    boost = {"RR1": 1e3 * (1 + 0.1 * rng.random(B))}
    ring = {"c1": 1e-9 * (1 + 0.1 * rng.random(B)),
            "c2": 1e-9 * (1 + 0.1 * rng.random(B))}
    fused = {
        "tran-1M": (TRAN_NET, "2", {
            "R1": 1e3 * (1 + 0.2 * rng.random(1_000_000)),
            "C1": 1e-6 * (1 + 0.2 * rng.random(1_000_000))}, "spicey"),
        "boost-100k": (BOOST_NET, "N3", boost, "spicey"),
        "boost-10us-100k": (BOOST_FINE, "N3", boost, "spicey"),
        "ring-100k": (RING_NET, "n1", ring, "extended"),
        "ring-4096": (RING_NET, "n1", {k: v[:4096] for k, v in ring.items()},
                      "extended"),
        "bjt-100k": (BJT_NET, "c1",
                     {"Q1": 1e-15 * (1 + 0.2 * rng.random(B))}, "extended"),
    }
    for label, (net, node, over, dialect) in fused.items():
        nb = len(next(iter(over.values())))
        vs, values, pattern, node_idx, kw = fused_inputs(
            st, net, node, over, nb, dialect, dev)
        if kw is None:
            name = mtf.K8[torch.float32].name
            ms = cuda_ms(lambda: mtf.mc_tran_fused_cuda(
                vs, values, pattern, node_idx), max(args.reps // 4, 1))
        else:
            name = mtf.K9[torch.float32].name
            ms = cuda_ms(lambda: mtf.mc_tran_fused_nr_cuda(
                vs, values, pattern, node_idx, **kw), max(args.reps // 4, 1))
        emit(name, [label, nb, vs.shape[0]], ms)
        del values
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
