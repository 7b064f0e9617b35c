"""Where K9 and K8, the fused Monte-Carlo transients, spend their time.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k9.py
[--root DIR] [--forms-only] [--check] [--reps 5] [--seed 0] [--out
build/profile_torch_k9.json]``. Imports nothing of JAX.

``--root`` names the checkout whose ``spicey_tpu_torch`` is imported
(default: this one), so that two trees can be timed on one card in one
call; a tree whose K8 and K9 have no forms (one kernel each, the system
in shared memory) is timed as the form "shared". The shapes, inputs made
from ``--seed`` with numpy, the decks ``spicey_tpu_torch/decks.py``'s:

  K9  boost-100k (the switch-diode boost, RR1 at U(1, 1.1) x 1k, 101
      points), boost-10us-100k (the same on DIODE_SWITCH's 10 us grid,
      1001 points), ring-100k and ring-4096 (the bench's MOSFET ring, c1
      and c2 at U(1, 1.1) x 1 nF, Newton to convergence), bjt-100k
      (BJT_NET, Q1's Is at U(1, 1.2) x 1e-15, 201 points);
  K8  tran-1M (the RC pulse deck, R1 and C1 at U(1, 1.2) x nominal, 201
      points);
  N   the crossover of the forms: an RC ladder of k sections under a
      pulse (N = k + 2), 65,536 variants, every R at U(1, 1.2) x 1k, with
      a diode to ground at its end for K9 (N = 3-10) and without for K8
      (N = 3-10).

At each it times (CUDA events, mean of ``--reps`` after a warm launch)
every form that takes N through the wrapper, and prints the launch plan
(threads a block, blocks, resident blocks per SM, waves). ``--check``
first holds every form to the plain version at the K9 and K8 shapes
(K9: ``valid`` identical and each lane within 1e-4 x max|V|, otherwise
mean/min/max within 2e-4; K8: ``valid`` identical, rtol 1e-5), says
whether the two forms agree bit for bit, and holds
``gj_common.cuh:divide`` to the compiler's IEEE division bit for bit on
3 x 2^24 operand pairs (every bit pattern; random significands; divisors
at the edges of its range). Unless
``--forms-only``, it also writes variants of this tree's
``csrc/mc_tran_nr.cu`` and ``csrc/mc_tran_fused.cu`` into
``build/profile_torch_k9/``, each changed in one place, builds them with
nvcc in parallel and times the register form in each (K9 at boost-100k,
ring-100k and bjt-100k, K8 at tran-1M):

  source           the kernels as they are;
  lin in smem      K9's state-independent part kept in its own region of
                   shared memory and copied from there on every pass (the
                   source keeps it in registers);
  params in smem   K9's value rows copied once into the thread's region
                   of shared memory and read there (the source reads
                   them through the read-only cache, __ldg);
  elimination only K9 without its device stamps and evaluations: each
                   pass copies, loads and eliminates the
                   state-independent part (the exit and the pass counts
                   stay at boost-100k, where no switch changes state
                   within a step);
  128 registers    K9 under __launch_bounds__(256, 2): at most 128
                   registers a thread (more resident warps, perhaps
                   spills);
  fast division    a diagnosis, not a candidate: reg_gj_real's pivot-row
                   division by __fdividef (approximate), to show what the
                   exact quotient (gj_common.cuh:divide) costs;
  phase clocks     K9 with clock64() read around each pass's copy and
                   stamps and its load, elimination and commit: the mean
                   cycles per variant of each and of the whole kernel
                   (the SM's clock, so a phase counts the time its warp
                   waits behind others);
  rhs in registers K8's RHS built in registers, a select per row and
                   term, and x's elements picked by selects for the
                   output and the state update (the source builds the
                   RHS at its run-time rows in shared memory, loads it
                   into registers for the product and writes x back);
  grid staged      K8's (S+1, n_src) source grid copied into shared memory
                   once per block (a barrier) and read there (the source
                   reads it as a broadcast through L1);

then the source at every block size of ``BLOCK_SIZES`` beside the plan's,
and prints the registers, stack and local memory and the SASS
instructions by opcode (with the calls and the local loads and stores)
of K9's register instances at N = 5 and 6 and its shared form, and K8's
register instance at N = 3 and its shared form
(``cuobjdump``). Then the card's nvidia-smi name and power limit. Every
line also goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "build" / "profile_torch_k9"


def ladder_net(k: int, diode: bool) -> str:
    """An RC ladder of k sections under a pulse, with a diode to ground at
    its end: k + 2 unknowns (k + 1 nodes and the source's branch)."""
    lines = ["an RC ladder" + (" with a diode" if diode else ""),
             ".MODEL D D", "V1 1 0 PULSE(0 5 0 1n 1n 5u 10u)"]
    for i in range(1, k + 1):
        lines += [f"R{i} {i} {i + 1} 1k", f"C{i} {i + 1} 0 1n"]
    if diode:
        lines.append(f"DD1 {k + 1} 0 D")
    return "\n".join(lines + [".tran 0.1u 20u", ".end", ""])


def fused_inputs(st, net: str, node: str, over: dict, B: int,
                 dialect: str, dev: torch.device) -> tuple:
    """The fused kernels' inputs as the main path forms them
    (``analysis/mc.py``): the (S+1, nSrc) source grid, the f32 value
    slab, the packed pattern, the node's index and, for a nonlinear deck,
    K9's Newton settings (None for a linear one)."""
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.analysis import mc as tmc
    from spicey_tpu_torch.ir.circuit import (effective_time_step,
                                             sample_source_values)
    ckt = st.parse_netlist(net, dialect=dialect)
    t = st.build_tensors(ckt)
    dt, steps = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    f32 = torch.float32
    vs = torch.as_tensor(sample_source_values(ckt, np.arange(steps + 1) * dt),
                         dtype=f32, device=dev)

    def vals(base, names):
        return torch.as_tensor(tbatch._batch_values(base, names, over, B),
                               dtype=f32, device=dev)

    values = tmc.tran_value_slab(
        t, vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names), tbatch._batched_ext(t, over, B, dev, f32),
        tbatch._batched_nl(t, over, B, dev, f32), dt)
    pattern = tmc._fused_tran_pattern(ckt, t, "pallas", "f32", "be", False,
                                      dev)
    node_idx = [n.upper() for n in t.node_names].index(node.upper())
    kw = None
    if pattern.nonlinear:
        nr, max_nr = tmc._nr_mode(t)
        kw = dict(vd_scale=float(t.vt) / st.VT_300K, nr=nr, max_nr=max_nr)
    return vs, values, pattern, node_idx, kw


def shapes(st, rng: np.random.Generator, dev: torch.device) -> dict:
    """name -> (kernel, a function making the shape's inputs)."""
    from spicey_tpu_torch.decks import (BJT_NET, BOOST_FINE, BOOST_NET,
                                        RING_NET, TRAN_NET)
    B = 100_000
    boost = {"RR1": 1e3 * (1 + 0.1 * rng.random(B))}
    ring = {"c1": 1e-9 * (1 + 0.1 * rng.random(B)),
            "c2": 1e-9 * (1 + 0.1 * rng.random(B))}
    bjt = {"Q1": 1e-15 * (1 + 0.2 * rng.random(B))}
    big = 1_000_000
    tran = {"R1": 1e3 * (1 + 0.2 * rng.random(big)),
            "C1": 1e-6 * (1 + 0.2 * rng.random(big))}
    out = {
        "boost-100k": ("K9", lambda: fused_inputs(
            st, BOOST_NET, "N3", boost, B, "spicey", dev)),
        "boost-10us-100k": ("K9", lambda: fused_inputs(
            st, BOOST_FINE, "N3", boost, B, "spicey", dev)),
        "ring-100k": ("K9", lambda: fused_inputs(
            st, RING_NET, "n1", ring, B, "extended", dev)),
        "ring-4096": ("K9", lambda: fused_inputs(
            st, RING_NET, "n1", {k: v[:4096] for k, v in ring.items()},
            4096, "extended", dev)),
        "bjt-100k": ("K9", lambda: fused_inputs(
            st, BJT_NET, "c1", bjt, B, "extended", dev)),
        "tran-1M": ("K8", lambda: fused_inputs(
            st, TRAN_NET, "2", tran, big, "spicey", dev)),
    }
    nb = 65_536
    for k in range(1, 9):
        over = {f"R{i}": 1e3 * (1 + 0.2 * rng.random(nb))
                for i in range(1, k + 1)}
        for kern, diode in (("K9", True), ("K8", False)):
            out[f"ladder N={k + 2} {kern}"] = (kern, (
                lambda k=k, over=over, diode=diode: fused_inputs(
                    st, ladder_net(k, diode), str(k + 1), over, nb,
                    "spicey", dev)))
    return out


DIVIDE_CHECK = r"""
#include <cuda_runtime.h>
#include "gj_common.cuh"
__global__ void divide_check_kernel(const float* x, const float* d,
                                    unsigned* bad, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = gj::divide(x[i], gj::divisor(d[i])), b = x[i] / d[i];
  if (__float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b))
    atomicAdd(bad, 1u);
}
extern "C" int divide_check(const void* x, const void* d, void* bad, int n) {
  divide_check_kernel<<<(n + 255) / 256, 256>>>(
      (const float*)x, (const float*)d, (unsigned*)bad, n);
  return (int)cudaGetLastError();
}
"""


def divide_mismatches(nvcc: str, flags: tuple, csrc: Path, seed: int,
                      dev: torch.device) -> dict:
    """gj_common.cuh:divide against the compiler's IEEE division, bit for
    bit (two NaNs agree), on 2^24 pairs each of: every float bit pattern
    for both operands (NaN, inf, subnormals included); significands at
    random with exponents in [-40, 40]; and divisors at the edges of
    divide()'s range (2^-121..2^-119, 2^119..2^121)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, lib = BUILD / "divide_check.cu", BUILD / "libdivide_check.so"
    cu.write_text(DIVIDE_CHECK)
    subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(lib), str(cu)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).divide_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(seed)
    n = 1 << 24

    def floats(bits):
        return torch.as_tensor(bits.astype(np.uint32).view(np.float32),
                               device=dev)

    def normal(lo, hi):
        mant = rng.integers(0, 1 << 23, n, dtype=np.uint64)
        exp = rng.integers(lo + 127, hi + 128, n, dtype=np.uint64)
        sign = rng.integers(0, 2, n, dtype=np.uint64) << 31
        return sign | (exp << 23) | mant

    sets = {
        "all bit patterns": (rng.integers(0, 1 << 32, n, dtype=np.uint64),
                             rng.integers(0, 1 << 32, n, dtype=np.uint64)),
        "exponents in [-40, 40]": (normal(-40, 40), normal(-40, 40)),
        "divisors at the range's edges": (
            normal(-40, 40),
            np.where(rng.random(n) < 0.5, normal(-121, -119),
                     normal(119, 121))),
    }
    out = {}
    for label, (xb, db) in sets.items():
        bad = torch.zeros((1,), dtype=torch.int32, device=dev)
        x, d = floats(xb), floats(db)
        code = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(d.data_ptr()),
                  ctypes.c_void_p(bad.data_ptr()), n)
        if code != 0:
            raise RuntimeError(f"divide_check: CUDA error {code}")
        out[label] = int(bad.item())
    return out


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


def k9_agrees(out, v, pout, pv, what: str) -> dict:
    """``chip_smoke.py``'s rule for K9 against its plain version."""
    if not torch.equal(v, pv):
        raise AssertionError(f"{what}: valid flags differ")
    scale = float(pout[pv].abs().max())
    lane_err = (out[pv] - pout[pv]).abs().amax(dim=1)
    beyond = int((lane_err > 1e-4 * scale).sum())
    if beyond:
        for f in (torch.mean, torch.amin, torch.amax):
            a, b = f(out[pv], dim=0).double(), f(pout[pv], dim=0).double()
            lim = 2e-4 * (b.abs() + b.abs().max())
            if bool(((a - b).abs() > lim).any()):
                raise AssertionError(f"{what}: {f.__name__} beyond 2e-4")
    return {"max_abs_err": float(lane_err.max()), "lanes_beyond": beyond,
            "n_valid": int(pv.sum())}


# ---- variants of this tree's kernels, each changed in one place ----------

K9_LIN_REGION = ("  return (form == FORM_SHARED ? (size_t)n * n : 0) + "
                 "(size_t)n * (n + 1) +")
K9_AB = "  L.ab = P + (N > 0 ? 0 : n * n) * LANES;"
K9_LIN_LOAD = """    assemble_lin(L, L.ab);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) lin[i][j] = L.at(L.ab, i * N + j);"""
K9_LIN_COPY = ("          for (int j = 0; j < N; ++j) "
               "L.at(L.ab, i * w + j) = lin[i][j];")
K9_VAL = "    return __ldg(d.values + (size_t)row * d.B + b);"
K9_LANE = "  float *ab, *x, *blin, *dterm;"
K9_STATE = "  const State S = carve_state(d, L.dterm + n * LANES);"
K9_FLOATS = "      d.n_m, d.n_q, d.has_dchg, d.has_qchg);"
K9_SMEM = """  const size_t smem = (size_t)warp_slots(tpb) *
                      mc_tran_nr_bytes_per_variant(form, n, n_c, n_l, n_s,
                                                   n_d, n_m, n_q, has_dchg,
                                                   has_qchg);"""
K9_STAMPS = "      stamp_devices(L, S, it, inv_dt);\n"
K9_PASS = "    for (int it = 0; it < d.max_nr; ++it) {\n"
K9_VNR = "      vnr = vnr && ok;\n"
K9_EXIT = ("  if (b >= d.B) return;  // no barrier below: each thread owns "
           "its variant\n")
K9_END = "  d.valid[b] = valid_acc ? 1 : 0;\n}"
K9_KERNEL = "template <int N>\n__global__ void mc_tran_nr_kernel(const Deck d) {"
K8_HEAD = """  if (b >= B) return;  // no barrier below: each thread owns its variant
  // the variant's region, element q at P[q * LANES] (region_floats'
  // order): A's planes (N * 2N, read once, then x), rhs (N), gc, v_prev"""
K8_VS = "    const float* vs_s = vs + (size_t)s * n_src;"
K8_SMEM = """  const size_t smem = (size_t)warp_slots(tpb) *
                      mc_tran_fused_bytes_per_variant(form, n, n_c, n_l);"""
K8_STEP = re.compile(
    r"(    // the RHS at its run-time rows: sources.*?)(\n  }\n}\n)", re.S)
K8_STEP_REG = """    // the RHS in registers, a select per row and term
    float r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = 0.0f;
    const float* vs_s = vs + (size_t)s * n_src;
    for (int q = 0; q < n_bsrc; ++q) {
      const int row = bsrc[3 * q];
      const float tv = vs_s[bsrc[3 * q + 1]] * (float)bsrc[3 * q + 2];
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = row == i ? r[i] + tv : r[i];
    }
    for (int k = 0; k < n_c; ++k) {
      const int i1 = cst[3 * k], i2 = cst[3 * k + 1];
      const float tv = gc[k * LANES] * vp[k * LANES];
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = i1 == i ? r[i] + tv : r[i];
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = i2 == i ? r[i] - tv : r[i];
    }
    for (int k = 0; k < n_l; ++k) {
      const int i1 = lst[3 * k], i2 = lst[3 * k + 1];
      const float il = ip[k * LANES];
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = i1 == i ? r[i] - il : r[i];
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = i2 == i ? r[i] + il : r[i];
    }
    float xr[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if ((b_rows >> j) & 1u) acc = acc + inv[i][j] * r[j];
      xr[i] = acc;
    }
    auto pick = [&](int i) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (i == j) v = xr[j];
      return v;
    };
    out[(size_t)s * B + b] = pick(node_idx);
    for (int k = 0; k < n_c; ++k)
      vp[k * LANES] = pick(cst[3 * k]) - pick(cst[3 * k + 1]);
    for (int k = 0; k < n_l; ++k) {
      const float dv = pick(lst[3 * k]) - pick(lst[3 * k + 1]);
      ip[k * LANES] = ip[k * LANES] + gl[k * LANES] * dv;
    }"""


def k8_variants(src: str) -> dict[str, str]:
    for piece in (K8_HEAD, K8_SMEM):
        if src.count(piece) != 1:
            raise RuntimeError(f"mc_tran_fused.cu has no single {piece!r}")
    if src.count(K8_VS) != 2 or not K8_STEP.search(src):
        raise RuntimeError("mc_tran_fused.cu: no register step body")
    # the register form's grid read is the second
    head, reg = src.rsplit(K8_VS, 1)
    staged = (head + "    const float* vs_s = grid + (size_t)s * n_src;"
              + reg)
    return {
        "source": src,
        "rhs in registers": K8_STEP.sub(
            lambda m: K8_STEP_REG + m.group(2), src, count=1),
        "grid staged": staged.replace(K8_HEAD, """\
  extern __shared__ unsigned char smem_raw[];
  float* grid = reinterpret_cast<float*>(smem_raw) +
                warp_slots(blockDim.x) *
                    (int)region_floats(FORM_REGISTER, N, n_c, n_l);
  for (int q = threadIdx.x; q < n_steps * n_src; q += blockDim.x)
    grid[q] = vs[q];
  __syncthreads();
""" + K8_HEAD).replace(
            K8_SMEM, K8_SMEM[:-1] + " +\n      (form == FORM_REGISTER ? "
            "(size_t)n_steps * n_src * sizeof(float) : 0);"),
    }


K9_DIVIDE = "      for (int j = k + 1; j < W; ++j) q[j] = divide(q[j], dv);"


def k9_variants(src: str, header: str) -> dict[str, str]:
    if header.count(K9_DIVIDE) != 1:
        raise RuntimeError("gj_common.cuh has no single pivot-row division")
    for piece in (K9_LIN_REGION, K9_AB, K9_LIN_LOAD, K9_LIN_COPY, K9_VAL,
                  K9_LANE, K9_STATE, K9_SMEM, K9_STAMPS, K9_KERNEL,
                  K9_FLOATS, K9_PASS, K9_VNR, K9_EXIT, K9_END):
        if src.count(piece) != 1:
            raise RuntimeError(f"mc_tran_nr.cu has no single {piece!r}")
    return {
        "source": src,
        "lin in smem": src.replace(
            K9_LIN_REGION, "  return (size_t)n * n + (size_t)n * (n + 1) +")
        .replace(K9_AB, "  L.ab = P + n * n * LANES;")
        .replace(K9_LIN_LOAD, "    assemble_lin(L, lin_s);")
        .replace(K9_LIN_COPY, "          for (int j = 0; j < N; ++j) "
                 "L.at(L.ab, i * w + j) = L.at(lin_s, i * N + j);"),
        "params in smem": src.replace(
            K9_LANE, K9_LANE + "\n  float* prm;")
        .replace(K9_VAL, "    return prm[row * LANES];")
        .replace(K9_FLOATS, K9_FLOATS[:-2] + ") + d.n_rows;")
        .replace(K9_STATE, K9_STATE + """
  L.prm = S.vp + S.floats * LANES;
  for (int r = 0; r < d.n_rows; ++r)
    L.prm[r * LANES] = __ldg(d.values + (size_t)r * d.B + b);""")
        .replace(K9_SMEM, K9_SMEM[:-1] + " + (size_t)warp_slots(tpb) * "
                 "n_rows * sizeof(float);"),
        "elimination only": src.replace(K9_STAMPS, ""),
        # a diagnosis, not a candidate (not IEEE division): the header
        # inlined with reg_gj_real's pivot-row division by __fdividef
        "fast division": src.replace(
            '#include "gj_common.cuh"', header.replace(
                "#pragma once\n", "").replace(
                K9_DIVIDE, K9_DIVIDE.replace("divide(q[j], dv)",
                                             "__fdividef(q[j], d)"))),
        "128 registers": src.replace(K9_KERNEL, K9_KERNEL.replace(
            "void mc_tran_nr_kernel", "void __launch_bounds__(256, 2) "
            "mc_tran_nr_kernel")),
        # clock64() around each pass's copy + stamps and its load +
        # elimination + commit; out rows 0-2 of each variant carry the
        # cycles of the two and of the whole kernel
        "phase clocks": src.replace(
            K9_EXIT, K9_EXIT + "  long long t_stamp = 0, t_elim = 0, "
            "t_all = clock64();\n")
        .replace(K9_PASS, K9_PASS + "      const long long c0 = clock64();\n")
        .replace(K9_STAMPS, K9_STAMPS + "      const long long c1 = "
                 "clock64();\n")
        .replace(K9_VNR, "      t_stamp += c1 - c0;\n      t_elim += "
                 "clock64() - c1;\n" + K9_VNR)
        .replace(K9_END, """  d.valid[b] = valid_acc ? 1 : 0;
  d.out[b] = (float)t_stamp;
  d.out[(size_t)d.B + b] = (float)t_elim;
  d.out[2 * (size_t)d.B + b] = (float)(clock64() - t_all);
}"""),
    }


def build(srcs: dict[str, str], stem: str, nvcc: str, flags: tuple,
          csrc: Path) -> dict[str, tuple]:
    """Start one nvcc per variant; returns name -> (library, process)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, (name, src) in enumerate(srcs.items()):
        cu = BUILD / f"{stem}_{k}.cu"
        cu.write_text(src)
        lib = BUILD / f"lib{stem}_{k}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-I", str(csrc), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return jobs


def finish(jobs: dict) -> dict[str, Path]:
    libs = {}
    for name, (lib, proc) in jobs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        libs[name] = lib
    return libs


# (kernel regex in a mangled name, label)
INSTANCES = ((r"mc_tran_nr_kernelILi5E", "K9 register N=5"),
             (r"mc_tran_nr_kernelILi6E", "K9 register N=6"),
             (r"mc_tran_nr_kernelILi0E", "K9 shared"),
             (r"mc_tran_fused_reg_kernelILi3E", "K8 register N=3"),
             (r"mc_tran_fused_shared_kernel", "K8 shared"))


def resources(libs: list[Path], nvcc: str) -> dict:
    """Registers, stack, local memory and SASS opcodes of INSTANCES."""
    tool = str(Path(nvcc).parent / "cuobjdump")
    out: dict = {}
    for lib in libs:
        dump = subprocess.run([tool, "--dump-resource-usage", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for pat, label in INSTANCES:
            for line, res in zip(dump, dump[1:]):
                if re.search(pat, line):
                    out.setdefault(label, {}).update(
                        {k: int(v) for k, v in
                         re.findall(r"(REG|STACK|LOCAL):(\d+)", res)})
            for part in sass.split("Function : ")[1:]:
                if not re.match(r"\S*" + pat, part):
                    continue
                counts: dict[str, int] = {}
                for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                     r"([A-Z][A-Z0-9_]*)", part):
                    counts[op] = counts.get(op, 0) + 1
                out.setdefault(label, {})["sass"] = {
                    "total": sum(counts.values()),
                    **{op: counts.get(op, 0) for op in ("CALL", "STL", "LDL")},
                    **dict(sorted(counts.items(), key=lambda kv: -kv[1])[:12])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--forms-only", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_torch_k9.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k9: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import spicey_tpu_torch as st
    from spicey_tpu_torch.constants import EPS
    from spicey_tpu_torch.ops import _build
    from spicey_tpu_torch.ops import mc_tran_fused as mtf
    from spicey_tpu_torch.ops._build import ptr, stream_ptr
    if not Path(st.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {st.__file__}, not from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    records = []

    def emit(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    forms = getattr(mtf, "FORMS", None)
    csrc = root / "spicey_tpu_torch" / "csrc"
    jobs = {}
    if forms is not None and not args.forms_only:
        # the variants build while the forms are timed
        flags = _build.NVCC_FLAGS
        jobs["K9"] = build(k9_variants(
            (csrc / "mc_tran_nr.cu").read_text(),
            (csrc / "gj_common.cuh").read_text()), "k9", _build._nvcc(),
            flags, csrc)
        jobs["K8"] = build(k8_variants(
            (csrc / "mc_tran_fused.cu").read_text()), "k8", _build._nvcc(),
            flags, csrc)
    t0 = time.perf_counter()
    _build.build(["mc_tran_fused", "mc_tran_nr"])
    mtf.load_library()
    mtf.load_nr_library()
    emit({"root": str(root), "forms": forms or ["shared"],
          "built_s": round(time.perf_counter() - t0, 1)})
    if forms is not None:
        emit({"resources": resources(
            [_build._target(n)[1] for n in ("mc_tran_nr", "mc_tran_fused")],
            _build._nvcc())})

    def run(kern, inputs, form):
        vs, values, pattern, node_idx, kw = inputs
        extra = {} if form is None else {"form": form}
        if kern == "K9":
            return mtf.mc_tran_fused_nr_cuda(vs, values, pattern, node_idx,
                                             **kw, **extra)
        return mtf.mc_tran_fused_cuda(vs, values, pattern, node_idx,
                                      **extra)

    def forms_of(kern, n):
        if forms is None:
            return [None]
        return [f for f in forms
                if not (f == "register" and n > mtf.REG_MAX_N)]

    if args.check and forms is not None:
        mism = divide_mismatches(_build._nvcc(), _build.NVCC_FLAGS, csrc,
                                 args.seed, dev)
        emit({"check": "divide == IEEE division, pairs differing",
              **mism})
        if any(mism.values()):
            raise AssertionError(f"gj_common.cuh:divide differs: {mism}")
    made = shapes(st, rng, dev)
    kept = {}
    for label, (kern, make) in made.items():
        inputs = make()
        vs, values, pattern, node_idx, kw = inputs
        n, B = pattern.n, values.shape[1]
        if args.check and not label.startswith("ladder"):
            if kern == "K9":
                pout, pv = mtf.mc_tran_fused_nr_plain(vs, values, pattern,
                                                      node_idx, **kw)
            else:
                pout, pv = mtf.mc_tran_fused_plain(vs, values, pattern,
                                                   node_idx)
            outs = {}
            for form in forms_of(kern, n):
                out, v = run(kern, inputs, form)
                outs[form] = (out, v)
                if kern == "K9":
                    res = k9_agrees(out, v, pout, pv, f"{label} {form}")
                else:
                    if not torch.equal(v, pv):
                        raise AssertionError(f"{label} {form}: valid differ")
                    err = (out[pv] - pout[pv]).abs()
                    scale = float(pout[pv].abs().max())
                    if bool((err > 1e-5 * (pout[pv].abs() + scale)).any()):
                        raise AssertionError(f"{label} {form}: beyond 1e-5")
                    res = {"max_abs_err": float(err.max()),
                           "n_valid": int(pv.sum())}
                emit({"check": label, "form": form or "shared", **res})
            if len(outs) == 2:
                (o1, v1), (o2, v2) = outs.values()
                emit({"check": label, "forms_bitwise_equal": bool(
                    torch.equal(v1, v2) and torch.equal(o1[v1], o2[v2]))})
            del pout, pv, outs
        for form in forms_of(kern, n):
            rec = {"shape": label, "kernel": kern, "n": n, "B": B,
                   "steps": vs.shape[0], "form": form or "shared"}
            if forms is not None:
                plan = (mtf.k9_launch_plan if kern == "K9"
                        else mtf.k8_launch_plan)(values, pattern, form)
                rec.update(tpb=plan.tpb, blocks=plan.blocks,
                           resident=plan.resident,
                           waves=round(plan.waves, 3),
                           chosen=form == (mtf.k9_form_for(n) if kern == "K9"
                                           else mtf.k8_form_for(n)))
            rec["ms"] = cuda_ms(lambda: run(kern, inputs, form), args.reps)
            emit(rec)
        if label in ("boost-100k", "ring-100k", "bjt-100k", "tran-1M"):
            kept[label] = inputs
        else:
            del inputs
        torch.cuda.empty_cache()

    if jobs:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        t0 = time.perf_counter()
        libs = {kern: finish(j) for kern, j in jobs.items()}
        emit({"variants": {k: list(v) for k, v in libs.items()},
              "built_s": round(time.perf_counter() - t0, 1)})
        k9_fn = {}
        for name, path in libs["K9"].items():
            lib = ctypes.CDLL(str(path))
            fn = lib.mc_tran_nr_f32
            fn.argtypes, fn.restype = mtf._NR_ARGS, ctypes.c_int
            res = lib.mc_tran_nr_resident
            res.argtypes, res.restype = mtf._RESIDENT_ARGS
            byt = lib.mc_tran_nr_bytes_per_variant
            byt.argtypes, byt.restype = [ctypes.c_int] * 10, ctypes.c_size_t
            k9_fn[name] = (fn, res, byt)
        k8_fn = {}
        for name, path in libs["K8"].items():
            lib = ctypes.CDLL(str(path))
            fn = lib.mc_tran_fused_f32
            fn.argtypes, fn.restype = mtf._LAUNCH_ARGS, ctypes.c_int
            res = lib.mc_tran_fused_resident
            res.argtypes, res.restype = mtf._RESIDENT_ARGS
            byt = lib.mc_tran_fused_bytes_per_variant
            byt.argtypes, byt.restype = [ctypes.c_int] * 4, ctypes.c_size_t
            k8_fn[name] = (fn, res, byt)
        reg = mtf.FORMS.index("register")

        def plan_of(res, n, per, extra, B):
            resident = {}
            for tpb in mtf.BLOCK_SIZES:
                smem = mtf.warp_slots(tpb) * per + extra
                if smem <= _build.SMEM_MAX:
                    resident[tpb] = res(reg, n, tpb, smem)
            return mtf.launch_plan(B, n_sm, resident)

        for label in ("boost-100k", "ring-100k", "bjt-100k"):
            vs, values, pattern, node_idx, kw = kept[label]
            n, B, S1 = pattern.n, values.shape[1], vs.shape[0]
            counts = mtf.k9_counts(pattern)
            k = mtf.nr_constants(kw["vd_scale"])
            out = torch.empty((S1, B), dtype=torch.float32, device=dev)
            valid = torch.empty((B,), dtype=torch.bool, device=dev)
            want = mtf.mc_tran_fused_nr_cuda(vs, values, pattern, node_idx,
                                             **kw, form="register")[0]

            def launch(fn, tpb):
                n_c, n_l, n_s, n_d, n_m, n_q, has_d, has_q = counts
                code = fn(
                    ptr(vs), vs.shape[1], S1, ptr(values), pattern.n_rows, B,
                    ptr(pattern.ent), pattern.ent.shape[0],
                    ptr(pattern.terms), ptr(pattern.zeros),
                    pattern.zeros.shape[0], ptr(pattern.bsrc),
                    pattern.bsrc.shape[0], ptr(pattern.cst), n_c,
                    ptr(pattern.lst), n_l, ptr(pattern.slist), n_s,
                    ptr(pattern.dlist), n_d, ptr(pattern.mlist), n_m,
                    ptr(pattern.qlist), n_q, ptr(pattern.pol),
                    ptr(pattern.dchg), has_d, ptr(pattern.qchg), has_q,
                    pattern.row_invdt, n, node_idx, float(EPS), k["vd_lo"],
                    k["vd_hi"], k["vt_q"], k["q_lo"], k["q_hi"], k["tol"],
                    int(kw["nr"] == "converged"), int(kw["max_nr"]), reg,
                    tpb, ptr(out), ptr(valid), stream_ptr(dev))
                if code != 0:
                    raise RuntimeError(f"K9 variant: CUDA error {code}")

            for name, (fn, res, byt) in k9_fn.items():
                per = byt(reg, n, *counts)
                if name == "params in smem":
                    per += 4 * pattern.n_rows
                plan = plan_of(res, n, per, 0, B)
                rec = {"variant": name, "kernel": "K9", "shape": label,
                       "tpb": plan.tpb, "waves": round(plan.waves, 3),
                       "ms": cuda_ms(lambda: launch(fn, plan.tpb),
                                     args.reps)}
                if name == "phase clocks":
                    cyc = out[:3].double().mean(dim=1).tolist()
                    rec["cycles_per_variant"] = {
                        "copy+stamps": cyc[0], "load+eliminate+commit": cyc[1],
                        "kernel": cyc[2]}
                elif name != "elimination only":
                    rec["equals_wrapper"] = bool(torch.equal(out.T, want))
                emit(rec)
            fn, res, byt = k9_fn["source"]
            for tpb in mtf.BLOCK_SIZES:
                emit({"variant": "source", "kernel": "K9", "shape": label,
                      "tpb": tpb, "ms": cuda_ms(lambda: launch(fn, tpb),
                                                args.reps)})
            del out, valid, want
        vs, values, pattern, node_idx, _kw = kept["tran-1M"]
        n, B, S1 = pattern.n, values.shape[1], vs.shape[0]
        n_c, n_l = pattern.cst.shape[0], pattern.lst.shape[0]
        out = torch.empty((S1, B), dtype=torch.float32, device=dev)
        valid = torch.empty((B,), dtype=torch.bool, device=dev)
        want = mtf.mc_tran_fused_cuda(vs, values, pattern, node_idx,
                                      form="register")[0]

        def launch8(fn, tpb):
            code = fn(ptr(vs), vs.shape[1], S1, ptr(values), B,
                      ptr(pattern.ent), pattern.ent.shape[0],
                      ptr(pattern.terms), ptr(pattern.zeros),
                      pattern.zeros.shape[0], ptr(pattern.bsrc),
                      pattern.bsrc.shape[0], ptr(pattern.cst), n_c,
                      ptr(pattern.lst), n_l, pattern.b_rows, n, node_idx,
                      float(EPS), reg, tpb, ptr(out), ptr(valid),
                      stream_ptr(dev))
            if code != 0:
                raise RuntimeError(f"K8 variant: CUDA error {code}")

        for name, (fn, res, byt) in k8_fn.items():
            extra = 4 * S1 * vs.shape[1] if name == "grid staged" else 0
            plan = plan_of(res, n, byt(reg, n, n_c, n_l), extra, B)
            emit({"variant": name, "kernel": "K8", "shape": "tran-1M",
                  "tpb": plan.tpb, "waves": round(plan.waves, 3),
                  "ms": cuda_ms(lambda: launch8(fn, plan.tpb), args.reps),
                  "equals_wrapper": bool(torch.equal(out.T, want))})
        fn, res, byt = k8_fn["source"]
        for tpb in mtf.BLOCK_SIZES:
            emit({"variant": "source", "kernel": "K8", "shape": "tran-1M",
                  "tpb": tpb, "ms": cuda_ms(lambda: launch8(fn, tpb),
                                            args.reps)})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "records": records}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
