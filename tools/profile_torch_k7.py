"""Where K7, the fused full-solution AC kernel, spends its time.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k7.py
[--reps 5] [--out build/profile_torch_k7.json]``. Imports nothing of JAX.

It writes variants of ``spicey_tpu_torch/csrc/mc_ac_fused.cu`` into
``build/profile_torch_k7/``, each changed in one place, builds them with
nvcc in parallel and times each one's K7 launch (CUDA events, mean of
``--reps`` after a warm launch) at ``chip_smoke.py`` phase 18's shape,
batch-ac-16k (the N = 16 RC ladder, every R and C at U(0.9, 1.1) x
nominal, 16,384 variants x 201 frequencies, pattern RHS), in f64 and f32:

  source         the kernel as it is;
  shuffles       the pivot row handed to the group by shuffles of the
                 pivot lane's registers, every lane dividing every column
                 by the pivot, in place of the shared-memory slot;
  rolled steps   the pivot steps in a loop rather than unrolled: one copy
                 of the step body, column k picked by a select, the
                 columns left of k skipped by a uniform branch;
  slot-test asm  the first form of the row assembly: every one of the
                 2 (G + 1) slots tests the row's next entry, with the term
                 loop unrolled into each slot;
  no elimination the assembly and the output only;
  no assembly    zero rows (every system singular), the elimination and
                 the output only;
  fma update     each row update as two fused multiply-adds per part,
                 (a - er qr) + ei qi, another order of the same sums;
  key argmax     the group's argmax on an unsigned key in the score's
                 order (no row < used row < the bits of a score >= 0 <
                 NaN) and the row, in place of better() on the scores;
  maxnreg 96     the registers capped by __maxnreg__(96) in place of the
                 launch bounds;
  column tests   each column tested against N (j < N or the right-hand
                 side) before the pivot row's slot is written, divided or
                 read, rather than updating the zero columns N..G-1 too.

For each it prints the registers, stack and local memory of the f64 and
f32 G = 16 instances (``cuobjdump --dump-resource-usage``), their SASS
instructions by opcode (``cuobjdump -sass``; the steps and columns are
unrolled, so at N = 16 each runs once per warp), the times, and whether
the solutions equal the source's bit for bit; then the card's nvidia-smi
name and power limit. Every line also goes to ``--out``.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import spicey_tpu_torch as st  # noqa: E402
from spicey_tpu_torch.analysis import ac as tac  # noqa: E402
from spicey_tpu_torch.analysis import batch as tbatch  # noqa: E402
from spicey_tpu_torch.constants import EPS  # noqa: E402
from spicey_tpu_torch.decks import rc_ladder_netlist  # noqa: E402
from spicey_tpu_torch.ops import _build, mc_ac_fused  # noqa: E402
from spicey_tpu_torch.ops._build import ptr, stream_ptr  # noqa: E402

CSRC = ROOT / "spicey_tpu_torch" / "csrc"
BUILD = ROOT / "build" / "profile_torch_k7"

STEP = ("#pragma unroll\n  for (int k = 0; k < G; ++k) {\n"
        "    if (k >= n) break;  // n is the same for every lane of the "
        "launch\n    const T er = ar[k], ei = ai[k];\n")
ROLLED_STEP = ("  for (int k = 0; k < n; ++k) {\n    T er = ar[0], ei = ai[0];\n"
               "#pragma unroll\n    for (int j = 1; j < G; ++j)\n"
               "      if (j == k) {\n        er = ar[j];\n        ei = ai[j];\n"
               "      }\n")
SLOT_WRITE = "      for (int j = k; j <= G; ++j)\n"
ROLLED_SLOT_WRITE = "      for (int j = 0; j <= G; ++j)\n        if (j >= k)\n"
# (slot-broadcast code, its shuffle replacement)
SHUFFLES = [
    ("""    if (piv) {  // the raw pivot row into the group's slot
#pragma unroll
      for (int j = k; j <= G; ++j)
        slot[j] = P2{ar[j], ai[j]};
    }
    __syncwarp();
    const P2 pv = slot[k];
    const T pvr = pv.x, pvi = pv.y;
""", """    const T pvr = __shfl_sync(FULL, er, p, G);
    const T pvi = __shfl_sync(FULL, ei, p, G);
"""),
    ("""    // each column of the pivot row divided by the pivot once, by its lane
    if (own > k) {
      const P2 q = slot[own];
      slot[own] = P2{(q.x * pvr + q.y * pvi) * inv_d,
                     (q.y * pvr - q.x * pvi) * inv_d};
    }
    __syncwarp();
""", ""),
    ("""      const P2 q = slot[j];
""", """      const T qr = __shfl_sync(FULL, ar[j], p, G);
      const T qi = __shfl_sync(FULL, ai[j], p, G);
      const P2 q = P2{(qr * pvr + qi * pvi) * inv_d,
                      (qi * pvr - qr * pvi) * inv_d};
"""),
    ("""    __syncwarp();  // the slot is read before the next step writes it
""", "")]
COLUMNS = "    for (int j = k + 1; j <= G; ++j) {\n"
ROLLED_COLUMNS = "    for (int j = 1; j <= G; ++j) {\n      if (j <= k) continue;\n"
# (the source's untested column, its test against n)
COLUMN_TESTS = [
    ("        slot[j] = P2{ar[j], ai[j]};",
     "        if (j < n || j == G) slot[j] = P2{ar[j], ai[j]};"),
    ("    if (own > k) {", "    if (own > k && (own < n || own == G)) {"),
    (COLUMNS, COLUMNS + "      if (!(j < n || j == G)) continue;\n")]
ASSEMBLY_BODY = re.compile(
    r"(__device__ __forceinline__ void assemble_row\([^{]*\{\n).*?(\n}\n)",
    re.S)
SLOT_TEST_BODY = r"""  int e = row_ptr[c * (n + 1) + i];
  const int e1 = row_ptr[c * (n + 1) + i + 1];
#pragma unroll
  for (int j = 0; j <= G; ++j) {
    a[j] = T(0);
    if (j < n || j == G) {
      const int col = j == G ? n : j;
      if (e < e1 && row_ent[3 * e] == col) {
        const int t0 = row_ent[3 * e + 1], t1 = row_ent[3 * e + 2];
        T acc = T(0);
        for (int q = t0; q < t1; ++q) {
          const int kind = terms[3 * q], row = terms[3 * q + 1];
          const T v = __ldg(values + (size_t)row * B + b);
          const T tv = term_value<T>(kind, T(terms[3 * q + 2]), v, w, eps);
          acc = q == t0 ? tv : acc + tv;
        }
        a[j] = acc;
        ++e;
      }
    }
  }"""
ASSEMBLE_CALL = "  if (live && has_row) {\n    const T w ="
UPDATE = ("      const T nr = ar[j] - (er * q.x - ei * q.y);\n"
          "      const T ni = ai[j] - (er * q.y + ei * q.x);\n")
FMA_UPDATE = ("      const T nr = fma(ei, q.y, fma(-er, q.x, ar[j]));\n"
              "      const T ni = fma(-ei, q.x, fma(-er, q.y, ai[j]));\n")
ARGMAX = """    const T os = __shfl_xor_sync(0xffffffffu, best_s, off, G);
    const int orow = __shfl_xor_sync(0xffffffffu, best_r, off, G);
    if (gj::better(os, orow, best_s, best_r)) {
      best_s = os;
      best_r = orow;
    }
"""
KEY_ARGMAX = """    const auto okey = __shfl_xor_sync(0xffffffffu, key, off, G);
    const int orow = __shfl_xor_sync(0xffffffffu, best_r, off, G);
    if (okey > key || (okey == key && orow < best_r)) {
      key = okey;
      best_r = orow;
    }
"""
KEY_FN = """__device__ __forceinline__ unsigned long long pivot_key(double s) {
  return s != s ? ~0ull
         : s < 0.0 ? (unsigned long long)(s == -1.0)
                   : (unsigned long long)__double_as_longlong(s) + 2ull;
}
__device__ __forceinline__ unsigned pivot_key(float s) {
  return s != s ? ~0u : s < 0.f ? (unsigned)(s == -1.f)
                                : (unsigned)__float_as_uint(s) + 2u;
}

"""
PIVOT_HEAD = ("template <typename T, int G>\n__device__ __forceinline__ int "
              "group_pivot(T best_s, int best_r) {\n")
BOUNDS = "__launch_bounds__(K7_MAX_THREADS) mc_ac_fused_x_kernel("


def variants(src: str) -> dict[str, str]:
    for piece in (STEP, SLOT_WRITE, COLUMNS, ASSEMBLE_CALL, UPDATE, ARGMAX,
                  PIVOT_HEAD, BOUNDS, *(old for old, _new in SHUFFLES),
                  *(old for old, _new in COLUMN_TESTS)):
        if src.count(piece) != 1:
            raise RuntimeError(f"mc_ac_fused.cu has no single {piece!r}")
    if not ASSEMBLY_BODY.search(src):
        raise RuntimeError("mc_ac_fused.cu has no assemble_row body")
    shuffles, tested = src, src
    for old, new in SHUFFLES:
        shuffles = shuffles.replace(old, new)
    for old, new in COLUMN_TESTS:
        tested = tested.replace(old, new)
    return {
        "source": src,
        "shuffles": shuffles,
        "rolled steps": src.replace(STEP, ROLLED_STEP).replace(
            SLOT_WRITE, ROLLED_SLOT_WRITE).replace(COLUMNS, ROLLED_COLUMNS),
        "slot-test asm": ASSEMBLY_BODY.sub(
            lambda m: m.group(1) + SLOT_TEST_BODY + m.group(2), src, count=1),
        "no elimination": src.replace(
            STEP, STEP.replace("if (k >= n) break;", "if (k >= 0) break;")),
        "no assembly": src.replace(ASSEMBLE_CALL,
                                   ASSEMBLE_CALL.replace("live && has_row",
                                                         "false")),
        "fma update": src.replace(UPDATE, FMA_UPDATE),
        "key argmax": src.replace(ARGMAX, KEY_ARGMAX).replace(
            PIVOT_HEAD, KEY_FN + PIVOT_HEAD + "  auto key = pivot_key(best_s);\n"),
        "maxnreg 96": src.replace(BOUNDS, BOUNDS.replace(
            "__launch_bounds__(K7_MAX_THREADS)", "__maxnreg__(96)")),
        "column tests": tested,
    }


def build(srcs: dict[str, str]) -> dict[str, Path]:
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, (name, src) in enumerate(srcs.items()):
        cu = BUILD / f"k7_{k}.cu"
        cu.write_text(src)
        lib = BUILD / f"libk7_{k}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _out, err = proc.communicate()
        if proc.returncode == 0:
            libs[name] = lib
        elif name == "source":
            raise RuntimeError(f"nvcc failed on the source:\n{err}")
        else:  # a variant the compiler refuses is reported and skipped
            print(json.dumps({"variant": name, "nvcc_error": err[-2000:]}),
                  flush=True)
    return libs


def usage(lib: Path) -> dict[str, dict]:
    """REG/STACK/LOCAL of the G = 16, pattern-RHS instances by dtype."""
    dump = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"),
         "--dump-resource-usage", str(lib)], capture_output=True, text=True,
        check=True).stdout.splitlines()
    out = {}
    for line, res in zip(dump, dump[1:]):
        m = re.search(r"mc_ac_fused_x_kernelI([df])Li16ELb0E", line)
        if m:
            out[f"f{'64' if m.group(1) == 'd' else '32'}"] = {
                k: int(v) for k, v in
                re.findall(r"(REG|STACK|LOCAL):(\d+)", res)}
    return out


def opcodes(lib: Path) -> dict[str, dict]:
    """SASS instructions of the G = 16, pattern-RHS instances by opcode
    (the mnemonic before its first '.'), by dtype."""
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*mc_ac_fused_x_kernelI([df])Li16ELb0E", part)
        if not m:
            continue
        counts: dict[str, int] = {}
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", part):
            counts[op] = counts.get(op, 0) + 1
        out[f"f{'64' if m.group(1) == 'd' else '32'}"] = dict(
            sorted(counts.items(), key=lambda kv: -kv[1]))
    return out


def inputs(dtype: torch.dtype, dev: torch.device, seed: int = 0):
    """Phase 18's K7 inputs: (freqs, values, packed)."""
    rng = np.random.default_rng(seed)
    B = 16_384
    ckt = st.parse_netlist(rc_ladder_netlist(14, 201))
    t = st.build_tensors(ckt)
    over = {nm: v * rng.uniform(0.9, 1.1, B) for nm, v in
            zip(t.r_names + t.c_names,
                np.concatenate([t.r_vals, t.c_vals]))}

    def vals(base, names):
        return torch.as_tensor(tbatch._batch_values(base, names, over, B),
                               dtype=dtype, device=dev)

    ph = np.deg2rad(t.v_ac_phase_deg)
    zero = torch.zeros(0, dtype=dtype, device=dev)
    values = mc_ac_fused.combine_values(
        vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
        vals(t.l_vals, t.l_names),
        torch.as_tensor(t.v_ac_mag * np.cos(ph), dtype=dtype,
                        device=dev).expand(B, -1),
        torch.as_tensor(t.v_ac_mag * np.sin(ph), dtype=dtype,
                        device=dev).expand(B, -1),
        ext=tbatch._batched_ext(t, over, B, dev, dtype), i_re=zero,
        i_im=zero, dtype=dtype)
    freqs = torch.as_tensor(tac.build_frequency_array(
        ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2), dtype=dtype, device=dev)
    return freqs, values, tbatch._fused_pattern(ckt, t, "pallas", dev)


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
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/profile_torch_k7.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k7: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    srcs = variants((CSRC / "mc_ac_fused.cu").read_text())
    libs = build(srcs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    records = []

    def emit(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"built_s": round(time.perf_counter() - t0, 1),
          "variants": list(srcs)})
    for dtype in (torch.float64, torch.float32):
        freqs, values, packed = inputs(dtype, dev)
        F, B, n = freqs.shape[0], values.shape[1], packed.n
        ref = None
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            fn = lib.mc_ac_fused_x_f64 if dtype == torch.float64 \
                else lib.mc_ac_fused_x_f32
            fn.argtypes = mc_ac_fused._LAUNCH_X_ARGS
            fn.restype = ctypes.c_int
            xr = torch.empty((F, n, B), dtype=dtype, device=dev)
            xi = torch.empty_like(xr)
            valid = torch.empty((F, B), dtype=torch.bool, device=dev)
            def launch():
                code = fn(ptr(freqs), ptr(values), F, B, ptr(packed.row_ent),
                          ptr(packed.row_ptr), ptr(packed.terms), n,
                          mc_ac_fused.fused_group_for(n), float(EPS), None,
                          None, ptr(xr), ptr(xi), ptr(valid), stream_ptr(dev))
                if code != 0:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            ms = cuda_ms(launch, args.reps)
            if ref is None:
                ref = (xr.clone(), xi.clone())
            same = bool(torch.equal(xr, ref[0]) and torch.equal(xi, ref[1]))
            tag = "f64" if dtype == torch.float64 else "f32"
            res, ops = usage(path), opcodes(path).get(tag, {})
            emit({"variant": name, "dtype": tag, "shape": [B, F, n],
                  "ms": ms, "usage": res.get(tag), "valid": int(valid.sum()),
                  "equals_source": same,
                  "sass": {"total": sum(ops.values()), **ops}})
            del xr, xi, valid
            torch.cuda.empty_cache()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "records": records}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
