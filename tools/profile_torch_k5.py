"""Where K5, the fused Monte-Carlo AC yield solve, spends its time.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k5.py
[--root DIR] [--forms-only] [--reps 5] [--out build/profile_torch_k5.json]``.
Imports nothing of JAX.

``--root`` names the checkout whose ``spicey_tpu_torch`` is imported
(default: this one), so that two trees can be timed on one card in one
call; a tree whose K5 has no forms (the one-thread-per-system kernel with
its planes in shared memory) is timed as the form "shared". The shapes,
inputs made from ``--seed`` with numpy:

  yield-1M   the RC deck of ``chip_smoke.py`` phase 3 (N = 3), 1M variants
             x 201 frequencies, R and C at U(1, 1.2) x nominal;
  ladder-7   ``rc_ladder_netlist(5, 201)`` (N = 7), 262,144 variants x 201
             frequencies, every R and C at U(0.9, 1.1) x nominal;
  dense N    ``tests/fused_systems.py``'s dense random systems at N = 1-8,
             2^20 variants x its 3 frequencies: the crossover of the forms.

At each it times (CUDA events, mean of ``--reps`` after a warm launch) K5
in every form that takes N ("register" up to the largest register
instance, "group" with ``fused_group_for(N)`` lanes), through the wrapper.
Unless ``--forms-only``, it also writes variants of this tree's
``csrc/mc_ac_fused.cu`` into ``build/profile_torch_k5/``, each changed in
one place, builds them with nvcc in parallel and times the register form
at yield-1M and the group form at ladder-7 in each:

  source           the kernel as it is;
  one frequency per thread, 192 B per thread, 768 B per thread
                   the register form's frequencies per thread set by
                   another shared-memory budget per thread (the source's
                   is 384 B: 2 frequencies at N = 3 in f64, 4 in f32);
  entry walk       the register form's first assembly: a walk of the
                   entry table, each entry's terms read from the term
                   table, three dependent loads per entry (the source
                   walks one flat table of terms, one load per term);
  tables in smem   the register form's flat and zero tables copied into
                   shared memory once per block (a barrier), the assembly
                   reading them there instead of from global memory
                   (uniform loads through L1);
  assembly only    the elimination replaced by a sum of the registers;
  elimination only the assembly replaced by a system made from one value.

and prints the registers, stack and local memory and the SASS
instructions by opcode of the register instance at N = 3 and the group
instance at G = 8 (``cuobjdump``), in f64 and f32. Then the card's
nvidia-smi name and power limit. Every line also goes to ``--out``.
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
BUILD = HERE.parent / "build" / "profile_torch_k5"
RC_NET = ("AC bench\nv1 1 0 dc 0 ac 1\nr1 1 2 30\nc1 2 0 100u\n"
          ".ac dec 100 1 100\n.end\n")

# the register kernel's assembly and elimination, as the source has them
ASSEMBLE = """  if (b >= B) return;  // no barrier below: each thread owns its systems
  T* P = reinterpret_cast<T*>(smem_raw) + t;
  T w[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k)
    w[k] = T(6.283185307179586) * freqs[min(f0 + k, F - 1)];
  assemble<T, NF>(P, SYS, values, B, b, w, flat, n_flat, zeros, n_zero, eps);
"""
TABLES_SMEM = """  int4* tabs = reinterpret_cast<int4*>(reinterpret_cast<T*>(smem_raw) +
                                       NF * SYS);
  int* zs = reinterpret_cast<int*>(tabs + n_flat);
  for (int q = t; q < n_flat; q += REG_TPB) tabs[q] = flat[q];
  for (int q = t; q < n_zero; q += REG_TPB) zs[q] = zeros[q];
  __syncthreads();
  if (b >= B) return;
  T* P = reinterpret_cast<T*>(smem_raw) + t;
  T w[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k)
    w[k] = T(6.283185307179586) * freqs[min(f0 + k, F - 1)];
  assemble<T, NF>(P, SYS, values, B, b, w, tabs, n_flat, zs, n_zero, eps);
"""
NO_ASSEMBLY = """  if (b >= B) return;
  T* P = reinterpret_cast<T*>(smem_raw) + t;
"""
# the assembly's read-only loads, plain loads where the tables are on chip
LDG_FLAT, LDG_ZEROS = "__ldg(flat + q)", "__ldg(zeros + z)"
# the register form's first assembly: a walk of the entry table, each
# entry's terms read from the term table (three dependent loads per entry);
# the profile passes [ent | terms] as ``flat`` and n_ent as ``n_flat``
ASSEMBLY_BODY = re.compile(
    r"(__device__ __forceinline__ void assemble\([^{]*\{\n).*?(\n}\n)",
    re.S)
ENTRY_WALK_BODY = """  const int* ent = reinterpret_cast<const int*>(flat);
  const int* terms = ent + 3 * n_flat;
  for (int z = 0; z < n_zero; ++z)
    for (int k = 0; k < NF; ++k)
      P[k * sys + (size_t)zeros[z] * REG_TPB] = T(0);
  for (int e = 0; e < n_flat; ++e) {
    const int pos = ent[3 * e], t0 = ent[3 * e + 1], t1 = ent[3 * e + 2];
    T acc[NF];
    for (int q = t0; q < t1; ++q) {
      const int kind = terms[3 * q], row = terms[3 * q + 1];
      const T v = values[(size_t)row * B + b];
      T tv[NF];
      term_values<T, NF>(kind, T(terms[3 * q + 2]), v, w, eps, tv);
      for (int k = 0; k < NF; ++k) acc[k] = q == t0 ? tv[k] : acc[k] + tv[k];
    }
    for (int k = 0; k < NF; ++k) P[k * sys + (size_t)pos * REG_TPB] = acc[k];
  }"""
# the shared memory a thread's systems may take, which sets the
# frequencies per thread
NF_BUDGET = "constexpr int REG_SMEM_PER_THREAD = 384;"
REG_SMEM = ("  const size_t smem = (size_t)NF * 2 * N * (N + 1) * REG_TPB * "
            "sizeof(T);\n")
REG_SMEM_TABLES = ("  const size_t smem = (size_t)NF * 2 * N * (N + 1) * REG_TPB "
                   "* sizeof(T) + 4096 * sizeof(int);\n")
LOADS = """        ar[i][j] = S[(i * W + j) * REG_TPB];
        ai[i][j] = S[(N * W + i * W + j) * REG_TPB];
"""
SYNTHETIC = """        ar[i][j] = __ldg(values + b) * T(1 + (i * W + j + k) % 5) +
                   T(i == j ? 4 * N : 0);
        ai[i][j] = T(0.25) * ar[i][j];
"""
ELIMINATE = ("    const bool ok = reg_gj<T, N>(ar, ai, node_idx, eps2, xr, "
             "xi);\n")
SUM = """    xr = T(0);
    xi = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        xr += ar[i][j];
        xi += ai[i][j];
      }
    const bool ok = xr == xr;
"""
GROUP_ELIMINATE = """  const bool ok_all =
      group_gj<T, G>(ar, ai, i, n, has_row, slot, eps2, perm_k);
  const T x_r = __shfl_sync(FULL, ar[G], perm_k, G);
  const T x_i = __shfl_sync(FULL, ai[G], perm_k, G);
  if (live && i == node_idx) {"""
GROUP_SUM = """  T x_r = T(0), x_i = T(0);
#pragma unroll
  for (int j = 0; j <= G; ++j) {
    x_r += ar[j];
    x_i += ai[j];
  }
  const bool ok_all = x_r == x_r;
  perm_k = 0;
  if (live && i == node_idx) {"""
GROUP_ASSEMBLE = """  if (live && has_row) {
    const T w = T(6.283185307179586) * freqs[f];
    assemble_row<T, G>(ar, 0, i, n, values, B, b, w, row_ent, row_ptr,
                       terms, eps);
    assemble_row<T, G>(ai, 1, i, n, values, B, b, w, row_ent, row_ptr,
                       terms, eps);
  } else {
#pragma unroll
    for (int j = 0; j <= G; ++j) ar[j] = ai[j] = T(0);
  }
  int perm_k;
  const bool ok_all =
      group_gj<T, G>(ar, ai, i, n, has_row, slot, eps2, perm_k);"""
GROUP_SYNTHETIC = """  {
    const T v = live ? __ldg(values + b) : T(0);
#pragma unroll
    for (int j = 0; j <= G; ++j) {
      ar[j] = has_row ? v * T(1 + (i * (G + 1) + j) % 5) +
                            T(i == j ? 4 * G : 0)
                      : T(0);
      ai[j] = T(0.25) * ar[j];
    }
  }
  int perm_k;
  const bool ok_all =
      group_gj<T, G>(ar, ai, i, n, has_row, slot, eps2, perm_k);"""


def variants(src: str) -> dict[str, str]:
    """Each variant of the source, changed in one place."""
    for piece in (ASSEMBLE, REG_SMEM, LOADS, ELIMINATE, GROUP_ELIMINATE,
                  GROUP_ASSEMBLE, LDG_FLAT, LDG_ZEROS, NF_BUDGET):
        if src.count(piece) != 1:
            raise RuntimeError(f"mc_ac_fused.cu has no single {piece!r}")
    if not ASSEMBLY_BODY.search(src):
        raise RuntimeError("mc_ac_fused.cu has no assemble body")
    return {
        "source": src,
        "one frequency per thread": src.replace(
            NF_BUDGET, NF_BUDGET.replace("384", "1")),
        "192 B per thread": src.replace(NF_BUDGET,
                                        NF_BUDGET.replace("384", "192")),
        "768 B per thread": src.replace(NF_BUDGET,
                                        NF_BUDGET.replace("384", "768")),
        "entry walk": ASSEMBLY_BODY.sub(
            lambda m: m.group(1) + ENTRY_WALK_BODY + m.group(2), src,
            count=1),
        "tables in smem": src.replace(ASSEMBLE, TABLES_SMEM).replace(
            REG_SMEM, REG_SMEM_TABLES).replace(
            LDG_FLAT, "flat[q]").replace(LDG_ZEROS, "zeros[z]"),
        "assembly only": src.replace(ELIMINATE, SUM).replace(
            GROUP_ELIMINATE, GROUP_SUM),
        "elimination only": src.replace(ASSEMBLE, NO_ASSEMBLY)
        .replace(LOADS, SYNTHETIC).replace(GROUP_ASSEMBLE, GROUP_SYNTHETIC),
    }


def build(srcs: dict[str, str], nvcc: str, flags: tuple, csrc: Path
          ) -> dict[str, Path]:
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, (name, src) in enumerate(srcs.items()):
        cu = BUILD / f"k5_{k}.cu"
        cu.write_text(src)
        lib = BUILD / f"libk5_{k}.so"
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-I", str(csrc), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        libs[name] = lib
    return libs


# (kernel regex in a mangled name, label)
INSTANCES = ((r"mc_ac_fused_reg_kernelI([df])Li3E", "register N=3"),
             (r"mc_ac_fused_group_kernelI([df])Li8E", "group G=8"))


def resources(lib: Path, nvcc: str) -> dict:
    """Registers, stack, local memory and SASS opcodes of INSTANCES."""
    tool = str(Path(nvcc).parent / "cuobjdump")
    dump = subprocess.run([tool, "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out: dict = {}
    for pat, label in INSTANCES:
        for line, res in zip(dump, dump[1:]):
            m = re.search(pat, line)
            if m:
                key = f"{label} f{'64' if m.group(1) == 'd' else '32'}"
                out.setdefault(key, {}).update(
                    {k: int(v) for k, v in
                     re.findall(r"(REG|STACK|LOCAL):(\d+)", res)})
        for part in sass.split("Function : ")[1:]:
            m = re.match(r"\S*" + pat, part)
            if not m:
                continue
            counts: dict[str, int] = {}
            for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                 r"([A-Z][A-Z0-9_]*)", part):
                counts[op] = counts.get(op, 0) + 1
            key = f"{label} f{'64' if m.group(1) == 'd' else '32'}"
            out.setdefault(key, {})["sass"] = {
                "total": sum(counts.values()),
                **dict(sorted(counts.items(), key=lambda kv: -kv[1])[:12])}
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--forms-only", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_torch_k5.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k5: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE.parent))
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import ac as tac
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.constants import EPS
    from spicey_tpu_torch.decks import rc_ladder_netlist
    from spicey_tpu_torch.ops import _build, mc_ac_fused as mf
    from spicey_tpu_torch.ops._build import ptr, stream_ptr
    from tests.fused_systems import FREQS, dense_pattern, dense_values
    if not Path(st.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {st.__file__}, not from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    records = []

    def emit(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.perf_counter()
    mf.load_library()
    forms = getattr(mf, "FORMS", None)
    emit({"root": str(root), "forms": forms or ["shared"],
          "built_s": round(time.perf_counter() - t0, 1)})

    def deck_inputs(net, node, over, B, dtype):
        ckt = st.parse_netlist(net)
        t = st.build_tensors(ckt)

        def vals(base, names):
            return torch.as_tensor(tbatch._batch_values(base, names, over,
                                                        B),
                                   dtype=dtype, device=dev)

        ph = np.deg2rad(t.v_ac_phase_deg)
        values = mf.combine_values(
            vals(t.r_vals, t.r_names), vals(t.c_vals, t.c_names),
            vals(t.l_vals, t.l_names),
            torch.as_tensor(t.v_ac_mag * np.cos(ph), dtype=dtype,
                            device=dev).expand(B, -1),
            torch.as_tensor(t.v_ac_mag * np.sin(ph), dtype=dtype,
                            device=dev).expand(B, -1), dtype=dtype)
        freqs = torch.as_tensor(tac.build_frequency_array(
            ckt.ac.mode, ckt.ac.N, ckt.ac.f1, ckt.ac.f2), dtype=dtype,
            device=dev)
        packed = mf.pack_pattern(mf.build_stamp_pattern(
            t.nvar, t.r_idx, t.c_idx, t.l_idx, t.v_idx), t.nvar, dev)
        idx = [nm.upper() for nm in t.node_names].index(node.upper())
        return freqs, values, packed, idx

    def shapes(dtype):
        B = 1_000_000
        yield "yield-1M", deck_inputs(
            RC_NET, "2", {"r1": 30.0 * (1 + 0.2 * rng.random(B)),
                          "c1": 100e-6 * (1 + 0.2 * rng.random(B))}, B,
            dtype)
        lad = rc_ladder_netlist(5, 201)
        t = st.build_tensors(st.parse_netlist(lad))
        B = 262_144
        over = {nm: v * rng.uniform(0.9, 1.1, B) for nm, v in
                zip(t.r_names + t.c_names,
                    np.concatenate([t.r_vals, t.c_vals]))}
        yield "ladder-7", deck_inputs(lad, "n5", over, B, dtype)
        B = 1 << 20
        for n in range(1, 9):
            yield f"dense N={n}", (
                torch.as_tensor(FREQS, dtype=dtype, device=dev),
                torch.as_tensor(dense_values(n, B, args.seed), dtype=dtype,
                                device=dev),
                mf.pack_pattern(dense_pattern(n), n, dev), n - 1)

    reps = args.reps
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for label, (freqs, values, packed, node) in shapes(dtype):
            n, systems = packed.n, freqs.shape[0] * values.shape[1]
            if forms is None:
                emit({"shape": label, "dtype": tag, "n": n,
                      "systems": systems, "form": "shared",
                      "ms": cuda_ms(lambda: mf.mc_ac_fused_cuda(
                          freqs, values, packed, node), reps)})
                continue
            for form in forms:
                if form == "register" and n > mf.REG_MAX_N:
                    continue
                ms = cuda_ms(lambda: mf.mc_ac_fused_cuda(
                    freqs, values, packed, node, form=form), reps)
                emit({"shape": label, "dtype": tag, "n": n,
                      "systems": systems, "form": form,
                      "group": mf.fused_group_for(n) if form == "group"
                      else None,
                      "chosen": form == mf.k5_form_for(n, dtype)[0],
                      "ms": ms})
            del values
            torch.cuda.empty_cache()

    if forms is not None and not args.forms_only:
        csrc = root / "spicey_tpu_torch" / "csrc"
        t0 = time.perf_counter()
        srcs = variants((csrc / "mc_ac_fused.cu").read_text())
        libs = build(srcs, _build._nvcc(), _build.NVCC_FLAGS, csrc)
        emit({"variants": list(srcs),
              "built_s": round(time.perf_counter() - t0, 1)})
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            shaped = dict(shapes(dtype))
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, f"mc_ac_fused_{tag}")
                fn.argtypes = mf._LAUNCH_ARGS
                fn.restype = ctypes.c_int
                row = {"variant": name, "dtype": tag}
                for label, form in (("yield-1M", "register"),
                                    ("ladder-7", "group")):
                    freqs, values, packed, node = shaped[label]
                    F, B, n = freqs.shape[0], values.shape[1], packed.n
                    mag = torch.empty((F, B), dtype=dtype, device=dev)
                    valid = torch.empty((F, B), dtype=torch.bool,
                                        device=dev)

                    tab = packed.flat
                    if name == "entry walk":
                        tab = torch.cat([packed.ent.flatten(),
                                         packed.terms.flatten()])

                    def launch():
                        code = fn(ptr(freqs), ptr(values), F, B, ptr(tab),
                                  (packed.ent if name == "entry walk"
                                   else packed.flat).shape[0],
                                  ptr(packed.terms), ptr(packed.zeros),
                                  packed.zeros.shape[0], ptr(packed.row_ent),
                                  ptr(packed.row_ptr), n, node, float(EPS),
                                  mf.FORMS.index(form),
                                  mf.fused_group_for(n), ptr(mag),
                                  ptr(valid), stream_ptr(dev))
                        if code != 0:
                            raise RuntimeError(f"{name}: CUDA error {code}")

                    row[f"{label} {form} ms"] = cuda_ms(launch, reps)
                    if name == "source":
                        want = mf.mc_ac_fused_cuda(freqs, values, packed,
                                                   node, form=form)
                        row[f"{label} equals wrapper"] = bool(
                            torch.equal(mag.T, want[0]))
                    del mag, valid
                row["resources"] = {k: v for k, v in resources(
                    path, _build._nvcc()).items() if k.endswith(tag)}
                emit(row)
            del shaped
            torch.cuda.empty_cache()
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
