"""Smoke run of the PyTorch/CUDA port (spicey_tpu_torch) on one NVIDIA GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It
needs one CUDA card and the CUDA toolkit (nvcc), imports nothing of JAX,
and exits nonzero on the first failure (nothing is caught). Phases, one
line each:

  1. build kernels K1 (csrc/gj_complex.cu) and K5 (csrc/mc_ac_fused.cu)
     with nvcc; print the build seconds and the card's name/power limit;
  2. every kernel instantiation against its plain PyTorch version on the
     card, on the same inputs: K1 at N in {3, 8, 64, 128} with singular
     lanes and at the main path's shapes (the basics01 planes, the N = 64
     ladder's 2048 x 51 systems), K5 on the extended deck and at the 1M x
     201 yield; ``valid`` identical, f64 rtol 1e-12, f32 rtol 1e-5 (nvcc
     contracts multiply-adds into FMAs, the torch ops do not). The f32
     ladder is too ill-conditioned for 1e-5 between two f32 eliminations;
     there K1 must be as accurate as the plain version against an f64
     solve of the same planes (see ``k1_vs_plain``);
  3-5. the main path through the public entry points, with every launch
     counter zeroed first: the basics01 golden on cuda (character-exact);
     the 1M-variant AC yield at f32 (K5) against the analytic
     |1/(1+jwRC)| ensemble at rtol 2e-4, at f64 at rtol 1e-9, and one
     on-device-sampled 1M run; the N = 64 RC ladder at f32 and f64 (K1),
     means within 5e-3, and f64 kernel against the f64 plain path on a
     64-variant subset at 1e-9;
  6. every instantiation launched during 3-5; CUDA-event times of each
     kernel and its plain version at the main path's shapes.

Then a JSON line of the kernels, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TAG = {torch.float64: "f64", torch.float32: "f32"}


def rc_ladder_netlist(sections: int, freqs: int = 51) -> str:
    """RC ladder with ``sections`` stages: Nvar = sections + 2."""
    lines = ["* ladder bench", "v1 in 0 dc 0 ac 1"]
    prev = "in"
    for i in range(1, sections + 1):
        lines.append(f"r{i} {prev} n{i} {100 + i}")
        lines.append(f"c{i} n{i} 0 1u")
        prev = f"n{i}"
    lines.append(f".ac lin {freqs} 1 10k")
    lines.append(".end")
    return "\n".join(lines) + "\n"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one warm
    run, by CUDA events around the whole batch of runs."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import spicey_tpu_torch as st
    from spicey_tpu_torch.analysis import ac as tac
    from spicey_tpu_torch.analysis import batch as tbatch
    from spicey_tpu_torch.analysis import mc as tmc
    from spicey_tpu_torch.ops import _build, gj, linsolve, mc_ac_fused

    dev = torch.device("cuda")
    kernels = {k.name: k for k in
               list(gj.K1.values()) + list(mc_ac_fused.K5.values())}
    err = {name: 0.0 for name in kernels}
    ms: dict[str, tuple[float, float]] = {}

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    gj.load_library()
    mc_ac_fused.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("1 build", f"{time.perf_counter() - t0:.1f} s "
        f"{ {k: round(v, 2) for k, v in _build.build_seconds().items()} } "
        f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}")

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

    def assembled(net, overrides, B, dtype, dialect="spicey"):
        """The planes the K1 route assembles for a deck, flattened to
        (B*F, N, N) and (B*F, N) as K1 takes them."""
        ckt = st.parse_netlist(net, dialect=dialect)
        t = st.build_tensors(ckt)
        freqs = tac.build_frequency_array(ckt.ac.mode, ckt.ac.N, ckt.ac.f1,
                                          ckt.ac.f2)
        v_idx, v_re, v_im = tac.ac_vsource_arrays(ckt, t)

        def vals(base, names):
            return torch.as_tensor(
                tbatch._batch_values(base, names, overrides, B),
                dtype=dtype, device=dev)

        iph = np.deg2rad(t.i_ac_phase_deg)
        planes = tac._assemble_grid(
            torch.as_tensor(freqs, dtype=dtype, device=dev),
            tac.index_tensor(t.r_idx, dev), vals(t.r_vals, t.r_names),
            tac.index_tensor(t.c_idx, dev), vals(t.c_vals, t.c_names),
            tac.index_tensor(t.l_idx, dev), vals(t.l_vals, t.l_names),
            tac.index_tensor(v_idx, dev),
            torch.as_tensor(v_re, dtype=dtype, device=dev).expand(B, -1),
            torch.as_tensor(v_im, dtype=dtype, device=dev).expand(B, -1),
            t.nvar, ext=tbatch._batched_ext(t, overrides, B, dev, dtype),
            i_re=torch.as_tensor(t.i_ac_mag * np.cos(iph), dtype=dtype,
                                 device=dev),
            i_im=torch.as_tensor(t.i_ac_mag * np.sin(iph), dtype=dtype,
                                 device=dev))
        return [p.reshape((-1,) + p.shape[2:]).contiguous() for p in planes]

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
        packed = tmc._fused_pattern(ckt, t, "pallas", dev)
        return (torch.as_tensor(freqs, dtype=dtype, device=dev), values,
                packed, node_idx)

    def plain_chunked(freqs, values, packed, node_idx, chunk=125_000):
        parts = [mc_ac_fused.mc_ac_fused_plain(
            freqs, values[:, s:s + chunk].contiguous(), packed, node_idx)
            for s in range(0, values.shape[1], chunk)]
        return (torch.cat([m for m, _ in parts]),
                torch.cat([v for _, v in parts]))

    def k5_vs_plain(inputs, dtype, what, main_shape):
        mag, v = mc_ac_fused.mc_ac_fused_cuda(*inputs)
        pmag, pv = plain_chunked(*inputs)
        if not torch.equal(v, pv):
            raise AssertionError(f"K5 {what}: valid flags differ")
        e = check_close(mag[pv], pmag[pv], TOL[dtype], f"K5 {what}")
        if main_shape:
            name = mc_ac_fused.K5[dtype].name
            err[name] = max(err[name], e)
        return e, int(pv.sum()), pv.numel()

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
            f"(4096, {inputs[0].shape[0]}) valid {nv}/{nt} "
            f"max_abs_err {e:.3e}")
        big_inputs[dtype] = fused_inputs(RC_NET, "2", big_over, BIG, dtype)
        e, nv, nt = k5_vs_plain(big_inputs[dtype], dtype,
                                f"{TAG[dtype]} 1M", True)
        if nv != nt:
            raise AssertionError(f"K5 1M: {nv}/{nt} valid")
        say("2 compare", f"K5 {TAG[dtype]} RC (1M, 201) valid {nv}/{nt} "
            f"max_abs_err {e:.3e}")
    torch.cuda.empty_cache()

    # ---- 3-5. the main path, counted -------------------------------------
    for k in kernels.values():
        k.launches = 0
    with open("tests/fixtures/basics01_golden.txt") as fh:
        golden = fh.read()
    out = st.format_ac_result(st.simulate(BASICS01, device=dev).ac)
    if out != golden:
        raise AssertionError("basics01 golden mismatch on cuda")
    say("3 golden", "basics01 character-exact on cuda")

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

    # ---- 6. launches and times --------------------------------------------
    launches = {name: k.launches for name, k in kernels.items()}
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    say("6 launches", json.dumps(launches))
    for dtype, planes in ladder_planes.items():
        ms[gj.K1[dtype].name] = (
            cuda_ms(lambda: gj.gj_solve_planes_cuda(*planes), 5),
            cuda_ms(lambda: linsolve.gj_solve_planes(*planes), 2))
    for dtype, inputs in big_inputs.items():
        ms[mc_ac_fused.K5[dtype].name] = (
            cuda_ms(lambda: mc_ac_fused.mc_ac_fused_cuda(*inputs), 5),
            cuda_ms(lambda: plain_chunked(*inputs), 1))
    for name, (k_ms, p_ms) in ms.items():
        shape = "ladder (104448, 64)" if "gj" in name else "RC (1M, 201)"
        say("6 times", f"{name} at {shape}: kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms (CUDA events) | {smi}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name][0],
         "plain_ms": ms[name][1]}
        for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
