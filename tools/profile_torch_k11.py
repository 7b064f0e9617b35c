"""K11, the assembly of a Newton pass, against the index_add_ chain it
replaced, at the main path's shapes.

Run on a CUDA card from the repo root: ``python3 tools/profile_torch_k11.py
[--reps 20] [--seed 0] [--out FILE]``; ``chip_smoke.py`` phase 28 runs
the same comparisons and times (``phase28``). Imports nothing of JAX.

Shapes: the boost's Monte-Carlo loop pass (``decks.BOOST_NET``, 1,000,000
lanes, RR1, CC1 and LL1 at U(0.9, 1.1) x nominal, N = 6: the
``boost-yield-f64-loop`` cell's pass, in f64 and f32) and the uA741's
pass (``decks.UA741_AMP``, 1,024 lanes, N = 36, f64). Each pass's values
are computed once (``tran._pass_values``, a random state). K11 in every
form that takes N (``stamp_real.stamp_real_cuda``) is held bit for bit to
the chain it replaced on the same values: a zero-filled padded system,
the layout's ``index_add_`` scatters through ops/stamps.py, sliced to N
(``chain``). At the boost no scatter call adds two contributions to one
entry, so the chain on the card is deterministic and is the reference;
the uA741's calls do, and the card's atomics add those in any order, so
there the reference is the chain on the CPU, which adds them in element
order as the plan does. Then, over ``--reps`` launches each, CUDA events
time each form and the chain on the card (with the copy of the slice K2
read). One JSON line a shape and type: the times in ms, K11's bytes
(every value slot read once, A and b written once), its bytes bound at
3.35 TB/s and its share of that bound, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import spicey_tpu_torch as st  # noqa: E402
from spicey_tpu_torch import decks  # noqa: E402
from spicey_tpu_torch.analysis import tran as ttran  # noqa: E402
from spicey_tpu_torch.ir.circuit import (build_tensors,  # noqa: E402
                                         effective_time_step)
from spicey_tpu_torch.ops import stamp_real  # noqa: E402

HBM_BYTES_S = 3.35e12
F64 = torch.float64


def pass_inputs(text: str, B: int, dev: torch.device, seed: int,
                dtype: torch.dtype = F64) -> tuple:
    """The deck's ``arr`` in ``dtype`` prepared as ``_tran_core`` prepares
    it (R, C, L at U(0.9, 1.1) x nominal per lane), its setup, a random
    state and the pass's values."""
    ckt = st.parse_netlist(text, dialect="extended")
    t = build_tensors(ckt)
    dt, _ = effective_time_step(ckt.tran.dt, ckt.tran.tstop)
    rng = np.random.default_rng(seed)

    def val(a: np.ndarray) -> torch.Tensor:
        a = np.asarray(a, np.float64)
        return torch.as_tensor(a * rng.uniform(0.9, 1.1, (B,) + a.shape),
                               dtype=dtype, device=dev)

    arr = ttran.tran_arrays(t, dev, dtype, r_vals=val(t.r_vals),
                            c_vals=val(t.c_vals), l_vals=val(t.l_vals),
                            ckt=ckt, dt=dt)
    arr = dict(arr, bsrc_t=ttran.prepare_bsources(arr["bsrc"], dev))
    n = {"c": t.n_c, "l": t.n_l, "s": t.n_s, "d": t.n_d, "m": t.n_m,
         "q": t.n_q}
    carry = ttran._init_carry((B,), n, dtype, dev, arr["dchg"] is not None,
                              arr["qchg"] is not None)
    carry = [c if c.dtype == torch.bool else
             torch.as_tensor(rng.uniform(-0.9, 0.9, c.shape), dtype=dtype,
                             device=dev) for c in carry]
    x = torch.as_tensor(rng.uniform(-2, 2, (B, t.nvar)), dtype=dtype,
                        device=dev)
    vs_t = torch.as_tensor(rng.uniform(-5, 5, (t.n_v + t.n_i,)),
                           dtype=dtype, device=dev)
    vals = ttran._pass_values(arr, t.nvar, dt, vs_t, x, 1, carry, carry[7],
                              "be", False, False,
                              ttran.vt_scale_of(t, dev, dtype), None, 0.0)
    return arr, ttran._stamp_setup(arr, t.nvar), vals, t.nvar


def k11_bytes(plan: stamp_real.StampPlan, vals: dict, B: int,
              dtype: torch.dtype = F64) -> int:
    """Every value slot read once (its distinct elements), A and b written
    once in ``dtype``."""
    n = plan.n
    read = 0
    for s in plan.names:
        v = vals[s]
        lanes = B if v.dim() >= 2 and v.shape[0] == B else 1
        per = (math.prod(v.shape[-2:]) if s in plan.matrix
               else (v.shape[-1] if v.dim() else 1))
        read += lanes * per * v.element_size()
    return read + B * (n * n + n) * dtype.itemsize


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def chain(layout: list, index: dict, vals: dict, B: int, n: int,
          dtype: torch.dtype, dev: torch.device
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K11's plain version on ``dev``: the index_add_ assembly into a
    zero-filled padded system, sliced to N and copied contiguous as K2
    read it."""
    A, b = ttran._zeros((B,), n + 1, dtype, dev)
    ttran.apply_stamps(A, b, layout, index, vals)
    return A[..., :n, :n].contiguous(), b[..., :n].contiguous()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


SHAPES = (("boost-loop-1M", decks.BOOST_NET, 1_000_000, F64),
          ("boost-loop-1M", decks.BOOST_NET, 1_000_000, torch.float32),
          ("ua741-1024", decks.UA741_AMP, 1024, F64))


def phase28(dev: torch.device, emit, card: str, reps: int = 20,
            seed: int = 0) -> list[dict]:
    """The module docstring's comparisons and times, a row (also passed to
    ``emit`` as a JSON line) a shape and type; raises unless every form
    equals the reference bit for bit."""
    rows = []
    for name, text, B, dtype in SHAPES:
        arr, stamps, vals, n = pass_inputs(text, B, dev, seed, dtype)
        cpu_ref = name.startswith("ua741")
        if cpu_ref:
            cpu = torch.device("cpu")
            ref = chain(stamps.layout,
                        {k: v.cpu() for k, v in stamps.index.items()},
                        {k: v.cpu() for k, v in vals.items()}, B, n, dtype,
                        cpu)
        else:
            ref = chain(stamps.layout, stamps.index, vals, B, n, dtype, dev)
        own = stamp_real.form_for(n, dtype)
        forms = [f for f in stamp_real.FORMS if f == "entry" or f == own]
        for form in forms:
            A, b = stamp_real.stamp_real_cuda(stamps.plan, vals, (B,), dtype,
                                              dev, form=form)
            for got, want, what in ((A, ref[0], "A"), (b, ref[1], "b")):
                if not torch.equal(_bits(got.cpu() if cpu_ref else got),
                                   _bits(want)):
                    raise AssertionError(
                        f"28 K11 {form} {name} {dtype}: {what} differs from "
                        "the index_add_ assembly")
            del A, b
        del ref
        forms_ms = {f: ms(lambda f=f: stamp_real.stamp_real_cuda(
            stamps.plan, vals, (B,), dtype, dev, form=f), reps)
            for f in forms}
        nbytes = k11_bytes(stamps.plan, vals, B, dtype)
        bound = nbytes / HBM_BYTES_S * 1e3
        row = {"shape": name, "dtype": str(dtype).split(".")[-1],
               "lanes": B, "n": n, "pages": len(stamps.plan.pages),
               "contributions": int(sum(len(e) for _s, _p, e
                                        in stamps.plan.pages)),
               "form": own, "k11_ms": forms_ms[own], "forms_ms": forms_ms,
               "chain_ms": ms(lambda: chain(stamps.layout, stamps.index,
                                            vals, B, n, dtype, dev), reps),
               "bytes": nbytes, "bound_ms": bound,
               "k11_roofline_pct": 100 * bound / forms_ms[own],
               "bit_equal": "cpu chain" if cpu_ref else "card chain",
               "card": card}
        emit(json.dumps(row))
        rows.append(row)
        del arr, stamps, vals
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile_torch_k11.json")
    a = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lines = phase28(dev, lambda line: print(line, flush=True), smi,
                    reps=a.reps, seed=a.seed)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n")


if __name__ == "__main__":
    main()
