"""The uA741 amplifier's adaptive transient over its whole ``.tran``, both packages on the CPU.

``tests/test_torch_adaptive.py`` holds the port against ``spicey_tpu`` on
the uA741 (``decks.UA741_AMP``) over its first nanosecond only: the port's
host-driven controller takes ~0.15 s an attempt on the CPU, and the whole
50 us is ~1,300 attempts. This script runs the whole horizon (or
``--tstop``) through ``spicey_tpu.simulate_tran_adaptive`` and
``spicey_tpu_torch.simulate_tran_adaptive(device="cpu")`` with the same
tensors, and prints each package's counts, flags and wall and the largest
gap of the port's node voltages against the JAX series interpolated at
the port's times, over the largest |node voltage| (the rule of
``tests/test_torch_adaptive.py:AMPLIFIED``). It exits 1 when the counts or
flags differ. Runs on the CPU:

    JAX_PLATFORMS=cpu python3 tools/profile_torch_adaptive.py [--tstop 50u]
        [--out build/profile_torch_adaptive.json]

The last line of its output is a JSON object of the same numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIELDS = ("n_accepted", "n_rejected", "n_attempts", "exhausted")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tstop", default="50u")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "profile_torch_adaptive.json"))
    args = ap.parse_args()

    import spicey_tpu as sj
    import spicey_tpu_torch as st
    from spicey_tpu_torch import decks
    from spicey_tpu_torch.ir.circuit import from_jax_tensors

    net = decks.UA741_AMP.replace(".tran 1u 50u", f".tran 1u {args.tstop}")
    jc = sj.parse_netlist(net, dialect="extended")
    jt = sj.build_tensors(jc)
    t0 = time.perf_counter()
    want = sj.simulate_tran_adaptive(jc, tensors=jt)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = st.simulate_tran_adaptive(st.parse_netlist(net, dialect="extended"),
                                    tensors=from_jax_tensors(jt),
                                    device="cpu")
    port_s = time.perf_counter() - t0

    scale = max(float(np.abs(v).max()) for v in want.node_voltages.values())
    gap = max(float(np.abs(got.node_voltages[n]
                           - np.interp(got.times, want.times, v)).max())
              for n, v in want.node_voltages.items()) / scale
    out = {"tstop": args.tstop,
           "jax": {**{f: getattr(want, f) for f in FIELDS}, "wall_s": jax_s,
                   "t_end": float(want.times[-1])},
           "port": {**{f: getattr(got, f) for f in FIELDS}, "wall_s": port_s,
                    "t_end": float(got.times[-1])},
           "gap_of_max": gap}
    for who in ("jax", "port"):
        r = out[who]
        print(f"{who}: {r['n_accepted']} accepted, {r['n_rejected']} "
              f"rejected of {r['n_attempts']}, exhausted {r['exhausted']}, "
              f"to t = {r['t_end']:.6g} s, {r['wall_s']:.1f} s on the CPU")
    print(f"port against JAX interpolated: {gap:.3e} of the largest |v|")
    same = all(out["jax"][f] == out["port"][f] for f in FIELDS)
    out["counts_equal"] = same
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out) + "\n")
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
