"""Command-line runner: ``python -m spicey_tpu_torch deck.cir [options]``.

The reference is a library with no CLI (SURVEY §1); this gives the port
the JAX package's ngspice-like batch mode (a copy of
spicey_tpu/__main__.py): read a netlist deck, run every analysis it
requests, print the formatted tables, and optionally export an ngspice
rawfile for waveform viewers. The run goes to the CUDA card, and raises
when there is none, unless ``--cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spicey_tpu_torch",
        description="Run SPICE analyses on a netlist deck (PyTorch/CUDA "
                    "engine).")
    ap.add_argument("deck", help="netlist file, or '-' for stdin")
    ap.add_argument("--dialect", choices=("spicey", "extended"),
                    default="extended",
                    help="netlist dialect (default: extended; 'spicey' is "
                         "bit-for-bit the reference dialect)")
    ap.add_argument("--raw", metavar="FILE",
                    help="also write results as an ngspice rawfile")
    ap.add_argument("--binary", action="store_true",
                    help="rawfile Binary: blocks instead of ASCII Values:")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions of the "
                         "kernels) instead of the CUDA card")
    ap.add_argument("--method", default="gj",
                    help="linear-solver tier (gj | pallas)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress result tables (e.g. rawfile-only runs)")
    args = ap.parse_args(argv)

    text = (sys.stdin.read() if args.deck == "-"
            else open(args.deck).read())
    base_dir = (os.getcwd() if args.deck == "-"
                else os.path.dirname(os.path.abspath(args.deck)))

    from spicey_tpu_torch import (
        format_ac_result,
        format_dc_result,
        format_four_result,
        format_noise_result,
        format_op_result,
        format_pz_result,
        format_sens_result,
        format_tf_result,
        format_tran_result,
        simulate,
    )
    from spicey_tpu_torch.formatting.rawfile import write_rawfile

    res = simulate(text, dialect=args.dialect, method=args.method,
                   base_dir=base_dir, device="cpu" if args.cpu else None)

    if not args.quiet:
        if res.circuit.title:
            print(f"* {res.circuit.title}")
        if res.op is not None:
            print(format_op_result(res.op))
        if res.dc is not None:
            print(format_dc_result(res.dc))
        if res.tf is not None:
            print(format_tf_result(res.tf))
        if res.pz is not None:
            print(format_pz_result(res.pz))
        if res.sens is not None:
            print(format_sens_result(res.sens))
        if res.noise is not None:
            print(format_noise_result(res.noise))
        if res.ac is not None:
            print(format_ac_result(res.ac))
        if res.tran is not None:
            print(format_tran_result(res.tran))
        if res.four is not None:
            print(format_four_result(res.four))
        if res.meas:
            for name, value in res.meas.items():
                print(f"{name} = {value:.6g}")
        if res.step is not None:
            s = res.step
            print(f"step {s.param}: "
                  + ", ".join(f"{v:.6g}" for v in s.values))
            for name, arr in (s.meas or {}).items():
                print(f"  {name} = "
                      + ", ".join(f"{v:.6g}" for v in arr))
        if res.control_output:
            print(res.control_output)
        if res.circuit.skipped:
            print(f"* skipped {len(res.circuit.skipped)} line(s)",
                  file=sys.stderr)
    if args.raw:
        write_rawfile(res, args.raw, ascii_values=not args.binary)
        if not args.quiet:
            print(f"* wrote rawfile: {args.raw}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
