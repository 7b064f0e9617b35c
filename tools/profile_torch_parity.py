"""Which series of a deck does the card answer apart from the CPU path?

Runs a deck of ``spicey_tpu_torch/decks.py`` through ``simulate()`` on the
card and on the CPU and, for each analysis (.op, .ac, .tran) and field
(node voltages, element currents), prints every series whose card and CPU
values differ by more than the port's parity rule allows: rtol 1e-9 with
an atol of 1e-12 of the field's largest value. Each such series is given
with its largest difference, the atol it missed and its largest value.

    python3 tools/profile_torch_parity.py [--deck UA741_AMP]
        [--tran "1u 10u"] [--out chiprun_out/parity.json]

``--tran`` replaces the deck's .tran arguments (the card test's shorter
run). Prints one line per series outside the rule and a JSON summary as
its last line.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import spicey_tpu_torch as st  # noqa: E402
from spicey_tpu_torch import decks  # noqa: E402

RTOL, ATOL_OF_MAX = 1e-9, 1e-12


def outside(got: dict, want: dict) -> tuple[list[dict], int]:
    """Series of ``want`` outside the rule, and the number of series."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    atol = ATOL_OF_MAX * scale
    out = []
    for name, w in want.items():
        w = np.asarray(w)
        diff = np.abs(np.asarray(got[name]) - w)
        if np.any(diff > atol + RTOL * np.abs(w)):
            out.append({"series": name, "max_abs_diff": float(diff.max()),
                        "field_atol": atol,
                        "max_abs_value": float(np.abs(w).max())})
    return out, len(want)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deck", default="UA741_AMP")
    ap.add_argument("--tran", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    net = getattr(decks, args.deck)
    if args.tran:
        net = re.sub(r"^\.tran .*$", f".tran {args.tran}", net,
                     flags=re.MULTILINE)
    got = st.simulate(net, dialect="extended", device="cuda")
    want = st.simulate(net, dialect="extended", device="cpu")
    rows, counted = [], 0
    for an in ("op", "ac", "tran"):
        g, w = getattr(got, an), getattr(want, an)
        if w is None:
            continue
        for field in ("node_voltages", "element_currents"):
            bad, n = outside(getattr(g, field), getattr(w, field))
            counted += n
            for row in bad:
                row.update(analysis=an, field=field)
                print(json.dumps(row))
            rows += bad
    summary = {"deck": args.deck, "tran": args.tran, "series": counted,
               "outside": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
