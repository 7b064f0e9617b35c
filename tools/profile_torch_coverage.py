"""Which decks of the JAX package's tests does the port refuse?

Collects every string literal of ``tests/test_*.py`` (the JAX package's
test files; the port's ``test_torch_*.py`` are left out) that holds a
netlist with an analysis line (.ac, .tran, .op, .dc, .tf, .noise, .step,
.pz, .sens, .four, .meas, .control), runs each through
``spicey_tpu.simulate`` and, where that succeeds, through
``spicey_tpu_torch.simulate(device="cpu")``, both in the extended
dialect, and counts the decks the JAX package runs and the port refuses,
by the ROADMAP item its ``NotImplementedError`` names. Decks the JAX
package itself rejects are not counted. Runs on the CPU (JAX on the CPU,
the port's plain versions), one worker process per deck with a time
limit:

    JAX_PLATFORMS=cpu python3 tools/profile_torch_coverage.py [--jobs 4]
        [--timeout 120] [--out build/coverage.json]

Prints one line per refused deck and a JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import ast
import json
import multiprocessing as mp
import os
import re
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DIRECTIVE = re.compile(
    r"^\s*\.(ac|tran|op|dc|tf|noise|step|pz|sens|four|meas|control)\b",
    re.IGNORECASE | re.MULTILINE)


def literal_decks() -> list[tuple[str, int, str]]:
    """(file, line, text) of every netlist literal in the JAX tests."""
    out = []
    for path in sorted((REPO / "tests").glob("test_*.py")):
        if path.name.startswith("test_torch_"):
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and "\n" in node.value
                    and DIRECTIVE.search(node.value)):
                out.append((path.name, node.lineno, node.value))
    return out


def _run(text: str) -> tuple[str, str]:
    """("jax-rejects" | "ok" | "refused" | "port-error", detail). Runs in
    a temporary directory: a deck's ``.control`` block may write files."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("SPICEY_TPU_INTERP", "0")
    sys.path.insert(0, str(REPO))
    import spicey_tpu as sj
    import spicey_tpu_torch as st

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            return _both(sj, st, text)
        finally:
            os.chdir(cwd)


def _both(sj: object, st: object, text: str) -> tuple[str, str]:
    try:
        sj.simulate(text, dialect="extended")
    except Exception as err:  # noqa: BLE001 - any JAX-side failure
        return "jax-rejects", type(err).__name__
    try:
        st.simulate(text, dialect="extended", device="cpu")
    except NotImplementedError as err:
        m = re.search(r"item (\d+)", str(err))
        return "refused", f"item {m.group(1) if m else '?'}: {err}"
    except Exception as err:  # noqa: BLE001 - a port fault to report
        return "port-error", f"{type(err).__name__}: {err}"
    return "ok", ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    decks = literal_decks()
    ctx = mp.get_context("spawn")
    results = []
    with ctx.Pool(args.jobs, maxtasksperchild=8) as pool:
        pending = [(f, ln, pool.apply_async(_run, (text,)))
                   for f, ln, text in decks]
        for f, ln, job in pending:
            try:
                kind, detail = job.get(timeout=args.timeout)
            except mp.TimeoutError:
                kind, detail = "timeout", ""
            results.append({"file": f, "line": ln, "kind": kind,
                            "detail": detail})
            if kind in ("refused", "port-error", "timeout"):
                print(f"{f}:{ln} {kind} {detail}", flush=True)
    by_kind: dict[str, int] = {}
    by_item: dict[str, int] = {}
    for r in results:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
        if r["kind"] == "refused":
            item = r["detail"].split(":")[0]
            by_item[item] = by_item.get(item, 0) + 1
    summary = {"decks": len(results), "by_kind": by_kind,
               "refused_by_item": by_item}
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"summary": summary, "decks": results}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
