"""Where the benchmark's pieces live, found by the names in BENCHMARK.json.

A cell ``<name>`` is ``workloads/<name>.json``: its traffic mix (the
request a job sends: the entry, its arguments, the variants per job),
the control's precision and the limits. Its configuration is
``configs/<config>.json`` (the deck, the probed node, the sweep with its
nominal values, the shapes), beside its deck and its plain reference
``reference/<config>.py``. The entry's caller and faults are
``entries/<entry>.py``, a per-layer metric ``metrics/<metric>.py`` and a
kernel's work ``work/<kernel>.py``. Adding any of them is adding files
and entries: nothing here names one.

A cell's own pieces (its configuration with its deck, its traffic mix
and its reference) sit in one folder, its ``home``: ``portbench/`` for
the cells of ``BENCHMARK.json``; a folder of its own for a cell kept
apart (a test's fixture), whose cells are listed in
``<home>/cells.json`` in BENCHMARK.json's form. A piece the home lacks
is taken from ``portbench/``; entries, metrics and kernels' work are
always ``portbench/``'s.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent.parent     # portbench/
ROOT = HERE.parent                                # the checkout's root

_MODULES: dict[Path, ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT, home: Path = HERE) -> dict:
    """The cells of ``home``: BENCHMARK.json for ``portbench/``, else
    ``<home>/cells.json``."""
    if Path(home).resolve() == HERE:
        return load_json(root / "BENCHMARK.json")
    return load_json(Path(home) / "cells.json")


def find(folder: str, name: str, suffix: str, home: Path = HERE) -> Path:
    """``<home>/<folder>/<name><suffix>``, else the same under
    ``portbench/``."""
    own = Path(home) / folder / f"{name}{suffix}"
    return own if own.is_file() else HERE / folder / f"{name}{suffix}"


def module(folder: str, name: str, home: Path = HERE) -> ModuleType:
    """``<folder>/<name>.py`` of ``home`` (else of ``portbench/``) as a
    module (names may hold '-', so they are loaded by path, once per
    process)."""
    path = find(folder, name, ".py", home).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} named {name!r} ({path})")
        rel = path.relative_to(HERE).with_suffix("").parts
        spec = importlib.util.spec_from_file_location(
            "portbench_" + "_".join(p.replace("-", "_").replace(".", "_")
                                    for p in rel), path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


class Cell:
    """One cell with everything it names, read from its files."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: Path = ROOT, home: Path = HERE):
        self.home = Path(home).resolve()
        bench = benchmark(root, self.home) if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            where = ("BENCHMARK.json" if self.home == HERE
                     else self.home / "cells.json")
            raise KeyError(f"{where} has no workload {name!r}")
        self.name = name
        self.entry = entries[name]
        self.config = load_json(find("configs", self.entry["config"],
                                     ".json", self.home))
        workload = load_json(find("workloads", name, ".json", self.home))
        if workload.get("traffic") != self.entry["traffic"]:
            raise KeyError(f"workloads/{name}.json holds traffic "
                           f"{workload.get('traffic')!r}, the cell "
                           f"{self.entry['traffic']!r}")
        # the request and the limits (workload) with the probed node
        # (configuration), in one view
        self.spec = {**workload, "node": self.config.get("probe")}
        self.deck_text = (root / self.config["deck"]).read_text()
        # the program's reader of the deck: its default dialect, unless
        # the configuration names one ("extended": subcircuits, BJTs, ...)
        self.parse_kw = ({"dialect": self.config["dialect"]}
                         if "dialect" in self.config else {})
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def reference(self) -> ModuleType:
        return module("reference", self.entry["config"], self.home)

    @property
    def caller(self) -> ModuleType:
        return module("entries", self.spec["entry"])
