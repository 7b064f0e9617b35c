"""Where the benchmark's pieces live, found by the names in BENCHMARK.json.

A cell ``<name>`` is ``workloads/<name>.json``: its traffic mix (the
request a job sends: the entry, its arguments with the one precision,
the variants per job), the control's precision and the limits. Its
configuration is ``configs/<config>.json`` (the deck, the probed node,
the sweep with its nominal values, the shapes), beside its deck and its
plain reference ``reference/<config>.py``. The entry's caller is
``entries/<entry>.py``, a per-layer metric ``metrics/<metric>.py`` and a
kernel's work ``work/<kernel>.py``. Adding any of them is adding files
and entries: nothing here names one.
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


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def module(folder: str, name: str) -> ModuleType:
    """``portbench/<folder>/<name>.py`` as a module (names may hold '-',
    so they are loaded by path, once per process)."""
    path = HERE / folder / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name.replace('-', '_').replace('.', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


class Cell:
    """One cell of BENCHMARK.json with everything it names, read from its
    files."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: Path = ROOT):
        bench = benchmark(root) if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        self.name = name
        self.entry = entries[name]
        self.config = load_json(HERE / "configs"
                                / f"{self.entry['config']}.json")
        workload = load_json(HERE / "workloads" / f"{name}.json")
        if workload.get("traffic") != self.entry["traffic"]:
            raise KeyError(f"workloads/{name}.json holds traffic "
                           f"{workload.get('traffic')!r}, BENCHMARK.json "
                           f"{self.entry['traffic']!r}")
        # the request and the limits (workload) with the probed node
        # (configuration), in one view
        self.spec = {**workload, "node": self.config["probe"]}
        self.deck_text = (ROOT / self.config["deck"]).read_text()
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def reference(self) -> ModuleType:
        return module("reference", self.entry["config"])

    @property
    def caller(self) -> ModuleType:
        return module("entries", self.spec["entry"])
