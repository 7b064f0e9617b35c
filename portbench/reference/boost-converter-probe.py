"""Plain reference of the ``boost-converter-probe`` configuration: the
upstream boost converter (``configs/boost-converter-probe.cir``) under the
upstream engine's backward-Euler transient, every variant on its own
(``mna.tran_response``). Imports only NumPy, PyTorch and ``mna.py``
beside it."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

# mna.py beside this file, loaded by path: the reference is no package
mna = sys.modules.get("portbench_reference_mna")
if mna is None:
    _spec = importlib.util.spec_from_file_location(
        "portbench_reference_mna", Path(__file__).with_name("mna.py"))
    mna = importlib.util.module_from_spec(_spec)
    sys.modules[_spec.name] = mna
    _spec.loader.exec_module(mna)


def facts(deck_text: str) -> dict:
    """The analysis, the nominal values and the shapes, read from the deck
    by ``mna.py`` (``mna.tran_facts``)."""
    return mna.tran_facts(deck_text)


def responses(deck_text: str, overrides: dict, probe: str,
              dtype: torch.dtype, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """V(probe) of every variant at every time point (B, S+1), the
    variants solved without fault (B,), and the Newton passes they
    needed (``passes_per_lane``, the mean over the variants)."""
    deck = mna.read_deck(deck_text)
    v, ok, passes = mna.tran_response(deck, overrides, probe, dtype,
                                      device)
    return v, ok, {"passes_per_lane": float(passes.double().mean())}
