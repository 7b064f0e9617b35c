"""SPICE engineering-notation number parsing.

Contract: spicey/lib/parsing/parseNumberWithUnits.ts:1-30.

Semantics reproduced exactly:
  - plain numbers (``^[+-]?\\d*\\.?\\d+([eE][+-]?\\d+)?$``) parse directly;
  - otherwise split into <number><alpha-suffix>; if that fails, fall back to
    JS ``parseFloat`` semantics (longest numeric prefix, NaN if none);
  - the suffix is lowercased and *one* trailing unit word (ohm|v|a|s|h|f) is
    stripped (the reference's anchored ``replace(/(ohm|v|a|s|h|f)$/g)`` can
    only match once), then matched against the multiplier table;
  - ``meg`` is checked before single-letter suffixes; unknown suffixes yield
    the bare value (so ``10f`` is 10.0 -- the trailing ``f`` is consumed as a
    Farad unit word -- while ``10fF`` is 1e-14).
"""

from __future__ import annotations

import math
import re

_PLAIN_RE = re.compile(r"^[+-]?\d*\.?\d+(?:[eE][+-]?\d+)?$")
_NUM_SUFFIX_RE = re.compile(r"^([+-]?\d*\.?\d+(?:[eE][+-]?\d+)?)([a-zA-Z]+)$")
# JS parseFloat: optional sign, then digits with optional dot / leading-dot
# form, optional exponent; also accepts Infinity.
_JS_FLOAT_PREFIX_RE = re.compile(
    r"^[+-]?(?:Infinity|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
)
_UNIT_WORD_RE = re.compile(r"(ohm|v|a|s|h|f)$")

UNIT_MULTIPLIERS = {
    "t": 1e12,
    "g": 1e9,
    "meg": 1e6,
    "k": 1e3,
    "m": 1e-3,
    "u": 1e-6,
    "n": 1e-9,
    "p": 1e-12,
    "f": 1e-15,
}


def js_parse_float(s: str) -> float:
    """JS ``parseFloat``: longest valid numeric prefix, else NaN."""
    s = s.strip()
    m = _JS_FLOAT_PREFIX_RE.match(s)
    if not m:
        return math.nan
    text = m.group(0)
    if text.endswith("Infinity"):
        return -math.inf if text.startswith("-") else math.inf
    return float(text)


def parse_number_with_units(raw: object) -> float:
    """Parse a SPICE number token (e.g. ``100u``, ``5k``, ``2kohm``)."""
    if raw is None:
        return math.nan
    s = str(raw).strip()
    if s == "":
        return math.nan
    if _PLAIN_RE.match(s):
        return float(s)
    m = _NUM_SUFFIX_RE.match(s)
    if not m:
        return js_parse_float(s)
    val = float(m.group(1))
    suf = m.group(2).lower()
    suf = _UNIT_WORD_RE.sub("", suf, count=1)
    if suf == "meg":
        return val * UNIT_MULTIPLIERS["meg"]
    if len(suf) == 1 and suf in UNIT_MULTIPLIERS:
        return val * UNIT_MULTIPLIERS[suf]
    return val
