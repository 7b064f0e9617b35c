"""Faithful JS ``Number.prototype.toPrecision(p)`` formatting.

The reference's text output contract is built entirely on JS ``toPrecision(6)``
(spicey/lib/formatting/formatAcResult.ts:16-21,
 spicey/lib/formatting/formatTranResult.ts:13-18), and the golden
snapshot in tests/basics/basics01.test.ts:18-221 is matched character-for-
character. ECMA-262 semantics implemented here:

  - the significand is chosen as the integer n minimizing |n/10^(e-p+1) - x|
    over |x|, ties resolved upward (round-half-up on the exact decimal value
    of the binary double);
  - fixed notation when -6 <= e < p... precisely: exponential notation is used
    iff e < -6 or e >= p, else fixed with (p-1-e) fraction digits;
  - exponential form is ``d.ddddde±k`` with no zero-padding of the exponent;
  - negative zero formats without a sign ("0.00000").
"""

from __future__ import annotations

import math
from decimal import Decimal, ROUND_HALF_UP


def to_precision(x: float, p: int = 6) -> str:
    if isinstance(x, bool):  # guard: bool is an int subclass
        x = float(x)
    x = float(x)
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    sign = "-" if (x < 0) else ""
    ax = abs(x)
    if ax == 0.0:
        # JS: ToString step gives "0" then pads fraction digits; no sign for -0
        if p == 1:
            return "0"
        return "0." + "0" * (p - 1)

    d = Decimal(ax)  # exact binary -> decimal expansion
    e = d.adjusted()
    # round the scaled significand to p digits, half-up
    q = d.scaleb(-e).quantize(Decimal(1).scaleb(-(p - 1)), rounding=ROUND_HALF_UP)
    if q >= 10:
        q = q.scaleb(-1)
        # re-quantize to drop the extra digit introduced by the carry
        q = q.quantize(Decimal(1).scaleb(-(p - 1)), rounding=ROUND_HALF_UP)
        e += 1
    digits = str(q).replace(".", "")
    digits = (digits + "0" * p)[:p]

    if e < -6 or e >= p:
        mantissa = digits[0] if p == 1 else f"{digits[0]}.{digits[1:]}"
        exp_sign = "+" if e >= 0 else "-"
        return f"{sign}{mantissa}e{exp_sign}{abs(e)}"
    if e >= 0:
        int_part = digits[: e + 1]
        frac_part = digits[e + 1:]
        return f"{sign}{int_part}.{frac_part}" if frac_part else f"{sign}{int_part}"
    return f"{sign}0.{'0' * (-e - 1)}{digits}"


def to_fixed(x: float, digits: int) -> str:
    """JS ``Number.prototype.toFixed``: round-half-up on the exact value."""
    x = float(x)
    if math.isnan(x):
        return "NaN"
    sign = "-" if x < 0 else ""
    d = Decimal(abs(x)).quantize(Decimal(1).scaleb(-digits), rounding=ROUND_HALF_UP)
    s = f"{d:f}"
    if s.startswith("-"):
        s = s[1:]
    # JS keeps the sign even for rounded-to-zero results: (-1e-7).toFixed(6)
    # is "-0.000000".
    return f"{sign}{s}"


def js_number_to_string(x: float) -> str:
    """JS default Number -> String conversion (shortest round-trip repr).

    Used by the vgraph interop where timestamps pass through JSON. Python's
    repr(float) is also shortest-round-trip, but JS prints integers without
    a trailing ``.0`` and uses ``e+21``-style exponents beyond 1e21.
    """
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == int(x) and abs(x) < 1e21:
        return str(int(x))
    r = repr(float(x))
    if "e" in r:
        mant, exp = r.split("e")
        ei = int(exp)
        if mant.endswith(".0"):
            mant = mant[:-2]
        return f"{mant}e{'+' if ei >= 0 else '-'}{abs(ei)}"
    return r
