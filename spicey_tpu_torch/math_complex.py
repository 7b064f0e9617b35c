"""Complex value helper mirroring the reference's exported Complex class.

Contract: spicey/lib/math/Complex.ts:3-62 (exported from
lib/index.ts:10). The engine itself never uses this class — the solves run
on real planes (see ops/linsolve.py) and results carry NumPy complex128 —
but the reference exports `Complex` on its public surface,
so a drop-in equivalent is provided: value-semantics arithmetic, EPS-guarded
division, degree-based polar helpers.
"""

from __future__ import annotations

import math

from .constants import EPS


class Complex:
    __slots__ = ("re", "im")

    def __init__(self, re: float = 0.0, im: float = 0.0):
        self.re = float(re)
        self.im = float(im)

    @staticmethod
    def from_(re: float, im: float = 0.0) -> "Complex":
        return Complex(re, im)

    # JS-style alias
    from_polar = None  # replaced below

    @staticmethod
    def fromPolar(mag: float, deg: float = 0.0) -> "Complex":
        ph = deg * math.pi / 180.0
        return Complex(mag * math.cos(ph), mag * math.sin(ph))

    def clone(self) -> "Complex":
        return Complex(self.re, self.im)

    def add(self, b: "Complex") -> "Complex":
        return Complex(self.re + b.re, self.im + b.im)

    def sub(self, b: "Complex") -> "Complex":
        return Complex(self.re - b.re, self.im - b.im)

    def mul(self, b: "Complex") -> "Complex":
        return Complex(
            self.re * b.re - self.im * b.im,
            self.re * b.im + self.im * b.re,
        )

    def div(self, b: "Complex") -> "Complex":
        d = b.re * b.re + b.im * b.im
        if d < EPS:
            raise ZeroDivisionError("Complex divide by ~0")
        return Complex(
            (self.re * b.re + self.im * b.im) / d,
            (self.im * b.re - self.re * b.im) / d,
        )

    def inv(self) -> "Complex":
        d = self.re * self.re + self.im * self.im
        if d < EPS:
            raise ZeroDivisionError("Complex invert by ~0")
        return Complex(self.re / d, -self.im / d)

    def abs(self) -> float:
        return math.hypot(self.re, self.im)

    def phaseDeg(self) -> float:
        return math.atan2(self.im, self.re) * 180.0 / math.pi

    # pythonic aliases
    phase_deg = phaseDeg

    def __complex__(self) -> complex:
        return complex(self.re, self.im)

    def __repr__(self) -> str:
        return f"Complex({self.re}, {self.im})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Complex)
            and self.re == other.re
            and self.im == other.im
        )

    def __hash__(self):
        return hash((self.re, self.im))


Complex.from_polar = Complex.fromPolar
