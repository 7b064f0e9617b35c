"""Points-per-decade log frequency grid.

Contract: spicey/lib/utils/logspace.ts:3-15 — points at
``f1 * 10^(i/N)`` for i = 0..ceil(decades*N), with the exact stop frequency
appended when the last generated point falls short of ``f2 * (1 - EPS)``.
Host-side float64 NumPy; the grid is tiny and feeds the compiled AC solve.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import EPS


def logspace(f1: float, f2: float, points_per_decade: int) -> np.ndarray:
    if f1 <= 0 or f2 <= 0:
        raise ValueError(".ac frequencies must be > 0")
    if f2 < f1:
        f1, f2 = f2, f1
    decades = math.log10(f2 / f1)
    n = max(1, math.ceil(decades * points_per_decade))
    arr = [f1 * math.pow(10.0, i / points_per_decade) for i in range(n + 1)]
    if arr[-1] < f2 * (1 - EPS):
        arr.append(f2)
    return np.asarray(arr, dtype=np.float64)


def octspace(f1: float, f2: float, points_per_octave: int) -> np.ndarray:
    """Points-per-octave grid (extended-dialect ``.ac oct``; the reference
    throws on any mode but dec/lin, simulateAC-adjacent parseNetlist.ts:
    165-179). Same structure as :func:`logspace` with base 2: points at
    ``f1 * 2^(i/N)``, exact stop appended when the last point falls short."""
    if f1 <= 0 or f2 <= 0:
        raise ValueError(".ac frequencies must be > 0")
    if f2 < f1:
        f1, f2 = f2, f1
    octaves = math.log2(f2 / f1)
    n = max(1, math.ceil(octaves * points_per_octave))
    arr = [f1 * math.pow(2.0, i / points_per_octave) for i in range(n + 1)]
    if arr[-1] < f2 * (1 - EPS):
        arr.append(f2)
    return np.asarray(arr, dtype=np.float64)


def linear_grid(f1: float, f2: float, N: int) -> np.ndarray:
    """Linear .ac grid: max(2, N) evenly spaced points inclusive
    (spicey/lib/analysis/simulateAC.ts:17-21)."""
    npts = max(2, N)
    step = (f2 - f1) / (npts - 1)
    return np.asarray([f1 + i * step for i in range(npts)], dtype=np.float64)
