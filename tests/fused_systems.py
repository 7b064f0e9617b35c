"""Dense random systems for the fused AC kernels' pattern tables.

``dense_pattern(n)`` is a stamp pattern (``build_stamp_pattern``'s
format) with every (i, j) entry of both planes stamped from a value row of
its own, and on the diagonal extra terms of every other kind (``inv``,
``one``, ``winv``) that cancel in pairs, so the kernels evaluate each kind
and an all-zero value column still gives an exactly zero system: with v =
0 the sums run 0 + a - a + 1 - 1. ``dense_values`` draws the values with
variant 0 all zero and variant 1 with matrix row n // 2 zero (both
singular), the rest diagonally dominant. At the frequencies ``FREQS``
(w = 2 pi f <= 1.3) the imaginary parts stay at the real parts' scale,
so every other system is well conditioned, in f32 too (at kHz the random
imaginary parts swamp the dominant diagonal and two f32 eliminations
differ by more than 1e-5). Shared by the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 2; imports
nothing of JAX.
"""

from __future__ import annotations

import numpy as np

FREQS = (0.01, 0.1, 0.2)


def _row(n: int, plane: int, i: int, j: int) -> int:
    """Value row of entry (i, j) of ``plane``; row 0 is the cancelling
    terms' value, in [1, 2] for every variant."""
    return 1 + 2 * (i * (n + 1) + j) + plane


def dense_pattern(n: int) -> tuple:
    re_t, im_t = [], []
    for i in range(n):
        for j in range(n + 1):
            re = [("lin", _row(n, 0, i, j), 1.0)]
            im = [("w", _row(n, 1, i, j), 1.0)]
            if i == j:
                re += [("inv", 0, 1.0), ("inv", 0, -1.0), ("one", 0, 1.0),
                       ("one", 0, -1.0)]
                im += [("winv", 0, 1.0), ("winv", 0, -1.0)]
            re_t.append(((i, j), tuple(re)))
            im_t.append(((i, j), tuple(im)))
    return 1 + 2 * n * (n + 1), tuple(re_t), tuple(im_t)


def dense_values(n: int, B: int, seed: int = 0) -> np.ndarray:
    """(n_rows, B) float64 values for ``dense_pattern(n)``."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((1 + 2 * n * (n + 1), B))
    vals[0] = rng.uniform(1.0, 2.0, B)
    for i in range(n):
        vals[_row(n, 0, i, i)] += n
    vals[1:, 0] = 0.0                      # an all-zero system
    for j in range(n):                     # a zero row
        vals[[_row(n, 0, n // 2, j), _row(n, 1, n // 2, j)], 1] = 0.0
    return vals
