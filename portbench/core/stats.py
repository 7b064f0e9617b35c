"""The yardstick's statistics and comparisons.

``summary`` is what a Monte-Carlo statistics job returns, worked out
from the reference's per-variant responses: mean, population standard
deviation, min, max and the quantiles by linear interpolation between
order statistics at q/100 (n - 1) (NumPy's default). ``gap`` compares two
such summaries row by row, each row's largest difference against that
row's largest reference value, and returns the worst row's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS = ("mean", "std", "min", "max")


def quantile_name(q: float) -> str:
    return f"p{q:g}"


def summary(resp: torch.Tensor, quantiles: tuple[float, ...],
            block: int = 256) -> dict[str, np.ndarray]:
    """resp (B, G) on any device -> {row: (G,) float64 on the host}."""
    B, G = resp.shape
    out = {k: np.empty(G) for k in ROWS}
    for q in quantiles:
        out[quantile_name(q)] = np.empty(G)
    for c0 in range(0, G, block):
        r = resp[:, c0:c0 + block].to(torch.float64)
        mean = r.mean(dim=0)
        out["mean"][c0:c0 + block] = mean.cpu().numpy()
        out["std"][c0:c0 + block] = (
            ((r - mean) ** 2).mean(dim=0).sqrt().cpu().numpy())
        srt = torch.sort(r, dim=0).values
        out["min"][c0:c0 + block] = srt[0].cpu().numpy()
        out["max"][c0:c0 + block] = srt[-1].cpu().numpy()
        for q in quantiles:
            pos = q / 100.0 * (B - 1)
            lo, hi = math.floor(pos), math.ceil(pos)
            w = pos - lo
            val = srt[lo] * (1.0 - w) + srt[hi] * w
            out[quantile_name(q)][c0:c0 + block] = val.cpu().numpy()
    return out


def gap(program: dict[str, np.ndarray], reference: dict[str, np.ndarray]
        ) -> float:
    """max over rows of max |program - reference| / max |reference|; a
    row missing from the program, or a NaN in it, reads infinite."""
    worst = 0.0
    for row, ref in reference.items():
        got = program.get(row)
        if got is None or got.shape != ref.shape or not np.all(
                np.isfinite(got)):
            return math.inf
        scale = float(np.max(np.abs(ref)))
        diff = float(np.max(np.abs(got - ref)))
        worst = max(worst, diff / scale if scale > 0 else diff)
    return worst
