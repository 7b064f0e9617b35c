"""The general generator: a cell's traffic parameters -> every job's inputs.

A job is one user call of a Monte-Carlo analysis on ``variants_per_job``
variants. Its inputs are the swept elements' values, each the nominal
value that the configuration's ``sweep`` states times a draw from its
distribution. Job ``j`` of seed ``s`` draws from its own generator,
seeded by ``numpy.random.SeedSequence([s, j])``, so a job's inputs do not
depend on how many jobs a run draws, and every job draws fresh values.
The warm-up job of set-up is job ``WARM`` (never timed). The draws run on
the card (``torch.Generator``), one call a job, and cross to the host in
one copy through a pinned buffer: the program takes NumPy arrays, as a
user's script hands them over.
"""

from __future__ import annotations

import numpy as np
import torch

WARM = 2**40          # the set-up job's index, beyond any timed job's


def job_seed(seed: int, job: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(job)])
               .generate_state(1, np.uint64)[0] >> 1)


class Stream:
    """The jobs of one seed: ``job(j)`` draws job ``j``'s overrides,
    {element: (variants,) float64}, each array its own."""

    def __init__(self, config: dict, seed: int, variants: int,
                 device: torch.device):
        sweep = config["sweep"]
        if sweep["dist"] != "uniform":
            raise ValueError(f"unknown sweep distribution {sweep['dist']!r}")
        self.names = list(sweep["elements"])
        self.lo, self.hi = float(sweep["low"]), float(sweep["high"])
        self.seed, self.variants, self.device = int(seed), variants, device
        self.base = torch.tensor([float(sweep["nominal"][n])
                                  for n in self.names],
                                 dtype=torch.float64, device=device)[:, None]
        self.gen = torch.Generator(device=device)
        shape = (len(self.names), variants)
        self.out = torch.empty(shape, dtype=torch.float64, device=device)
        self.stage = torch.empty(shape, dtype=torch.float64,
                                 pin_memory=device.type == "cuda")

    def job(self, j: int) -> dict[str, np.ndarray]:
        self.gen.manual_seed(job_seed(self.seed, j))
        torch.rand(self.out.shape, dtype=torch.float64, generator=self.gen,
                   device=self.device, out=self.out)
        self.out.mul_(self.hi - self.lo).add_(self.lo).mul_(self.base)
        self.stage.copy_(self.out)
        host = self.stage.numpy().copy()
        return {n: host[i] for i, n in enumerate(self.names)}
