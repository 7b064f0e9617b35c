"""Where the port's entry points run.

Every public entry point takes ``device=None``, which means the CUDA
card: the port exists to run there. The CPU runs only when the caller
asks for it with ``device="cpu"`` (the tests do, to run the kernels'
plain versions); with no card and no explicit CPU an entry point raises
rather than quietly running elsewhere. The batched entry points also take
``device_put=sharder(mesh)`` (parallel/mesh.py): their results then
gather on the mesh's first device, which ``device=None`` means there.
"""

from __future__ import annotations

import time
from collections.abc import Callable

import torch

from ..parallel.mesh import as_device, mesh_of

WARMUP_DECK = ("warmup deck\n"
               "v1 1 0 dc 0 ac 1 PULSE(0 1 0 1n 1n 5u 10u)\n"
               "r1 1 2 1k\n"
               "c1 2 0 1u\n"
               ".ac dec 10 1 100\n"
               ".tran 1u 10u\n"
               ".end\n")


def resolve_device(device: torch.device | str | None,
                   device_put: Callable | None = None) -> torch.device:
    """``None`` -> the CUDA card, raising ``RuntimeError`` when there is
    none; anything else as given. With ``device_put`` (a ``sharder``):
    the mesh's first device, and a ``device`` naming another one raises
    ``ValueError``."""
    if device_put is not None:
        first = mesh_of(device_put).first
        if device is not None and as_device(device) != first:
            raise ValueError(
                f"device={device!r} is not the mesh's first device {first}, "
                "where a sharded call gathers its results")
        return first
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spicey_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def warmup(full: bool = False,
           device: torch.device | str | None = None) -> float:
    """Create the CUDA context before latency-sensitive work.

    The first blocking round trip to the card in a process pays for the
    CUDA context; nothing about that cost belongs to any analysis, so
    interactive users and benchmarks can pay it here, up front, where it
    is visible. Returns the seconds of that round trip.

    ``full=True`` also builds every kernel library not built yet (one
    nvcc process per source, all started together; ops/_build.py) and
    runs a minimal AC + TRAN deck through ``simulate``, so its kernels
    are loaded. Runs on the card unless ``device="cpu"``; with no card
    and no explicit CPU it raises.
    """
    device = resolve_device(device)
    t0 = time.perf_counter()
    torch.zeros((1,), device=device).cpu()
    seconds = time.perf_counter() - t0
    if full:
        from ..analysis.simulate import simulate
        from ..ops import _build

        if device.type == "cuda":
            _build.build(list(_build.LIBRARIES))
        simulate(WARMUP_DECK, device=device)
    return seconds
