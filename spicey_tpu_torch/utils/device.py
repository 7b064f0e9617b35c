"""Where the port's entry points run.

Every public entry point takes ``device=None``, which means the CUDA
card: the port exists to run there. The CPU runs only when the caller
asks for it with ``device="cpu"`` (the tests do, to run the kernels'
plain versions); with no card and no explicit CPU an entry point raises
rather than quietly running elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` -> the CUDA card, raising ``RuntimeError`` when there is
    none; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spicey_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
