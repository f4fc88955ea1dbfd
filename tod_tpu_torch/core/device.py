"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    ``None`` means ``cuda``.  Asking for CUDA where no card is visible raises
    instead of quietly moving the work to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions"
        )
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The SM count of a CUDA device, which the kernels' tilings take."""
    return torch.cuda.get_device_properties(dev).multi_processor_count
