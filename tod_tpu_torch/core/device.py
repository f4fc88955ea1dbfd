"""Device selection shared by every entry point of the port."""

from __future__ import annotations

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
