"""Division and square root that round the same on every device.

On CUDA, torch computes ``tensor / python_scalar`` as a multiplication by the
scalar's reciprocal and ``python_scalar / tensor`` as ``reciprocal(tensor) *
scalar``: two roundings instead of one.  Where a floor or a compare follows,
that moves results across integer boundaries.  These helpers divide by (or
into) a 0-dim tensor on the same device, which is one IEEE division
everywhere, as in the JAX reference.

torch's float32 ``sqrt`` on the CPU is within half an ulp but not always
correctly rounded.  The float64 root of a float32 value, rounded once to
float32, is the correctly rounded float32 root on every device.
"""

from __future__ import annotations

import torch


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with IEEE rounding."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def rdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` (scalar over tensor) with IEEE rounding."""
    return torch.full((), a, dtype=b.dtype, device=b.device) / b


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float32 tensor."""
    return torch.sqrt(x.double()).to(x.dtype)
