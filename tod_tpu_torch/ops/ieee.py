"""Division and square root that round the same on every device.

On CUDA, torch computes ``tensor / python_scalar`` as a multiplication by the
scalar's reciprocal and ``python_scalar / tensor`` as ``reciprocal(tensor) *
scalar``: two roundings instead of one.  Where a floor or a compare follows,
that moves results across integer boundaries.  These helpers divide by (or
into) a 0-dim tensor on the same device, which is one IEEE division
everywhere, as in the JAX reference.

Compiled XLA contracts a product and a sum into one fused multiply-add
where the graph allows it; ``fma`` rounds ``a * b + c`` once, as the card's
``fmaf`` does.

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


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors (broadcast) rounded once to float32.

    The float64 product of two float32 values is exact; the float64 sum is
    rounded to odd (its error, from TwoSum, moves an inexact sum with an
    even last bit one float64 ulp toward the exact value), and a sum rounded
    to odd with 29 spare bits rounds to float32 as the exact value does."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()
