"""Flax ``nn.Conv(padding="SAME")`` in NCHW.

Flax SAME padding puts the odd pixel at the bottom/right: a 3x3 stride-2 conv
on an even size pads 0 top/left and 1 bottom/right, which torch's symmetric
``padding=1`` does not reproduce.  Asymmetric cases go through ``F.pad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.ops.padding import same_pads

__all__ = ["Conv", "same_pads"]


class Conv(nn.Module):
    """Conv with a bias (folded BatchNorm for ConvBN sites).  Parameters are
    left uninitialised: weights always come from ``core.weights``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(x.shape[-2], self.k, self.stride)
        pw = same_pads(x.shape[-1], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        return F.conv2d(x, self.weight, self.bias, self.stride, padding, 1, self.groups)
