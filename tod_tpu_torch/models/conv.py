"""Flax ``nn.Conv(padding="SAME")`` in NCHW.

Flax SAME padding puts the odd pixel at the bottom/right: a 3x3 stride-2 conv
on an even size pads 0 top/left and 1 bottom/right, which torch's symmetric
``padding=1`` does not reproduce.  Asymmetric cases go through ``F.pad``.

``Conv`` is the serving site (weights in the model's dtype, a ConvBN site's
BatchNorm folded into its bias).  ``TrainConv`` is the site of a model built
for training (``Training``): f32 parameters cast to the compute dtype for
the convolution, as Flax's ``nn.Conv(dtype=..., param_dtype=float32)``
computes, and no bias at a ConvBN site, whose BatchNorm follows unfolded.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.ops.padding import same_pads

__all__ = ["Conv", "TrainConv", "Training", "same_pads"]


@dataclasses.dataclass(frozen=True)
class Training:
    """The training form of a model's conv sites: the compute ``dtype``,
    and ``qat`` for fake-quantized dense convs (``models/qconv.QATConv``)."""

    dtype: torch.dtype = torch.bfloat16
    qat: bool = False


class Conv(nn.Module):
    """Conv with a bias (folded BatchNorm for ConvBN sites).  Parameters are
    left uninitialised: weights always come from ``core.weights``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def conv(self, x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
        """The SAME-padded convolution of ``x`` by ``weight`` (+ ``bias``)."""
        ph = same_pads(x.shape[-2], self.k, self.stride)
        pw = same_pads(x.shape[-1], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        return F.conv2d(x, weight, bias, self.stride, padding, 1, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias)


class TrainConv(Conv):
    """A conv site of the training graph: ``weight`` (and ``bias``, where
    the site has one) in f32, the convolution in ``dtype``, then the bias
    added in ``dtype``.

    On the CPU a bfloat16 convolution runs in f32 on the rounded values and
    rounds its result, as XLA's CPU backend computes it: torch's own CPU
    bfloat16 convolution backward returned non-finite weight gradients in 8
    of 200 calls on a 1x1 input at stride 2 (FPN's P7)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, k, stride, groups)
        if not bias:
            self.bias = None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.device.type == "cpu" and self.dtype != torch.float32:
            y = self.conv(x.float(), w.float()).to(self.dtype)
        else:
            y = self.conv(x, w)
        return y if self.bias is None else y + self.bias.to(self.dtype).view(1, -1, 1, 1)
