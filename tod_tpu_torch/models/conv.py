"""Flax ``nn.Conv(padding="SAME")`` in NCHW.

Flax SAME padding puts the odd pixel at the bottom/right: a 3x3 stride-2 conv
on an even size pads 0 top/left and 1 bottom/right, which torch's symmetric
``padding=1`` does not reproduce.  Asymmetric cases go through ``F.pad``.

``Conv`` is the serving site (weights in the model's dtype, a ConvBN site's
BatchNorm folded into its bias).  ``TrainConv`` is the site of a model built
for training (``Training``): f32 parameters cast to the compute dtype for
the convolution, as Flax's ``nn.Conv(dtype=..., param_dtype=float32)``
computes, and no bias at a ConvBN site, whose BatchNorm follows unfolded.

``ModelConfig.s2d_stem`` and ``depthwise_shifted`` give a site another
form of the same convolution, in serving and in training alike: the
stride-2 stem on the space-to-depth input (``S2DSite``, ``ops/s2d.py``),
and the depthwise conv as shifted multiply-adds (``ShiftedConv``,
``TrainShiftedConv``, ``ops/depthwise.py``).  ``models/mobilenetv2.py``
picks the sites as the JAX ``ConvBN`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.ops.depthwise import depthwise_conv_shifted
from tod_tpu_torch.ops.padding import same_pads
from tod_tpu_torch.ops.s2d import s2d_stem_conv

__all__ = ["Conv", "TrainConv", "Training", "same_pads", "S2DConv", "TrainS2DConv",
           "ShiftedConv", "TrainShiftedConv"]


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

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
             groups: int | None = None) -> torch.Tensor:
        """The SAME-padded convolution of ``x`` by ``weight`` (+ ``bias``),
        in the site's ``groups`` unless given (a tensor-parallel piece of a
        depthwise site has fewer)."""
        ph = same_pads(x.shape[-2], self.k, self.stride)
        pw = same_pads(x.shape[-1], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        return F.conv2d(x, weight, bias, self.stride, padding, 1,
                        self.groups if groups is None else groups)

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
        return self.finish(self.compute(x))

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without the bias (a tensor-parallel site gathers
        its output channels between the two, ``parallel/sharding.py``)."""
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.device.type == "cpu" and self.dtype != torch.float32:
            return self.conv(x.float(), w.float()).to(self.dtype)
        return self.conv(x, w)

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The bias, where the site has one, added in ``dtype``."""
        return y if self.bias is None else y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class S2DSite:
    """Mixed into a 3x3 stride-2 site (the stem): the convolution on the
    space-to-depth input where H and W are even (the JAX ``MobileNetV2``
    takes its ``S2DStemConv`` only then), else the plain one."""

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
             groups: int | None = None) -> torch.Tensor:
        if x.shape[-2] % 2 or x.shape[-1] % 2:
            return super().conv(x, weight, bias, groups)
        return s2d_stem_conv(x, weight, bias)


class S2DConv(S2DSite, Conv):
    """The serving stem with ``ModelConfig.s2d_stem``."""


class TrainS2DConv(S2DSite, TrainConv):
    """The training stem with ``ModelConfig.s2d_stem``: the weights cast to
    ``dtype``, as the JAX ``S2DStemConv`` casts its kernel to the input's."""


class ShiftedConv(Conv):
    """A serving depthwise site with ``ModelConfig.depthwise_shifted``: the
    shifted form, rounded to the compute dtype, then the (folded BatchNorm's)
    bias added in that dtype, as the JAX graph adds its BatchNorm after the
    ``DepthwiseShifted`` cast."""

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
             groups: int | None = None) -> torch.Tensor:
        y = depthwise_conv_shifted(x, weight, self.stride)
        return y if bias is None else y + bias.to(y.dtype).view(1, -1, 1, 1)


class TrainShiftedConv(TrainConv):
    """A training depthwise site with ``ModelConfig.depthwise_shifted``: the
    input in ``dtype`` times the f32 weights (the JAX ``DepthwiseShifted``
    does not round its kernel), summed in f32, rounded to ``dtype``."""

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv_shifted(x.to(self.dtype), self.weight, self.stride)
