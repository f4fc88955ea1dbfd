"""MobileNetV2 backbone returning the C3/C4/C5 taps at strides 8/16/32
(counterpart of the JAX package's ``models/mobilenetv2.py``).  BatchNorm arrives
folded into each conv's weight and bias; with ``quantized`` each conv is a
``QConv`` that adds that bias as the folded BatchNorm does.  Built for
training (a ``models.conv.Training`` mode), each ConvBN is the JAX training
graph's: a conv with no bias, ``BatchNorm_0`` in f32 on batch statistics,
ReLU6, then the compute dtype."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tod_tpu_torch.models.conv import Training
from tod_tpu_torch.models.qconv import make_conv
from tod_tpu_torch.models.resnet import TrainBatchNorm


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu6``, whose gradient is 0 at 0 and at 6 (``clamp``'s is 1
    there: a channel that BatchNorm maps to exactly 0 would pass it on)."""
    return torch.where((x > 0) & (x < 6), x, x.detach().clamp(0.0, 6.0))


class ConvBN(nn.Module):
    """Conv + folded BN (+ ReLU6); in the training form conv, BN, ReLU6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True, quantized=False):
        super().__init__()
        self.Conv_0 = make_conv(quantized, cin, cout, kernel, stride, groups, bn=True)
        self.act = act
        self.train_form = isinstance(quantized, Training)
        if self.train_form:
            self.BatchNorm_0 = TrainBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.train_form:
            y = self.BatchNorm_0(x)
            return (relu6(y) if self.act else y).to(x.dtype)
        return x.clamp(0.0, 6.0) if self.act else x


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, features: int, stride: int, expand: int,
                 quantized=False):
        super().__init__()
        hidden = inp * expand
        q = quantized
        layers = []
        if expand != 1:
            layers.append(ConvBN(inp, hidden, kernel=1, quantized=q))
        layers.append(ConvBN(hidden, hidden, kernel=3, stride=stride, groups=hidden, quantized=q))
        layers.append(ConvBN(hidden, features, kernel=1, act=False, quantized=q))
        for i, layer in enumerate(layers):
            self.add_module(f"ConvBN_{i}", layer)
        self.n_layers = len(layers)
        self.skip = stride == 1 and inp == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_layers):
            y = getattr(self, f"ConvBN_{i}")(y)
        return y + x if self.skip else y


# (expand_ratio, channels, num_blocks, first_stride)
_MNV2_CFG: Sequence[tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),  # -> C3
    (6, 64, 4, 2),
    (6, 96, 3, 1),  # -> C4
    (6, 160, 3, 2),
    (6, 320, 1, 1),  # -> C5
)
_TAPS = {2: "c3", 4: "c4", 6: "c5"}


class MobileNetV2(nn.Module):
    """NCHW input -> (C3, C4, C5)."""

    def __init__(self, width_mult: float = 1.0, quantized=False):
        super().__init__()
        cin = _make_divisible(32 * width_mult)
        self.ConvBN_0 = ConvBN(3, cin, stride=2, quantized=quantized)
        self.tap_after: dict[int, str] = {}
        idx = 0
        for stage, (t, c, n, s) in enumerate(_MNV2_CFG):
            feats = _make_divisible(c * width_mult)
            for i in range(n):
                block = InvertedResidual(cin, feats, s if i == 0 else 1, t, quantized)
                self.add_module(f"InvertedResidual_{idx}", block)
                cin = feats
                idx += 1
            if stage in _TAPS:
                self.tap_after[idx - 1] = _TAPS[stage]
        self.n_blocks = idx
        self.out_channels = tuple(
            _make_divisible(_MNV2_CFG[s][1] * width_mult) for s in _TAPS
        )

    def forward(self, x: torch.Tensor):
        x = self.ConvBN_0(x)
        taps = {}
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
            if i in self.tap_after:
                taps[self.tap_after[i]] = x
        return taps["c3"], taps["c4"], taps["c5"]
