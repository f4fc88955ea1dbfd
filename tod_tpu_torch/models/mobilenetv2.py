"""MobileNetV2 backbone returning the C3/C4/C5 taps at strides 8/16/32
(counterpart of the JAX package's ``models/mobilenetv2.py``).  BatchNorm arrives
folded into each conv's weight and bias; with ``quantized`` each conv is a
``QConv`` that adds that bias as the folded BatchNorm does.  Built for
training (a ``models.conv.Training`` mode), each ConvBN is the JAX training
graph's: a conv with no bias, ``BatchNorm_0`` in f32 on batch statistics,
ReLU6, then the compute dtype; in training mode the three after the conv
are ``kernels/bn_train.bn_act`` on the conv's output in channels last (one
kernel pair on the card; the plain graph on the CPU, or over a dp mesh,
``moments_over`` set, on the global batch's moments).

``dw_shifted`` and ``s2d_stem`` (``ModelConfig.depthwise_shifted`` and
``s2d_stem``) route the sites as the JAX ``ConvBN`` does: the
space-to-depth stem only at a float (not int8, not QAT) 3x3 stride-2 site
that is not depthwise, the shifted depthwise only where ``shifted_wins``
holds (in a quantized model, in ``QConv``'s float branch)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tod_tpu_torch.kernels.bn_train import bn_act, relu6
from tod_tpu_torch.models.conv import Training
from tod_tpu_torch.models.qconv import make_conv
from tod_tpu_torch.models.resnet import TrainBatchNorm
from tod_tpu_torch.ops.depthwise import shifted_wins
from tod_tpu_torch.runtime.profiler import count


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBN(nn.Module):
    """Conv + folded BN (+ ReLU6); in the training form conv, BN, ReLU6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True, quantized=False, dw_shifted: bool = False,
                 s2d: bool = False):
        super().__init__()
        depthwise = groups > 1 and groups == cin
        quant = quantized.qat if isinstance(quantized, Training) else bool(quantized)
        form = None
        if s2d and not quant and not depthwise and kernel == 3 and stride == 2:
            form = "s2d"
        elif depthwise and dw_shifted and shifted_wins(cin, stride):
            form = "shifted"
        self.Conv_0 = make_conv(quantized, cin, cout, kernel, stride, groups, bn=True, form=form)
        self.act = act
        self.train_form = isinstance(quantized, Training)
        if self.train_form:
            self.BatchNorm_0 = TrainBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if not self.train_form:
            return x.clamp(0.0, 6.0) if self.act else x
        bn = self.BatchNorm_0
        if not bn.training:
            y = bn(x)  # on the running statistics
            return (relu6(y) if self.act else y).to(x.dtype)
        count("train/bn_sites")
        # channels last, as the NHWC input gives it, at every site: the
        # s2d stem, the shifted depthwise and a tp gather give NCHW
        x = x.contiguous(memory_format=torch.channels_last)
        return bn_act(x, bn.scale, bn.bias, bn.mean, bn.var, self.act, bn.moments_over)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, features: int, stride: int, expand: int,
                 quantized=False, dw_shifted: bool = False):
        super().__init__()
        hidden = inp * expand
        q = quantized
        layers = []
        if expand != 1:
            layers.append(ConvBN(inp, hidden, kernel=1, quantized=q))
        layers.append(ConvBN(hidden, hidden, kernel=3, stride=stride, groups=hidden, quantized=q,
                             dw_shifted=dw_shifted))
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

    def __init__(self, width_mult: float = 1.0, quantized=False, dw_shifted: bool = False,
                 s2d_stem: bool = False):
        super().__init__()
        cin = _make_divisible(32 * width_mult)
        self.ConvBN_0 = ConvBN(3, cin, stride=2, quantized=quantized, s2d=s2d_stem)
        self.tap_after: dict[int, str] = {}
        idx = 0
        for stage, (t, c, n, s) in enumerate(_MNV2_CFG):
            feats = _make_divisible(c * width_mult)
            for i in range(n):
                block = InvertedResidual(cin, feats, s if i == 0 else 1, t, quantized,
                                         dw_shifted)
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
