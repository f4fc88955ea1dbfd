"""ResNet backbones 18/34/50 returning C3/C4/C5 at strides 8/16/32
(counterpart of the JAX package's ``models/resnet.py``).

Submodule names repeat the Flax tree's (``Conv_0``, ``BasicBlock_3``,
``conv1``, ``bn_down`` ...).  Only the stem's ``Conv_0`` + ``BatchNorm_0``
pair arrives folded (``core/weights.carry_across``, as the JAX
``fold_batchnorm`` folds only such pairs): the stem is a ConvBN site.  The
blocks' ``bn1``, ``bn2``, ``bn3`` and ``bn_down`` stay BatchNorms, computed
in f32 from the running statistics on the conv's output and cast back to
the compute dtype, as the JAX blocks do; their convs have no bias (a zero
bias here).  With ``quantized`` every conv is a ``QConv``: the stem a 7x7
stride-2 site with Cin = 3 (the int8 kernel's flat K = 147).

Built for training (a ``models.conv.Training`` mode) every BatchNorm is a
``TrainBatchNorm`` and no conv has a bias, the stem's ``BatchNorm_0``
included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.models.conv import Training
from tod_tpu_torch.models.qconv import make_conv
from tod_tpu_torch.ops.padding import same_pads

BN_EPS = 1e-5  # Flax nn.BatchNorm's epsilon
BN_MOMENTUM = 0.97  # the JAX models' nn.BatchNorm(momentum=0.97)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(use_running_average=True, dtype=float32)`` in
    NCHW: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32.  Its
    tensors stay f32 in a bf16 model (``keep_f32``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.empty(channels))
        self.register_buffer("var", torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        return ((x.float() - self.mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
                + self.bias.view(1, -1, 1, 1))


class TrainBatchNorm(BatchNorm):
    """Flax ``nn.BatchNorm(momentum=0.97, dtype=float32)`` in a model built
    for training.  In training mode it normalizes by the batch's statistics
    in f32, Flax's way: the mean and the biased variance E[x^2] - E[x]^2,
    clipped at 0; and updates ``mean`` and ``var`` to ``0.97 running + 0.03
    batch`` with that biased variance (``nn.BatchNorm2d`` would use the
    unbiased one).  The parameters are initialised as Flax's: scale and var
    one, bias and mean zero.  In eval mode it is :class:`BatchNorm`."""

    def __init__(self, channels: int):
        super().__init__(channels)
        for t in (self.scale, self.var):
            nn.init.ones_(t)
        for t in (self.bias, self.mean):
            nn.init.zeros_(t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


def block_conv(mode, cin: int, cout: int, k: int, stride: int = 1):
    """A block's conv site: bias-free in the training form (the JAX convs'
    ``use_bias=False``), with a zero bias in the serving form."""
    return make_conv(mode, cin, cout, k, stride, bn=isinstance(mode, Training))


def make_bn(mode, channels: int) -> BatchNorm:
    """A BatchNorm site: ``TrainBatchNorm`` in a model built for training."""
    return TrainBatchNorm(channels) if isinstance(mode, Training) else BatchNorm(channels)


def keep_f32(model: nn.Module, state) -> None:
    """Put every ``BatchNorm`` of ``model`` back to f32 with its values from
    the f32 state dict ``state`` (after a blanket ``model.to(dtype)``)."""
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.float()
            m.load_state_dict({k: state[f"{name}.{k}"] for k in m.state_dict()})


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, quantized: bool = False):
        super().__init__()
        q = quantized
        self.conv1 = block_conv(q, cin, features, 3, stride)
        self.bn1 = make_bn(q, features)
        self.conv2 = block_conv(q, features, features, 3)
        self.bn2 = make_bn(q, features)
        self.has_down = stride != 1 or cin != features
        if self.has_down:
            self.down = block_conv(q, cin, features, 1, stride)
            self.bn_down = make_bn(q, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        y = torch.relu(self.bn1(self.conv1(x)).to(dtype))
        y = self.bn2(self.conv2(y)).to(dtype)
        if self.has_down:
            x = self.bn_down(self.down(x)).to(dtype)
        return torch.relu(y + x)


class Bottleneck(nn.Module):
    expansion = 4  # output = 4 * features

    def __init__(self, cin: int, features: int, stride: int = 1, quantized: bool = False):
        super().__init__()
        q = quantized
        out = features * 4
        self.conv1 = block_conv(q, cin, features, 1)
        self.bn1 = make_bn(q, features)
        self.conv2 = block_conv(q, features, features, 3, stride)
        self.bn2 = make_bn(q, features)
        self.conv3 = block_conv(q, features, out, 1)
        self.bn3 = make_bn(q, out)
        self.has_down = stride != 1 or cin != out
        if self.has_down:
            self.down = block_conv(q, cin, out, 1, stride)
            self.bn_down = make_bn(q, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        y = torch.relu(self.bn1(self.conv1(x)).to(dtype))
        y = torch.relu(self.bn2(self.conv2(y)).to(dtype))
        y = self.bn3(self.conv3(y)).to(dtype)
        if self.has_down:
            x = self.bn_down(self.down(x)).to(dtype)
        return torch.relu(y + x)


RESNETS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """Flax ``nn.max_pool(padding="SAME")``: the odd pixel of padding at the
    bottom and right, padded with -inf."""
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


class ResNet(nn.Module):
    """NCHW input -> (C3, C4, C5)."""

    def __init__(self, variant: str = "resnet18", quantized: bool = False):
        super().__init__()
        if variant not in RESNETS:
            raise ValueError(f"unknown ResNet {variant!r}; known: {sorted(RESNETS)}")
        block, depths = RESNETS[variant]
        self.Conv_0 = make_conv(quantized, 3, 64, 7, 2, bn=True)  # the folded stem
        self.train_form = isinstance(quantized, Training)
        if self.train_form:  # the stem's BatchNorm, unfolded
            self.BatchNorm_0 = TrainBatchNorm(64)
        cin, idx, self.taps = 64, 0, []
        for i, (feats, n) in enumerate(zip((64, 128, 256, 512), depths)):
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"{block.__name__}_{idx}",
                                block(cin, feats, stride, quantized))
                cin = feats * block.expansion
                idx += 1
            self.taps.append(idx - 1)
        self.n_blocks = idx
        self.block_name = block.__name__
        self.out_channels = tuple(f * block.expansion for f in (128, 256, 512))

    def forward(self, x: torch.Tensor):
        y = self.Conv_0(x)
        if self.train_form:
            y = self.BatchNorm_0(y).to(y.dtype)
        x = max_pool_same(torch.relu(y))
        taps = []
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
            if i in self.taps:
                taps.append(x)
        return taps[1], taps[2], taps[3]
