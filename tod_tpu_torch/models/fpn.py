"""Feature pyramid P3..P7 (counterpart of the JAX package's ``models/fpn.py``): 1x1
laterals, top-down bilinear upsample + add, 3x3 smoothing with ReLU, then
stride-2 3x3 convs for P6/P7."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tod_tpu_torch.models.qconv import make_conv


def upsample_to(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (``jax.image.resize`` linear
    when upsampling), in the input dtype."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class FPN(nn.Module):
    def __init__(self, in_channels, channels: int = 128, levels: int = 5,
                 quantized: bool = False):
        super().__init__()
        c3, c4, c5 = in_channels
        q = quantized
        self.lat5 = make_conv(q, c5, channels, 1)
        self.lat4 = make_conv(q, c4, channels, 1)
        self.lat3 = make_conv(q, c3, channels, 1)
        for i in (3, 4, 5):
            self.add_module(f"smooth{i}", make_conv(q, channels, channels, 3))
        self.n_down = levels - 3
        for i in range(self.n_down):
            self.add_module(f"down{6 + i}", make_conv(q, channels, channels, 3, stride=2))

    def forward(self, c3, c4, c5):
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + upsample_to(p5, c4.shape[-2:])
        p3 = self.lat3(c3) + upsample_to(p4, c3.shape[-2:])
        p3 = torch.relu(self.smooth3(p3))
        p4 = torch.relu(self.smooth4(p4))
        p5 = torch.relu(self.smooth5(p5))
        pyramid = [p3, p4, p5]
        x = p5
        for i in range(self.n_down):
            x = getattr(self, f"down{6 + i}")(x)
            pyramid.append(x)
        return pyramid
