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
    when upsampling), in the input dtype.  Where a gradient is asked for,
    its backward is :class:`_Upsample`'s, which is deterministic."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upsample.apply(x, tuple(hw))
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float32 on ``device``: the weights
    ``F.interpolate(mode="bilinear", align_corners=False)`` gives one axis,
    with its source index ``in / out * (i + 0.5) - 0.5`` clamped at 0.
    Built on the device: a host-built copy would wait on the card."""
    scale = torch.full((), n_in, dtype=torch.float32, device=device) / n_out
    src = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * scale
           - 0.5).clamp_min(0.0)
    i0 = src.long().clamp_max(n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    w1 = src - i0.float()
    cols = torch.arange(n_in, device=device)
    zero = torch.zeros((), device=device)
    return (torch.where(cols == i0[:, None], 1.0 - w1[:, None], zero)
            + torch.where(cols == i1[:, None], w1[:, None], zero))


class _Upsample(torch.autograd.Function):
    """``F.interpolate``'s bilinear upsample whose backward is the adjoint
    of the separable interpolation, two matrix products in float32: on the
    card ``F.interpolate``'s own backward adds with atomics, in an order
    that changes from run to run."""

    @staticmethod
    def forward(ctx, x, hw):
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (hi, wi), (ho, wo) = ctx.in_hw, tuple(g.shape[-2:])
        my = interp_matrix(hi, ho, g.device)
        mx = interp_matrix(wi, wo, g.device)
        return torch.matmul(my.t(), torch.matmul(g.float(), mx)).to(g.dtype), None


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
