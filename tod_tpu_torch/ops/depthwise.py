"""Depthwise convolution as shifted multiply-adds (counterpart of the JAX
package's ``ops/depthwise.py``).

A depthwise kernel is a per-channel stencil: the same sum is kh * kw
strided slices of the padded input, each scaled by its tap and summed in
f32.  ``ModelConfig.depthwise_shifted`` (default off) serves and trains the
depthwise sites that :func:`shifted_wins` picks this way; the taps and the
SAME padding are the conv's, so the weights are the same either way.  The
policy (unit stride, at most 144 channels) is the JAX package's, chosen
from its own measurements; on the card the form is not measured faster.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tod_tpu_torch.ops.padding import same_pads as _axis_pads

SHIFTED_MAX_CHANNELS = 144


def shifted_wins(channels: int, stride: int) -> bool:
    """The sites the flag moves to the shifted form: unit stride, narrow
    channels."""
    return stride == 1 and channels <= SHIFTED_MAX_CHANNELS


def same_pads(in_hw: tuple[int, int], k: int,
              stride: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(lo, hi) padding of each spatial axis under SAME."""
    return _axis_pads(in_hw[0], k, stride), _axis_pads(in_hw[1], k, stride)


def depthwise_conv_shifted(x: torch.Tensor, weight: torch.Tensor,
                           stride: int = 1) -> torch.Tensor:
    """Depthwise conv by shifted adds: ``x`` (B, C, H, W), ``weight``
    (C, 1, kh, kw) as a depthwise ``F.conv2d`` takes it; SAME padding; the
    sum in f32, tap by tap in row-major order; returns ``x.dtype``."""
    c, _, kh, kw = weight.shape
    (plh, phh), (plw, phw) = same_pads(tuple(x.shape[-2:]), kh, stride)
    out_h, out_w = -(-x.shape[-2] // stride), -(-x.shape[-1] // stride)
    xp = F.pad(x, (plw, phw, plh, phh))
    kf = weight.float()
    acc = torch.zeros((x.shape[0], c, out_h, out_w), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            sl = xp[:, :, i : i + stride * (out_h - 1) + 1 : stride,
                    j : j + stride * (out_w - 1) + 1 : stride]
            acc = acc + sl.float() * kf[:, 0, i, j].view(1, c, 1, 1)
    return acc.to(x.dtype)
