"""Space-to-depth stem (counterpart of the JAX package's ``ops/s2d.py``):
the stride-2 3x3 stem conv as an exact 2x2 stride-1 conv on the 2x2
space-to-depth of its input.

Output pixel (i, j) of the stride-2 conv sums ``x[2i+di, 2j+dj] W[di, dj]``
over di, dj in {0, 1, 2}.  With blocks ``y[(pi*2+pj)*C + c, i, j] =
x[c, 2i+pi, 2j+pj]``, a 2x2 stride-1 conv over y reaches the offsets
``2ki+pi`` in {0..3}; ``W'[ki, kj, block] = W[2ki+pi, 2kj+pj]`` for offsets
up to 2 and zero for the unused offset 3 gives the same sum term for term.
SAME padding of (k=3, s=2) on an even size is (0, 1), which becomes the
transformed conv's own (0, 1) zero block (``F.pad``: ``F.conv2d``'s
``padding`` is symmetric).  H and W must be even.

The port's tensors are NCHW and its kernels OIHW; the channel order of a
block is JAX's ``(pi, pj, c)``, not ``F.pixel_unshuffle``'s ``(c, pi, pj)``.
The kernel transform acts on the site's (folded, at a serving site) weight
at every call, so the weights are the plain conv's either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2); channel (pi*2 + pj)*C + c."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs an even H and W, got {h}x{w}")
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (B, pi, pj, C, H/2, W/2)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def stem_kernel_s2d(weight: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) stride-2 kernel -> (O, 4C, 2, 2) stride-1 kernel over
    :func:`space_to_depth`'s channels: the taps padded to 4x4 (offset 3 is
    never reached) and regrouped (2ki+pi) -> (ki, pi)."""
    o, c, k1, k2 = weight.shape
    if (k1, k2) != (3, 3):
        raise ValueError(f"the stem transform is for 3x3 kernels, got {k1}x{k2}")
    kp = F.pad(weight, (0, 1, 0, 1))  # (O, C, 4, 4)
    kp = kp.reshape(o, c, 2, 2, 2, 2)  # (O, C, ki, pi, kj, pj)
    kp = kp.permute(0, 3, 5, 1, 2, 4)  # (O, pi, pj, C, ki, kj)
    return kp.reshape(o, 4 * c, 2, 2)


def s2d_stem_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """The SAME-padded stride-2 convolution of ``x`` (B, C, H, W), H and W
    even, by ``weight`` (O, C, 3, 3) (+ ``bias``), computed on the
    space-to-depth input."""
    y = F.pad(space_to_depth(x), (0, 1, 0, 1))
    return F.conv2d(y, stem_kernel_s2d(weight.to(x.dtype)), bias)
