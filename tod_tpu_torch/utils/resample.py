"""Pillow's default image resize, byte for byte, in numpy.

``Image.resize((w, h))`` on an RGB image resamples with Pillow's BICUBIC
filter (``src/libImaging/Resample.c``), which this module repeats:

- the cubic kernel with ``a = -0.5``, its support (2) scaled by the
  reduction factor when shrinking;
- per output position, ``center = (x + 0.5) * scale``; the window runs from
  ``int(center - support + 0.5)`` to ``int(center + support + 0.5)``
  (C truncation), clamped to the image; the weights, taken at
  ``(x + xmin - center + 0.5) / filterscale``, are normalised to sum 1 in
  float64;
- the weights become 22-bit fixed point, rounded half away from zero;
- the horizontal pass first, into a uint8 image, then the vertical pass;
  each output sums from ``1 << 21``, shifts right by 22 and clips to
  [0, 255];
- an unchanged size returns a copy.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 2.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(window starts (out,), fixed-point weights (out, ksize) int64), with
    zero weights past each window's end."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            # C's (int) cast truncates toward zero
            weights[xx, x] = int(w * (1 << PRECISION_BITS) + (-0.5 if w < 0 else 0.5))
        starts[xx] = xmin
    return starts, weights


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """Resample ``img`` (H, W, C) uint8 along ``axis`` (1: horizontal, 0:
    vertical) to ``out_size``."""
    starts, weights = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size, *src.shape[1:]), 1 << (PRECISION_BITS - 1), np.int64)
    last = src.shape[0] - 1
    for j in range(weights.shape[1]):
        idx = np.minimum(starts + j, last)  # zero weight wherever this clamps
        acc += src[idx] * weights[:, j].reshape(-1, *([1] * (src.ndim - 1)))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for ``size = (w, h)``, as PIL's
    ``Image.fromarray(img).resize(size)``."""
    img = np.asarray(img, np.uint8)
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    if img.shape[1] != w:
        img = _pass(img, w, axis=1)
    if img.shape[0] != h:
        img = _pass(img, h, axis=0)
    return np.ascontiguousarray(img)
