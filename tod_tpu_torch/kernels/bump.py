"""K3/K4: the terrain bump dilation of a padded peak map.

Counterpart of the JAX package's ``kernels/bump.py`` (``dilate_peaks_strips``
and ``dilate_peaks``).  Both wrappers launch the one kernel of
``csrc/bump.cu`` on a CUDA tensor and run the plain ring loop below on a CPU
tensor.  The ring table that both read comes from :func:`ring_table`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tod_tpu_torch.kernels import _build
from tod_tpu_torch.ops.ieee import div

SOURCE = "bump"
SIGNATURES = {
    "tod_bump": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "tod_bump_shared_bytes": ([ctypes.c_int], ctypes.c_int),
}
MAX_SHARED_BYTES = 48 * 1024  # static launch limit without an opt-in

# How torch evaluates ``torch.pow(float32 tensor, python float)`` on CUDA
# (the codes of ``PowMode`` in csrc/bump.cu).
POW_GENERAL, POW_ONE, POW_COPY, POW_SQRT, POW_RSQRT, POW_RECIPROCAL = range(6)
POW_SQUARE, POW_CUBE, POW_INV_SQUARE = 6, 7, 8


def pow_mode(e: float) -> int:
    """The special case torch takes for the scalar exponent ``e`` on CUDA:
    0 and 1 are tested on the double (fill with 1, copy), then 0.5, -0.5 and
    -1 (sqrt, rsqrt, reciprocal), then 2, 3 and -2 on ``e`` rounded to
    float32 (products); any other exponent goes to ``powf``."""
    for value, mode in ((0.0, POW_ONE), (1.0, POW_COPY), (0.5, POW_SQRT),
                        (-0.5, POW_RSQRT), (-1.0, POW_RECIPROCAL)):
        if e == value:
            return mode
    ef = float(np.float32(e))
    return {2.0: POW_SQUARE, 3.0: POW_CUBE, -2.0: POW_INV_SQUARE}.get(ef, POW_GENERAL)


@functools.lru_cache(maxsize=None)
def ring_table(bump_size: int) -> tuple[tuple[int, tuple[tuple[int, int], ...], float], ...]:
    """The (2L)^2 displacements of the window [-L, L-1]^2 grouped into rings
    of equal r^2, ascending: ``(r2, ((dy, dx), ...), exponent)`` with the
    exponent ``(2/L) * sqrt(r2) - 1`` in float64, as the plain loop passes it
    to ``torch.pow``."""
    L = bump_size
    c2 = 2.0 / float(L)
    side = 2 * L
    rings: dict[int, list[tuple[int, int]]] = {}
    for i in range(side * side):
        dy, dx = i // side - L, i % side - L
        rings.setdefault(dy * dy + dx * dx, []).append((dy, dx))
    return tuple((r2, tuple(d), c2 * float(r2**0.5) - 1.0) for r2, d in sorted(rings.items()))


def _bump_value(val: torch.Tensor, exponent: float, bump_err: float) -> torch.Tensor:
    """``val / (1 + C1^exponent)`` with ``C1 = max(val/err - 1, 1e-6)``."""
    c1 = (div(val, bump_err) - 1.0).clamp_min(1e-6)
    return val / (1.0 + torch.pow(c1, exponent))


def plain_dilate_peaks(peaks_ext: torch.Tensor, bump_size: int, bump_err: float, out_shape):
    """Max-reduce ``floor(g(peak, r))`` over the (2L)^2 displacement window
    [-L, L-1]^2 of a P-padded peak map.  Displacements of equal r^2 are
    max-reduced first and share one bump evaluation (exact: g is monotone in
    the peak over the visible region).  Returns (H, W) f32 integral values."""
    h, w = out_shape
    pad = (peaks_ext.shape[0] - h) // 2
    acc = torch.zeros((h, w), dtype=torch.float32, device=peaks_ext.device)
    for _, disps, exponent in ring_table(bump_size):
        gmax = None
        for dy, dx in disps:
            src = peaks_ext[pad - dy : pad - dy + h, pad - dx : pad - dx + w]
            gmax = src if gmax is None else torch.maximum(gmax, src)
        contrib = torch.floor(_bump_value(gmax, exponent, bump_err))
        acc = torch.maximum(acc, torch.where(gmax > 0, contrib, 0.0))
    return acc


@functools.lru_cache(maxsize=None)
def _device_table(bump_size: int, device: torch.device):
    """The ring table as the kernel reads it: offsets (n, 2) int32, ring
    starts (rings + 1) int32, float32 exponents and pow modes per ring."""
    rings = ring_table(bump_size)
    offsets = [d for _, disps, _ in rings for d in disps]
    starts = np.cumsum([0] + [len(disps) for _, disps, _ in rings])
    arrays = (
        np.asarray(offsets, np.int32),
        starts.astype(np.int32),
        np.asarray([e for _, _, e in rings], np.float32),
        np.asarray([pow_mode(e) for _, _, e in rings], np.int32),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _check(peaks_ext: torch.Tensor, bump_size: int, out_shape) -> int:
    h, w = out_shape
    if peaks_ext.dim() != 2:
        raise ValueError(f"expected a 2-D peak map, got {tuple(peaks_ext.shape)}")
    pad = (peaks_ext.shape[0] - h) // 2
    if tuple(peaks_ext.shape) != (h + 2 * pad, w + 2 * pad) or pad < bump_size or bump_size < 1:
        raise ValueError(
            f"peak map {tuple(peaks_ext.shape)} is not out_shape {tuple(out_shape)} padded by "
            f"the same P >= bump_size = {bump_size} on every side"
        )
    return pad


def _launch(peaks_ext: torch.Tensor, bump_size: int, bump_err: float, out_shape, pad: int):
    if peaks_ext.device.type != "cuda":
        raise ValueError(f"unsupported device {peaks_ext.device}")
    if peaks_ext.dtype != torch.float32 or not peaks_ext.is_contiguous():
        raise ValueError("peaks_ext must be contiguous float32")
    h, w = out_shape
    out = torch.empty((h, w), dtype=torch.float32, device=peaks_ext.device)
    if h * w == 0:
        return out
    lib = _build.load(SOURCE, SIGNATURES)
    if lib.tod_bump_shared_bytes(bump_size) > MAX_SHARED_BYTES:
        raise ValueError(f"bump_size {bump_size} needs more than {MAX_SHARED_BYTES} bytes of shared memory")
    offsets, starts, exps, modes = _device_table(bump_size, peaks_ext.device)
    hp, wp = peaks_ext.shape
    with torch.cuda.device(peaks_ext.device):
        err = lib.tod_bump(
            peaks_ext.data_ptr(), hp, wp, out.data_ptr(), h, w, pad, bump_size, bump_err,
            offsets.data_ptr(), starts.data_ptr(), exps.data_ptr(), modes.data_ptr(),
            exps.numel(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "bump launch")
    return out


def dilate_peaks_strips(peaks_ext: torch.Tensor, bump_size: int, bump_err: float,
                        out_shape: tuple[int, int], strip_h: int = 16) -> torch.Tensor:
    """K3: the variable-value dilation of the (H + 2P, W + 2P) peak map ->
    (H, W) f32.  Requires H divisible by ``strip_h``, as the TPU kernel does."""
    h, _ = out_shape
    if h % strip_h:
        raise ValueError(f"H={h} not divisible by strip_h={strip_h}")
    pad = _check(peaks_ext, bump_size, out_shape)
    if peaks_ext.device.type == "cpu":
        return plain_dilate_peaks(peaks_ext, bump_size, bump_err, out_shape)
    out = _launch(peaks_ext, bump_size, bump_err, out_shape, pad)
    dilate_peaks_strips.launches += 1
    return out


def dilate_peaks(peaks_ext: torch.Tensor, bump_size: int, bump_err: float,
                 out_shape: tuple[int, int], constant_val: float | None = None) -> torch.Tensor:
    """K4: the same dilation over the whole map.  With ``constant_val`` (every
    peak has that value) it is the separable closed form of
    ``geometry.fusion``, which is not a kernel."""
    pad = _check(peaks_ext, bump_size, out_shape)
    if constant_val is not None:
        from tod_tpu_torch.geometry.fusion import _dilate_const_separable

        return _dilate_const_separable(peaks_ext, bump_size, float(constant_val), bump_err,
                                       out_shape)
    if peaks_ext.device.type == "cpu":
        return plain_dilate_peaks(peaks_ext, bump_size, bump_err, out_shape)
    out = _launch(peaks_ext, bump_size, bump_err, out_shape, pad)
    dilate_peaks.launches += 1
    return out


dilate_peaks_strips.launches = 0
dilate_peaks.launches = 0
