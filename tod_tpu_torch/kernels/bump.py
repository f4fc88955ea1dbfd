"""K3/K4: the terrain bump dilation of a padded peak map.

Counterpart of the JAX package's ``kernels/bump.py`` (``dilate_peaks_strips``
and ``dilate_peaks``).  Both wrappers launch the one kernel of
``csrc/bump.cu`` on a CUDA tensor and run the plain ring loop below on a CPU
tensor; while ``torch.export`` traces them, they call the custom ops
``tod::dilate_peaks_strips`` and ``tod::dilate_peaks`` (the same two).  The
ring table that both read comes from :func:`ring_table` (:func:`table_words`
lays it out for the kernel), and :func:`bump_tiling` chooses the kernel's
blocks from the shape and the SM count.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from tod_tpu_torch.core.device import sm_count
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.kernels._build import SMEM_LIMIT
from tod_tpu_torch.ops.ieee import div

SOURCE = "bump"
SIGNATURES = {
    "tod_bump": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "tod_bump_memo": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
TILE_W = 32  # a block's columns: one warp across (csrc/bump.cu kTileW)
PIXELS = (1, 2, 4)  # the rows a thread can take (template instances of the kernel)
MAX_ROWS = 32  # thread rows a block: 1024 threads
DEFAULT_PIXELS, DEFAULT_ROWS = 2, 4
MEMO_VALUES = 1024  # the memo table holds floor(g(v, r)) for integral v below this

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


class BumpTiling(NamedTuple):
    """A launch of csrc/bump.cu: a block is ``TILE_W`` columns by ``rows``
    thread rows, a thread takes ``pixels`` output rows of one column."""

    pixels: int
    rows: int
    tile_h: int
    blocks_x: int
    blocks_y: int
    threads: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.blocks_x * self.blocks_y


def smem_bytes(tile_h: int, bump_size: int) -> int:
    """A block's staged tile and halo (csrc/bump.cu shared_bytes)."""
    return 4 * (tile_h + 2 * bump_size - 1) * (TILE_W + 2 * bump_size - 1)


def _tiling(h: int, w: int, bump_size: int, pixels: int, rows: int) -> BumpTiling:
    tile_h = pixels * rows
    return BumpTiling(pixels, rows, tile_h, -(-w // TILE_W), -(-h // tile_h), TILE_W * rows,
                      smem_bytes(tile_h, bump_size))


def bump_tiling(h: int, w: int, bump_size: int, sms: int, pixels: int | None = None,
                rows: int | None = None) -> BumpTiling:
    """The kernel's blocks for an (h, w) output at radius ``bump_size`` on
    ``sms`` SMs.  With ``pixels`` and ``rows`` given, that tiling.  Otherwise
    2 pixels a thread and 4 thread rows (128 threads), the fastest shape at
    480x640 on an H100 (``tools/block_sweep.py k3``: the kernel waits on
    latency, so many warps beat many pixels a thread), halved, thread rows
    first, while the grid would leave an SM without a block or the tile
    would not fit shared memory.  Raises where the radius or the tile does
    not fit the kernel (above L = 113 not even a one-row tile fits)."""
    if bump_size < 1:
        raise ValueError(f"bump_size {bump_size} is not positive")
    if pixels is not None or rows is not None:
        t = _tiling(h, w, bump_size, pixels or DEFAULT_PIXELS, rows or DEFAULT_ROWS)
        if t.pixels not in PIXELS or not 1 <= t.rows <= MAX_ROWS or t.smem_bytes > SMEM_LIMIT:
            raise ValueError(f"no tiling of {t.pixels} pixels x {t.rows} rows at "
                             f"bump_size {bump_size}")
        return t
    pixels, rows = DEFAULT_PIXELS, DEFAULT_ROWS
    t = _tiling(h, w, bump_size, pixels, rows)
    while (t.blocks < sms or t.smem_bytes > SMEM_LIMIT) and t.tile_h > 1:
        if rows > 1:
            rows //= 2
        else:
            pixels //= 2
        t = _tiling(h, w, bump_size, pixels, rows)
    if t.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"bump_size {bump_size}: a tile of {t.tile_h} rows does not fit "
                         f"shared memory")
    return t


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
def table_words(bump_size: int) -> np.ndarray:
    """The ring table as the kernel reads it (csrc/bump.cu ``Table``), one
    int32 array: the word offset ``-(dy * stride + dx)`` of each displacement
    by ring in a shared tile of row stride ``32 + 2L - 1``, the ring starts
    (rings + 1), the pow mode of each ring and its float32 exponent's bits."""
    rings = ring_table(bump_size)
    stride = TILE_W + 2 * bump_size - 1
    offsets = [-(dy * stride + dx) for _, ds, _ in rings for dy, dx in ds]
    starts = np.cumsum([0] + [len(ds) for _, ds, _ in rings])
    modes = [pow_mode(e) for _, _, e in rings]
    exps = np.asarray([e for _, _, e in rings], np.float32).view(np.int32)
    return np.concatenate([np.asarray(offsets + list(starts) + modes, np.int32), exps])


class _Rings(NamedTuple):
    """What the kernel reads at one (device, radius, err): the ring table
    and the memo of ``floor(g(v, r))`` for the integral v below
    ``MEMO_VALUES`` (the terrain's peaks are image row indices), both
    written once on ``stream`` and read only after ``ready``."""

    host: torch.Tensor  # the table's pinned source, kept while its copy may run
    table: torch.Tensor
    memo: torch.Tensor
    stream: torch.cuda.Stream
    ready: torch.cuda.Event


_rings: dict[tuple, _Rings] = {}
_rings_lock = threading.Lock()


def _ring_state(lib, bump_size: int, bump_err: float, device: torch.device) -> _Rings:
    """The (device, radius, err)'s table and memo, made and filled on the
    current stream at first use; a launch on another stream waits for them."""
    key = (device, bump_size, float(np.float32(bump_err)))
    stream = torch.cuda.current_stream(device)
    with _rings_lock:
        state = _rings.get(key)
        if state is None:
            host = torch.from_numpy(table_words(bump_size)).pin_memory()
            table = torch.empty(host.shape, dtype=host.dtype, device=device)
            table.copy_(host, non_blocking=True)
            n_rings = len(ring_table(bump_size))
            memo = torch.empty((n_rings, MEMO_VALUES), dtype=torch.float32, device=device)
            err = lib.tod_bump_memo(table.data_ptr(), 4 * bump_size**2, n_rings, bump_err,
                                    memo.data_ptr(), MEMO_VALUES, stream.cuda_stream)
            _build.check(lib, err, "bump memo launch")
            ready = torch.cuda.Event()
            ready.record(stream)
            state = _rings[key] = _Rings(host, table, memo, stream, ready)
    if stream != state.stream:
        stream.wait_event(state.ready)
    return state


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
    t = bump_tiling(h, w, bump_size, sm_count(peaks_ext.device))
    out = torch.empty((h, w), dtype=torch.float32, device=peaks_ext.device)
    if h * w == 0:
        return out
    lib = _build.load(SOURCE, SIGNATURES)
    hp, wp = peaks_ext.shape
    with torch.cuda.device(peaks_ext.device):
        rings = _ring_state(lib, bump_size, bump_err, peaks_ext.device)
        err = lib.tod_bump(
            peaks_ext.data_ptr(), hp, wp, out.data_ptr(), h, w, pad, bump_size, bump_err,
            rings.table.data_ptr(), 4 * bump_size**2, rings.memo.shape[0], t.pixels, t.rows,
            rings.memo.data_ptr(), MEMO_VALUES, torch.cuda.current_stream().cuda_stream,
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
    _check(peaks_ext, bump_size, out_shape)
    if torch.compiler.is_exporting():
        return _strips_op(peaks_ext, bump_size, bump_err, *out_shape)
    if peaks_ext.device.type == "cpu":
        return plain_dilate_peaks(peaks_ext, bump_size, bump_err, out_shape)
    return _launch_strips(peaks_ext, bump_size, bump_err, *out_shape)


def dilate_peaks(peaks_ext: torch.Tensor, bump_size: int, bump_err: float,
                 out_shape: tuple[int, int], constant_val: float | None = None) -> torch.Tensor:
    """K4: the same dilation over the whole map.  With ``constant_val`` (every
    peak has that value) it is the separable closed form of
    ``geometry.fusion``, which is not a kernel."""
    _check(peaks_ext, bump_size, out_shape)
    if constant_val is not None:
        from tod_tpu_torch.geometry.fusion import _dilate_const_separable

        return _dilate_const_separable(peaks_ext, bump_size, float(constant_val), bump_err,
                                       out_shape)
    if torch.compiler.is_exporting():
        return _whole_op(peaks_ext, bump_size, bump_err, *out_shape)
    if peaks_ext.device.type == "cpu":
        return plain_dilate_peaks(peaks_ext, bump_size, bump_err, out_shape)
    return _launch_whole(peaks_ext, bump_size, bump_err, *out_shape)


def _launch_strips(peaks_ext: torch.Tensor, bump_size: int, bump_err: float, h: int,
                   w: int) -> torch.Tensor:
    out = _launch(peaks_ext, bump_size, bump_err, (h, w), _check(peaks_ext, bump_size, (h, w)))
    dilate_peaks_strips.launches += 1
    return out


def _launch_whole(peaks_ext: torch.Tensor, bump_size: int, bump_err: float, h: int,
                  w: int) -> torch.Tensor:
    out = _launch(peaks_ext, bump_size, bump_err, (h, w), _check(peaks_ext, bump_size, (h, w)))
    dilate_peaks.launches += 1
    return out


dilate_peaks_strips.launches = 0
dilate_peaks.launches = 0


def _plain(peaks_ext: torch.Tensor, bump_size: int, bump_err: float, h: int,
           w: int) -> torch.Tensor:
    return plain_dilate_peaks(peaks_ext, bump_size, bump_err, (h, w))


def _fake(peaks_ext, bump_size, bump_err, h, w):
    return peaks_ext.new_empty((h, w))


_strips_op = torch.library.custom_op("tod::dilate_peaks_strips", _plain, mutates_args=(),
                                     device_types="cpu")
_strips_op.register_kernel("cuda")(_launch_strips)
_strips_op.register_fake(_fake)
_whole_op = torch.library.custom_op("tod::dilate_peaks", _plain, mutates_args=(),
                                    device_types="cpu")
_whole_op.register_kernel("cuda")(_launch_whole)
_whole_op.register_fake(_fake)
