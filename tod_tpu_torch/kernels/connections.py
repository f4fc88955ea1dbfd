"""K2: 8-neighbour connection weights, and the world positions beside them.

Counterpart of the JAX package's ``kernels/connections.py`` (``connection_weights``).
``connection_planes`` is the kernel's function: on a CUDA tensor it
launches ``csrc/connections.cu``, on a CPU tensor it runs the plain version
below, and while ``torch.export`` traces it, it calls the custom op
``tod::connection_planes`` (the same two).  ``connection_weights`` adds the positions, formed outside the kernel
as the JAX wrapper forms them.  ``connection_tiling`` chooses the kernel's
row bands from the shape and the SM count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tod_tpu_torch.core.device import sm_count
from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.kernels._build import SMEM_LIMIT
from tod_tpu_torch.ops import ieee

SOURCE = "connections"
SIGNATURES = {
    "tod_connections": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int),
}
COL = 4  # column of node x = 0 in a staged row, csrc/connections.cu's kCol


def positions(height_map: torch.Tensor) -> torch.Tensor:
    """(H, W) -> pos (H, W, 3) f32, the (x, height, y) of every node."""
    h, w = height_map.shape
    hm = height_map.to(torch.float32)
    xx = torch.arange(w, dtype=torch.float32, device=hm.device)[None, :].expand(h, w)
    yy = torch.arange(h, dtype=torch.float32, device=hm.device)[:, None].expand(h, w)
    return torch.stack([xx, hm, yy], dim=-1)


def plain_connection_planes(height_map: torch.Tensor) -> torch.Tensor:
    """(H, W) -> connections (H, W, 8) f32: the NaN-padded shifted-subtract
    form of the JAX reference.

    Compiled JAX contracts ``dx^2 + dy^2 + diff^2`` into one fused
    multiply-add.  Here the sum is formed in float64 (the product of two
    float32 values is exact there) and rounded once to float32, which gives
    the fused result; the root is correctly rounded (``ops.ieee.sqrt``)."""
    h, w = height_map.shape
    hm = height_map.to(torch.float32)
    padded = F.pad(hm[None, None], (1, 1, 1, 1), value=float("nan"))[0, 0]
    conns = []
    for dy, dx in NEIGHBOR_OFFSETS:
        nh = padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        diff = (hm - nh).double()
        d = ieee.sqrt((diff * diff + float(dx * dx + dy * dy)).float())
        conns.append(torch.where(torch.isnan(nh), -1.0, d))
    return torch.stack(conns, dim=-1)


def plain_connection_weights(height_map: torch.Tensor):
    """(H, W) -> (pos (H, W, 3) f32, connections (H, W, 8) f32)."""
    return positions(height_map), plain_connection_planes(height_map)


def row_stride(w: int) -> int:
    """Floats a staged row takes: the halo column, W nodes from ``COL`` on
    and the other halo column, padded to 8 (mod 16) so that rows two apart
    start 16 banks apart."""
    s = w + COL + 1
    return s + (8 - s) % 16


def smem_bytes(rows: int, w: int) -> int:
    """A block's shared memory: its barrier, then ``rows`` + 2 staged rows."""
    return 16 + 4 * (rows + 2) * row_stride(w)


class ConnTiling(NamedTuple):
    """How ``csrc/connections.cu`` cuts a map: ``blocks`` bands of ``rows``
    whole rows (the last may be shorter), each staged with a halo row above
    and below in rows of ``stride`` floats."""

    rows: int
    blocks: int
    stride: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def connection_tiling(h: int, w: int, sms: int) -> ConnTiling:
    """The bands of an (h, w) map for a card with ``sms`` SMs: the band
    height that leaves the fewest rows on the busiest SM when the bands are
    dealt to the SMs in turn, within ``SMEM_LIMIT``.  Among ties it takes
    more bands than SMs where it can (a second band on an SM overlaps its
    load with the first one's stores), then the tallest (the fewest halo
    rows).  Raises if not even one row fits."""
    if min(h, w, sms) < 1:
        raise ValueError(f"connection_tiling needs h, w, sms >= 1, got {(h, w, sms)}")
    best = None
    for rows in range(1, h + 1):
        if smem_bytes(rows, w) > SMEM_LIMIT:
            break
        blocks = -(-h // rows)
        key = (-(-blocks // sms) * rows, blocks <= sms, -rows)
        if best is None or key < best[0]:
            best = key, ConnTiling(rows, blocks, row_stride(w), smem_bytes(rows, w))
    if best is None:
        raise ValueError(f"a {w}-node row needs {smem_bytes(1, w)} bytes of shared memory "
                         f"(limit {SMEM_LIMIT})")
    return best[1]


def connection_planes(height_map: torch.Tensor) -> torch.Tensor:
    """(H, W) contiguous f32 height map -> connections (H, W, 8) f32, -1 for
    off-grid or NaN neighbours."""
    if height_map.dim() != 2:
        raise ValueError(f"expected an (H, W) height map, got {tuple(height_map.shape)}")
    if height_map.dtype != torch.float32 or not height_map.is_contiguous():
        raise ValueError("height_map must be contiguous float32")
    if torch.compiler.is_exporting():
        return _op(height_map)
    if height_map.device.type == "cpu":
        return plain_connection_planes(height_map)
    if height_map.device.type != "cuda":
        raise ValueError(f"unsupported device {height_map.device}")
    return _launch(height_map)


def _launch(height_map: torch.Tensor) -> torch.Tensor:
    h, w = height_map.shape
    conn = torch.empty((h, w, 8), dtype=torch.float32, device=height_map.device)
    if h * w == 0:
        return conn
    if conn.data_ptr() % 16:
        raise ValueError("connections buffer is not 16-byte aligned")
    t = connection_tiling(h, w, sm_count(height_map.device))
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(height_map.device):
        err = lib.tod_connections(
            height_map.data_ptr(), conn.data_ptr(), h, w, t.rows, t.stride,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "connections launch")
    connection_planes.launches += 1
    return conn


connection_planes.launches = 0


@torch.library.custom_op("tod::connection_planes", mutates_args=(), device_types="cpu")
def _op(height_map: torch.Tensor) -> torch.Tensor:
    return plain_connection_planes(height_map)


_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(height_map):
    return height_map.new_empty((*height_map.shape, 8))


def connection_weights(height_map: torch.Tensor):
    """(H, W) contiguous f32 height map -> (pos (H, W, 3) f32, connections
    (H, W, 8) f32): ``positions`` beside ``connection_planes``."""
    conns = connection_planes(height_map)
    return positions(height_map), conns
