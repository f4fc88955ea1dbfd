"""K2: world positions and 8-neighbour connection weights.

Counterpart of the JAX package's ``kernels/connections.py`` (``connection_weights``).
On a CUDA tensor the wrapper launches ``csrc/connections.cu``; on a CPU
tensor it runs the plain version below.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.ops import ieee

SOURCE = "connections"


def plain_connection_weights(height_map: torch.Tensor):
    """(H, W) -> (pos (H, W, 3) f32, connections (H, W, 8) f32): the
    NaN-padded shifted-subtract form of the JAX reference.

    Compiled JAX contracts ``dx^2 + dy^2 + diff^2`` into one fused
    multiply-add.  Here the sum is formed in float64 (the product of two
    float32 values is exact there) and rounded once to float32, which gives
    the fused result; the root is correctly rounded (``ops.ieee.sqrt``)."""
    h, w = height_map.shape
    hm = height_map.to(torch.float32)
    dev = hm.device
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    pos = torch.stack([xx, hm, yy], dim=-1)
    padded = F.pad(hm[None, None], (1, 1, 1, 1), value=float("nan"))[0, 0]
    conns = []
    for dy, dx in NEIGHBOR_OFFSETS:
        nh = padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        diff = (hm - nh).double()
        d = ieee.sqrt((diff * diff + float(dx * dx + dy * dy)).float())
        conns.append(torch.where(torch.isnan(nh), -1.0, d))
    return pos, torch.stack(conns, dim=-1)


SIGNATURES = {
    "tod_connections": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
}


def connection_weights(height_map: torch.Tensor):
    """(H, W) f32 height map -> (pos (H, W, 3) f32, connections (H, W, 8) f32),
    -1 for off-grid or NaN neighbours."""
    if height_map.dim() != 2:
        raise ValueError(f"expected an (H, W) height map, got {tuple(height_map.shape)}")
    if height_map.device.type == "cpu":
        return plain_connection_weights(height_map)
    if height_map.device.type != "cuda":
        raise ValueError(f"unsupported device {height_map.device}")
    if height_map.dtype != torch.float32 or not height_map.is_contiguous():
        raise ValueError("height_map must be contiguous float32")
    h, w = height_map.shape
    conn = torch.empty((h, w, 8), dtype=torch.float32, device=height_map.device)
    pos = torch.empty((h, w, 3), dtype=torch.float32, device=height_map.device)
    if h * w == 0:
        return pos, conn
    if conn.data_ptr() % 16:
        raise ValueError("connections buffer is not 16-byte aligned")
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(height_map.device):
        err = lib.tod_connections(
            height_map.data_ptr(), conn.data_ptr(), pos.data_ptr(), h, w,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "connections launch")
    connection_weights.launches += 1
    return pos, conn


connection_weights.launches = 0
