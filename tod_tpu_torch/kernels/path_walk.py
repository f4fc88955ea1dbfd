"""The planner's path walk: follow ``next_dir`` from the start node and write
the plan buffer.

Counterpart of the walk inside the JAX package's ``planner/tpu_relax.py``
(``plan_on_device``), which XLA runs on the device.  On a CUDA tensor the
wrapper launches ``csrc/path_walk.cu`` (pointer doubling over the grid, then
one thread a plan row), so only the plan leaves the card; on a CPU tensor it
runs the plain version below; while ``torch.export`` traces it, it calls
the custom op ``tod::walk_path`` (the same two).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.kernels.relax import INF

SOURCE = "path_walk"
SIGNATURES = {
    "tod_path_walk": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int),
}


def plain_walk_path(dist: torch.Tensor, next_dir: torch.Tensor, start_yx, max_steps: int,
                    signed: bool = False) -> torch.Tensor:
    """The plain host version: one readback of both maps, then a float32
    walk on the host -> (max_steps + 1, 2) f32 plan on the CPU."""
    f32 = np.float32
    h, w = dist.shape
    nd = next_dir.cpu().numpy().reshape(-1)
    df = dist.cpu().numpy().reshape(-1).astype(f32)
    out = np.zeros((max_steps + 1, 2), f32)
    cur = start_yx[0] * w + start_yx[1]
    if not df[cur] < f32(INF):
        return torch.from_numpy(out)

    def hop(lin):
        d = nd[lin]
        if d < 0:
            return lin
        dy, dx = NEIGHBOR_OFFSETS[d]
        return (lin // w + dy) * w + (lin % w + dx)

    rotation, hx, hz = f32(0.0), f32(0.0), f32(-1.0)
    n = 0
    for i in range(max_steps):
        if nd[cur] < 0:
            break
        nxt = hop(cur)
        mag = df[cur] - df[nxt]
        if signed:
            sx = f32(nxt % w - cur % w)
            sz = f32(nxt // w - cur // w)
            moved = sx != 0 or sz != 0
            turn = np.arctan2(hx * sz - hz * sx, hx * sx + hz * sz) if moved else f32(0.0)
            out[1 + i] = (mag, turn)
            if moved:
                hx, hz = sx, sz
        else:
            out[1 + i] = (mag, rotation)
            nn = hop(nxt)
            ax, ay = f32(cur % w - nxt % w), f32(cur // w - nxt // w)
            bx, by = f32(nn % w - nxt % w), f32(nn // w - nxt // w)
            na = np.sqrt(ax * ax + ay * ay)
            nb = np.sqrt(bx * bx + by * by)
            cosang = np.clip((ax * bx + ay * by) / np.maximum(na * nb, f32(1e-12)), f32(-1), f32(1))
            rotation = np.arccos(cosang) if (na > 0 and nb > 0) else f32(0.0)
        cur = nxt
        n += 1
    out[0] = (n, 1.0 if nd[cur] >= 0 else 0.0)
    return torch.from_numpy(out)


def walk_path(dist: torch.Tensor, next_dir: torch.Tensor, start_yx, max_steps: int,
              signed: bool = False) -> torch.Tensor:
    """dist (H, W) f32, next_dir (H, W) int64 (NEIGHBOR_OFFSETS index, -1 at
    seeds and unreached nodes) -> (max_steps + 1, 2) f32 plan on their device.

    Row 0 is ``(n_valid, truncated)``, rows 1.. the (magnitude, rotation)
    pairs, zeros past ``n_valid``; all zeros when the start is unreached.
    Unsigned turns: the angle between the segments (cur<-next) and
    (next->next2), the first one 0.  Signed turns: the atan2 turn from the
    carried heading (initially up the map) to each hop's segment.
    """
    if dist.dim() != 2 or next_dir.shape != dist.shape:
        raise ValueError(f"expected (H, W) maps, got {tuple(dist.shape)} and {tuple(next_dir.shape)}")
    h, w = dist.shape
    sy, sx = start_yx
    if not (0 <= sy < h and 0 <= sx < w) or max_steps < 0:
        raise ValueError(f"start {start_yx} off the {h}x{w} grid, or max_steps {max_steps} < 0")
    if torch.compiler.is_exporting():
        return _op(dist, next_dir, sy, sx, max_steps, signed)
    if dist.device.type == "cpu":
        return plain_walk_path(dist, next_dir, start_yx, max_steps, signed)
    return _launch(dist, next_dir, sy, sx, max_steps, signed)


def _launch(dist: torch.Tensor, next_dir: torch.Tensor, sy: int, sx: int, max_steps: int,
            signed: bool) -> torch.Tensor:
    if dist.device.type != "cuda":
        raise ValueError(f"unsupported device {dist.device}")
    if (dist.dtype != torch.float32 or next_dir.dtype != torch.int64
            or next_dir.device != dist.device
            or not dist.is_contiguous() or not next_dir.is_contiguous()):
        raise ValueError(f"dist must be contiguous float32 and next_dir contiguous int64 on {dist.device}")
    h, w = dist.shape
    plan = torch.empty((max_steps + 1, 2), dtype=torch.float32, device=dist.device)
    levels = max(1, max_steps.bit_length())  # 2**levels > max_steps
    succ = torch.empty(levels * h * w, dtype=torch.int32, device=dist.device)
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(dist.device):
        err = lib.tod_path_walk(
            dist.data_ptr(), next_dir.data_ptr(), succ.data_ptr(), plan.data_ptr(), h * w, w,
            sy * w + sx, max_steps, levels, int(signed), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "path_walk launch")
    walk_path.launches += 1
    return plan


walk_path.launches = 0


@torch.library.custom_op("tod::walk_path", mutates_args=(), device_types="cpu")
def _op(dist: torch.Tensor, next_dir: torch.Tensor, sy: int, sx: int, max_steps: int,
        signed: bool) -> torch.Tensor:
    return plain_walk_path(dist, next_dir, (sy, sx), max_steps, signed)


_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(dist, next_dir, sy, sx, max_steps, signed):
    return dist.new_empty((max_steps + 1, 2), dtype=torch.float32)
