"""Core data types of the serving path (counterpart of the JAX package's ``core/types.py``).

- ``Frame``       one RGB-D camera frame (numpy, host side)
- ``Detections``  fixed-shape YOLACT detection outputs (tensors)
- ``Scene``       the fused birdseye scene (tensors)
- ``Path``        driving directions and their big-endian wire format
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Frame:
    """``rgb`` (H, W, 3) uint8 and ``depth`` (H, W) uint16 millimetres."""

    rgb: np.ndarray
    depth: np.ndarray


@dataclasses.dataclass(frozen=True)
class Detections:
    """Detections for one frame, statically shaped at N = max_detections.

    ``boxes`` (N, 4) f32 y1x1y2x2 normalised; ``scores`` (N,) f32;
    ``classes`` (N,) int32 (0 bg, 1 red robot, 2 blue robot, 3 ball);
    ``masks`` (N, Hm, Wm) f32; ``valid`` (N,) bool; ``class_map`` (H, W)
    uint8; ``id_map`` (H, W) int32 dense ball ids, -1 where none.
    """

    boxes: Any
    scores: Any
    classes: Any
    masks: Any
    valid: Any
    class_map: Any
    id_map: Any


@dataclasses.dataclass(frozen=True)
class Scene:
    """Fused birdseye scene: ``height`` (H, W) f32, ``pos`` (H, W, 3) f32,
    ``balls`` (max_balls, 4) f32 as (x, y, count, 0), ``connections``
    (H, W, 8) f32 in NEIGHBOR_OFFSETS order, -1 for off-grid edges."""

    height: Any
    pos: Any
    balls: Any
    connections: Any


# 8-neighbour displacement order (dy, dx) used by fusion and the planner:
# [N, NE, E, SE, S, SW, W, NW], the reference readback concat order.
NEIGHBOR_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, 0),
    (-1, 1),
    (0, 1),
    (1, 1),
    (1, 0),
    (1, -1),
    (0, -1),
    (-1, -1),
)


@dataclasses.dataclass
class Path:
    """Driving directions to the best ball.

    ``created`` unix seconds (serialised as u64 seconds); ``directions`` list
    of (magnitude, rotation) pairs; ``truncated`` is not on the wire.

    Wire format: 8-byte big-endian unix seconds, then two big-endian f32s per
    direction.
    """

    created: float
    directions: list[tuple[float, float]]
    truncated: bool = False

    @classmethod
    def empty(cls) -> "Path":
        return cls(created=time.time(), directions=[])

    @classmethod
    def from_plan(cls, plan) -> "Path":
        """Decode a ``(max_steps + 1, 2)`` plan buffer: row 0 is
        ``(n_valid, truncated)``, rows 1.. the directions."""
        if isinstance(plan, torch.Tensor):
            plan = plan.detach().cpu().numpy()
        buf = np.asarray(plan, np.float32)
        n = int(buf[0, 0])
        return cls(
            created=time.time(),
            directions=[(float(m), float(r)) for m, r in buf[1 : 1 + n]],
            truncated=bool(buf[0, 1] > 0),
        )

    def serialize(self) -> bytes:
        out = struct.pack(">Q", int(self.created))
        for mag, rot in self.directions:
            out += struct.pack(">ff", float(mag), float(rot))
        return out

    @classmethod
    def deserialize(cls, data: bytes) -> "Path":
        if len(data) < 8 or (len(data) - 8) % 8:
            raise ValueError(f"malformed Path payload of {len(data)} bytes")
        (secs,) = struct.unpack_from(">Q", data, 0)
        directions = [
            struct.unpack_from(">ff", data, off) for off in range(8, len(data), 8)
        ]
        return cls(created=float(secs), directions=directions)


def empty_scene(height: int, width: int, max_balls: int = 100, device="cpu") -> Scene:
    """A scene with nothing in it: zero heights, positions and ball slots,
    and every connection -1 (off-grid)."""
    import torch

    return Scene(
        height=torch.zeros((height, width), dtype=torch.float32, device=device),
        pos=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        balls=torch.zeros((max_balls, 4), dtype=torch.float32, device=device),
        connections=torch.full((height, width, 8), -1.0, dtype=torch.float32, device=device),
    )
