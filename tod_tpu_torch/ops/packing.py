"""Pixel and word packing, wire-compatible with the reference (counterpart of
the JAX package's ``ops/packing.py``).

The reference packs camera RGB into big-endian u32 words
``r<<24 | g<<16 | b<<8`` and postprocessed class/id into ``cls<<24 | id<<16``
(the reference combined them with ``&``, which always yields 0; the JAX
package and this port implement the intent, ``|``).

torch has few operators for its unsigned 32- and 16-bit types, so the
arithmetic runs in int64 and only the packed words take the unsigned type.
On the device the channels stay separate; packing exists at the host boundary
for wire and trace parity, and ``unpack_height_balls`` decodes the host
planner's readback.
"""

from __future__ import annotations

import numpy as np
import torch


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def pack_rgb_u32(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> (...,) uint32, big-endian ``r<<24 | g<<16 | b<<8``."""
    r, g, b = (_i64(rgb[..., c]) for c in range(3))
    return ((r << 24) | (g << 16) | (b << 8)).to(torch.uint32)


def unpack_rgb_u32(words: torch.Tensor) -> torch.Tensor:
    """(...,) uint32 -> (..., 3) uint8, inverse of :func:`pack_rgb_u32`."""
    w = _i64(words)
    rgb = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF], dim=-1)
    return rgb.to(torch.uint8)


def pack_class_id(cls: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Class and instance-id maps -> u32 words ``cls<<24 | id<<16``.

    ``ids`` uses -1 for "no instance"; its low 8 bits are stored, so -1
    becomes 0xFF, as the reference's i8 ids read as u8.
    """
    return (((_i64(cls) & 0xFF) << 24) | ((_i64(ids) & 0xFF) << 16)).to(torch.uint32)


def unpack_class_id(words: torch.Tensor):
    """u32 words -> (cls uint8, id int32 with 0xFF mapped back to -1)."""
    w = _i64(words)
    raw = ((w >> 16) & 0xFF).to(torch.int32)
    return ((w >> 24) & 0xFF).to(torch.uint8), torch.where(raw == 0xFF, -1, raw)


def class_id_to_u16(cls: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The 16-bit form pushed to the fusion stage: ``cls | id<<8``, so byte 0
    is the class and byte 1 the id, as an R8G8_UINT texel reads a
    little-endian u16."""
    return ((_i64(cls) & 0xFF) | ((_i64(ids) & 0xFF) << 8)).to(torch.uint16)


def u16_to_class_id(words: torch.Tensor):
    """Inverse of :func:`class_id_to_u16`."""
    w = _i64(words)
    raw = ((w >> 8) & 0xFF).to(torch.int32)
    return (w & 0xFF).to(torch.uint8), torch.where(raw == 0xFF, -1, raw)


def unpack_height_balls(buf, h: int, w: int):
    """Host-side inverse of the host-planner serving step's readback:
    ``[h*w*2 bytes f16 height][16*N bytes f32 (x, y, count, 0) balls]``.

    Returns ``(height f16 (h, w), balls f32 (N, 4))`` as numpy arrays backed
    by ``buf`` (a uint8 numpy array, or a CPU tensor).
    """
    buf = buf.numpy() if isinstance(buf, torch.Tensor) else np.asarray(buf)
    n = h * w * 2
    height = buf[:n].view(np.float16).reshape(h, w)
    balls = buf[n:].view(np.float32).reshape(-1, 4)
    return height, balls
