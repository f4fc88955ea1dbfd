"""Preprocessing and the packed-frame unpack (counterpart of
the JAX package's ``ops/preprocess.py`` and the unpacks in ``runtime/engine.py``
and ``runtime/multistream.py``).  ``resize_triangle`` and ``normalize`` take
any leading batch axes."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tod_tpu_torch.ops.ieee import div


def unpack_frame(packed: torch.Tensor, hw: tuple[int, int]):
    """Flat (H*W*5,) uint8 -> (rgb (H, W, 3) uint8, depth (H, W) int32 mm).

    The buffer holds the RGB bytes, then the depth as little-endian u16
    pairs.  Depth is built as ``lo | hi << 8`` in int32.
    """
    h, w = hw
    n_rgb = h * w * 3
    if packed.dtype != torch.uint8 or packed.numel() != h * w * 5:
        raise ValueError(
            f"packed frame must be {h * w * 5} uint8 bytes, got "
            f"{packed.numel()} {packed.dtype}"
        )
    rgb = packed[:n_rgb].reshape(h, w, 3)
    pairs = packed[n_rgb:].reshape(h, w, 2).to(torch.int32)
    depth = pairs[..., 0] | (pairs[..., 1] << 8)
    return rgb, depth


def unpack_frames(packed: torch.Tensor, hw: tuple[int, int]):
    """Batched :func:`unpack_frame`: (N, H*W*5) uint8 -> (rgb (N, H, W, 3)
    uint8, depth (N, H, W) int32 mm)."""
    h, w = hw
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] != h * w * 5:
        raise ValueError(
            f"packed frames must be (N, {h * w * 5}) uint8, got "
            f"{tuple(packed.shape)} {packed.dtype}"
        )
    n = packed.shape[0]
    rgb = packed[:, : h * w * 3].reshape(n, h, w, 3)
    pairs = packed[:, h * w * 3 :].reshape(n, h, w, 2).to(torch.int32)
    return rgb, pairs[..., 0] | (pairs[..., 1] << 8)


def pack_frame(rgb, depth) -> np.ndarray:
    """Host-side inverse of :func:`unpack_frame`: numpy rgb (H, W, 3) uint8
    and depth (H, W) uint16 -> flat uint8 buffer."""
    d = np.ascontiguousarray(depth, dtype="<u2").view(np.uint8).reshape(-1)
    return np.concatenate([np.ascontiguousarray(rgb, np.uint8).reshape(-1), d])


def resize_triangle(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Triangle-filter (antialiased bilinear) resize of (..., H, W, C) -> f32."""
    x = img.to(torch.float32)
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)


def normalize(img_f32: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[0, 255] -> [-1, 1] in the compute dtype."""
    return (div(img_f32, 127.5) - 1.0).to(dtype)


def preprocess_frame(rgb: torch.Tensor, out_hw: tuple[int, int],
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, h, w, 3) normalised, NHWC."""
    return normalize(resize_triangle(rgb, out_hw), dtype)[None]


def tile_448x224(rgb: torch.Tensor) -> torch.Tensor:
    """The reference's tile path: (H, W, 3) frame -> (2, 224, 224, 3) f32,
    a triangle resize to 224x448, cut into its left and right halves (one
    batch, so both tiles run in one forward)."""
    small = resize_triangle(rgb, (224, 448))
    return torch.stack([small[:, :224], small[:, 224:]], dim=0)


def stitch_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """(2, h, w, ...) -> (h, 2w, ...), the inverse of the tile split."""
    return torch.cat([tiles[0], tiles[1]], dim=1)


def upscale_to_frame(img: torch.Tensor, frame_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour upscale of a (h, w) class/id map to frame size."""
    h, w = img.shape[:2]
    fh, fw = frame_hw
    # jax.image.resize "nearest" samples the source at floor((i + 0.5) * in / out)
    ys = div((torch.arange(fh, device=img.device, dtype=torch.float32) + 0.5) * h, fh)
    xs = div((torch.arange(fw, device=img.device, dtype=torch.float32) + 0.5) * w, fw)
    ys, xs = ys.floor().long(), xs.floor().long()
    return img[ys.clamp_max(h - 1)][:, xs.clamp_max(w - 1)]
