"""Synthetic camera frames (counterpart of the JAX package's ``runtime/frame_source.py``).

``synth_frame_numpy`` is a copy of the JAX package's NumPy generator, byte for
byte: a depth ramp with two yellow balls, a red and a blue robot box moving
with ``t``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from tod_tpu_torch.core.config import CameraConfig
from tod_tpu_torch.core.types import Frame


def synth_frame_numpy(seed: int, t: int, h: int, w: int) -> Frame:
    rgb = np.zeros((h, w, 3), np.uint8)
    depth = np.zeros((h, w), np.uint16)
    ramp = np.arange(h)
    d = (3800 - (3000 * ramp) // max(h - 1, 1)).astype(np.uint16)
    g = (60 + (80 * ramp) // max(h - 1, 1)).astype(np.uint8)
    depth[:] = d[:, None]
    rgb[..., 0] = (g // 2)[:, None]
    rgb[..., 1] = g[:, None]
    rgb[..., 2] = (g // 3)[:, None]

    yy, xx = np.mgrid[0:h, 0:w]

    def disc(cy, cx, r, color, dmm):
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        rgb[m] = color
        depth[m] = dmm

    def box(cy, cx, hh, hw2, color, dmm):
        m = (np.abs(yy - cy) <= hh) & (np.abs(xx - cx) <= hw2)
        rgb[m] = color
        depth[m] = dmm

    ph = (seed % 997) * 0.37
    a = 0.035 * t + ph
    disc(
        int(h * 0.62 + 0.12 * h * np.sin(a)),
        int(w * 0.40 + 0.25 * w * np.cos(a * 0.7)),
        h // 16, (240, 220, 40), 1400,
    )
    disc(
        int(h * 0.70 + 0.10 * h * np.cos(a * 1.3)),
        int(w * 0.65 + 0.20 * w * np.sin(a)),
        h // 18, (240, 220, 40), 1900,
    )
    box(
        int(h * 0.45), int(w * 0.20 + 0.10 * w * np.sin(a * 0.5)),
        h // 10, w // 12, (220, 40, 40), 2600,
    )
    box(
        int(h * 0.40), int(w * 0.80 + 0.08 * w * np.cos(a * 0.4)),
        h // 10, w // 12, (40, 60, 220), 3100,
    )
    return Frame(rgb=rgb, depth=depth)


class SyntheticSource:
    """Deterministic synthetic camera."""

    def __init__(self, cam: CameraConfig | None = None, seed: int = 0,
                 n_frames: Optional[int] = None):
        self.cam = cam or CameraConfig()
        self.seed = seed
        self.n_frames = n_frames

    def frames(self) -> Iterator[Frame]:
        t = 0
        while self.n_frames is None or t < self.n_frames:
            yield synth_frame_numpy(self.seed, t, self.cam.height, self.cam.width)
            t += 1

    def close(self) -> None:
        pass
