"""Frame sources (counterpart of the JAX package's ``runtime/frame_source.py``).

- ``SyntheticSource``  a deterministic moving scene: ``synth_frame_numpy`` is
                       a copy of the JAX package's NumPy generator, byte for
                       byte (a depth ramp with two yellow balls, a red and a
                       blue robot box moving with ``t``)
- ``TraceSource``      replay of a recorded TODTRACE file; ``write_trace``
                       records one, in the same format as the JAX package's,
                       so a trace written by either package replays in the
                       other
- ``PacedSource``      wraps any source to emit at a fixed FPS
- ``PNGSource``        one image resized to the camera (Pillow's default
                       bicubic, byte for byte) with a synthetic depth ramp,
                       repeated; the PNG is read without PIL
- ``RingSource``       a native producer thread pushing frames at the camera's
                       rate into a drop-oldest ring (``native/ring.py``)
"""

from __future__ import annotations

import pathlib
import struct
import threading
import time
from typing import Iterator, Optional

import numpy as np

from tod_tpu_torch.core.config import CameraConfig
from tod_tpu_torch.core.types import Frame
from tod_tpu_torch.utils.image_io import load_image
from tod_tpu_torch.utils.resample import resize_bicubic


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


class PacedSource:
    """Rate-limit any source to ``fps`` (a real camera's frame clock).

    Sleeps the producer to the camera period and never skips a frame; a slow
    consumer delays the clock instead of building a backlog."""

    def __init__(self, source, fps: float = 30.0):
        if fps <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        self._source = source
        self._period = 1.0 / fps

    def frames(self) -> Iterator[Frame]:
        next_t = time.monotonic()
        for frame in self._source.frames():
            now = time.monotonic()
            if now < next_t:
                time.sleep(next_t - now)
                now = next_t
            next_t = max(next_t + self._period, now)
            yield frame

    def close(self) -> None:
        self._source.close()


_TRACE_MAGIC = b"TODTRACE"


def write_trace(path: str | pathlib.Path, frames: list[Frame]) -> None:
    """Record frames as TODTRACE: the magic, ``<III`` height, width and
    count, then per frame the RGB bytes and the little-endian u16 depth."""
    h, w = frames[0].rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(_TRACE_MAGIC)
        f.write(struct.pack("<III", h, w, len(frames)))
        for fr in frames:
            f.write(np.ascontiguousarray(fr.rgb, np.uint8).tobytes())
            f.write(np.ascontiguousarray(fr.depth, "<u2").tobytes())


class TraceSource:
    """Replay a TODTRACE recording (loops when ``loop=True``)."""

    def __init__(self, path: str | pathlib.Path, loop: bool = False,
                 n_frames: Optional[int] = None):
        self.path = pathlib.Path(path)
        raw = self.path.read_bytes()
        if raw[:8] != _TRACE_MAGIC:
            raise ValueError(f"{path} is not a TODTRACE file")
        self.h, self.w, self.count = struct.unpack_from("<III", raw, 8)
        self._raw = raw
        self.loop = loop
        self.n_frames = n_frames

    def _frame(self, k: int) -> Frame:
        px = self.h * self.w
        off = 20 + k * px * 5
        rgb = np.frombuffer(self._raw, np.uint8, px * 3, off).reshape(self.h, self.w, 3)
        depth = np.frombuffer(self._raw, "<u2", px, off + px * 3).reshape(self.h, self.w)
        return Frame(rgb=rgb, depth=depth.astype(np.uint16))

    def frames(self) -> Iterator[Frame]:
        t = 0
        while True:
            if self.n_frames is not None and t >= self.n_frames:
                return
            if not self.loop and t >= self.count:
                return
            yield self._frame(t % self.count)
            t += 1

    def close(self) -> None:
        pass


class PNGSource:
    """A fixed image resized to the camera's resolution, paired with a depth
    ramp from 3500 mm at the top row to 600 mm at the bottom."""

    def __init__(self, path: str | pathlib.Path, cam: CameraConfig | None = None,
                 n_frames: Optional[int] = None):
        self.cam = cam or CameraConfig()
        self.n_frames = n_frames
        self.rgb = resize_bicubic(load_image(path), (self.cam.width, self.cam.height))
        ramp = np.linspace(3500, 600, self.cam.height).astype(np.uint16)
        self.depth = np.broadcast_to(ramp[:, None], (self.cam.height, self.cam.width)).copy()

    def frames(self) -> Iterator[Frame]:
        t = 0
        while self.n_frames is None or t < self.n_frames:
            yield Frame(rgb=self.rgb, depth=self.depth)
            t += 1

    def close(self) -> None:
        pass


class RingSource:
    """Frames from a native producer thread at ``fps`` (the camera's by
    default), the synthetic scene or a trace replayed in a loop, through a
    ring of ``capacity`` frames that drops the oldest when full.  ``frames``
    ends when no frame arrives within 2 s."""

    def __init__(self, cam: CameraConfig | None = None, capacity: int = 4,
                 fps: float | None = None, seed: int = 0, trace_path: str | None = None,
                 n_frames: Optional[int] = None):
        from tod_tpu_torch.native import ring

        self.cam = cam or CameraConfig()
        self.n_frames = n_frames
        self._lib = ring.get()
        self._lock = threading.Lock()
        self._ring = self._lib.tod_ring_create(capacity, self.cam.height, self.cam.width)
        rc = self._lib.tod_ring_start_producer(
            self._ring, float(fps if fps is not None else self.cam.fps), seed,
            trace_path.encode() if trace_path else None,
        )
        if rc != 0:
            self.close()
            raise RuntimeError("ring producer failed to start")

    def frames(self) -> Iterator[Frame]:
        h, w = self.cam.height, self.cam.width
        t = 0
        while self.n_frames is None or t < self.n_frames:
            rgb = np.empty((h, w, 3), np.uint8)
            depth = np.empty((h, w), np.uint16)
            with self._lock:  # close() waits for a pending pop
                if not self._ring or not self._lib.tod_ring_pop(
                        self._ring, rgb.reshape(-1), depth.reshape(-1), 2000):
                    return
            yield Frame(rgb=rgb, depth=depth)
            t += 1

    @property
    def stats(self) -> dict:
        with self._lock:
            if not self._ring:
                raise RuntimeError("the ring source is closed")
            return {
                "pushed": int(self._lib.tod_ring_stat_pushed(self._ring)),
                "dropped": int(self._lib.tod_ring_stat_dropped(self._ring)),
            }

    def close(self) -> None:
        # idempotent and thread-safe: the supervised runtime may close a
        # source on a helper thread while the app closes it again; the
        # handle is claimed under the lock (after any pending pop, at most
        # 2 s) and destroyed once
        with self._lock:
            ring, self._ring = self._ring, None
        if ring:
            self._lib.tod_ring_destroy(ring)
