"""The tracker kernel: one step of N Kalman track banks and their seed slots
in one launch.

Counterpart of the JAX package's ``track/tracker.py`` (``track_update``
then ``tracks_to_balls``), an XLA loop inside the jitted serving graph.  On
a CUDA tensor the wrapper launches ``csrc/track.cu``, one warp a bank; on a
CPU tensor it runs the plain version, ``track/tracker.py``'s torch
functions.  Either way the bank is updated in place (the JAX graph donates
it) and nothing is read back.  While ``torch.export`` traces it, it calls
the custom op ``tod::track_banks`` (the same two), which declares the bank
mutated.
"""

from __future__ import annotations

import ctypes

import torch

from tod_tpu_torch.core.config import TrackerConfig
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.kernels._build import SMEM_LIMIT
from tod_tpu_torch.track.tracker import STATE_WIDTH, track_update, tracks_to_balls

SOURCE = "track"
SIGNATURES = {
    "tod_track": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 9
                  + [ctypes.c_void_p], ctypes.c_int),
}
MAX_TRACKS = 32  # csrc/track.cu's kMaxTracks: a bank's rows live in a warp's lanes


def plain_track_banks(tracks: torch.Tensor, balls: torch.Tensor, cfg: TrackerConfig,
                      max_balls: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version -> (new banks, seed slots), new tensors."""
    new = track_update(tracks, balls, cfg)
    return new, tracks_to_balls(new, cfg, max_balls)


def track_banks(tracks: torch.Tensor, balls: torch.Tensor, cfg: TrackerConfig,
                max_balls: int) -> torch.Tensor:
    """One tracker step of every bank.

    ``tracks``: ``(N, K, 10)`` (or one ``(K, 10)`` bank) contiguous f32,
    updated in place; ``balls``: the ``(N, M, 4)`` (or ``(M, 4)``) fusion
    centroid slots, f32 on the same device -> the ``(N, max_balls, 4)`` (or
    ``(max_balls, 4)``) seed slots of the new banks.  Raises before any
    launch when ``max_balls`` is below ``K``.
    """
    single = tracks.dim() == 2
    if single:
        tracks, balls = tracks[None], balls[None]
    if tracks.dim() != 3 or tracks.shape[2] != STATE_WIDTH or balls.dim() != 3 \
            or balls.shape[0] != tracks.shape[0] or balls.shape[2] != 4:
        raise ValueError(f"expected banks (N, K, {STATE_WIDTH}) and balls (N, M, 4), got "
                         f"{tuple(tracks.shape)} and {tuple(balls.shape)}")
    for name, t in (("tracks", tracks), ("balls", balls)):
        if t.device != tracks.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {tracks.device}")
    k = tracks.shape[1]
    if max_balls < k:
        raise ValueError(f"max_balls ({max_balls}) < max_tracks ({k})")
    if torch.compiler.is_exporting():
        seeds = _op(tracks, balls, max_balls, *_scalars(cfg))
    elif tracks.device.type == "cpu":
        seeds = _plain(tracks, balls, max_balls, *_scalars(cfg))
    else:
        seeds = _launch(tracks, balls, max_balls, *_scalars(cfg))
    return seeds[0] if single else seeds


def _scalars(cfg: TrackerConfig) -> tuple:
    """The settings the step reads, in ``_op``'s order."""
    return (float(cfg.gate), int(cfg.max_misses), int(cfg.min_hits), float(cfg.accel_var),
            float(cfg.meas_var), float(cfg.vel0_var), float(cfg.min_pixels))


def _plain(tracks: torch.Tensor, balls: torch.Tensor, max_balls: int, gate: float,
           max_misses: int, min_hits: int, accel_var: float, meas_var: float,
           vel0_var: float, min_pixels: float) -> torch.Tensor:
    cfg = TrackerConfig(enabled=True, max_tracks=tracks.shape[1], gate=gate,
                        max_misses=max_misses, min_hits=min_hits, accel_var=accel_var,
                        meas_var=meas_var, vel0_var=vel0_var, min_pixels=min_pixels)
    new, seeds = plain_track_banks(tracks, balls, cfg, max_balls)
    tracks.copy_(new)
    return seeds


def _launch(tracks: torch.Tensor, balls: torch.Tensor, max_balls: int, gate: float,
            max_misses: int, min_hits: int, accel_var: float, meas_var: float,
            vel0_var: float, min_pixels: float) -> torch.Tensor:
    if tracks.device.type != "cuda":
        raise ValueError(f"unsupported device {tracks.device}")
    n, k, _ = tracks.shape
    m = balls.shape[1]
    if not 1 <= k <= MAX_TRACKS or m < 1 or 4 * k * m + m > SMEM_LIMIT:
        raise ValueError(f"K={k} tracks and M={m} balls: the kernel takes 1 <= K <= "
                         f"{MAX_TRACKS} and a K x M cost matrix within {SMEM_LIMIT} bytes")
    if tracks.data_ptr() % 8 or balls.data_ptr() % 16:
        raise ValueError("the kernel reads a bank row by 8-byte and a ball slot by 16-byte "
                         "loads: tracks must be 8-byte and balls 16-byte aligned")
    seeds = torch.empty((n, max_balls, 4), dtype=torch.float32, device=tracks.device)
    q = accel_var
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(tracks.device):
        err = lib.tod_track(
            tracks.data_ptr(), balls.data_ptr(), seeds.data_ptr(), n, k, m, max_balls,
            q * 0.25, q * 0.5, q, gate**2, meas_var, vel0_var, min_pixels,
            float(max_misses), float(min_hits), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "track launch")
    track_banks.launches += 1
    return seeds


track_banks.launches = 0

_op = torch.library.custom_op("tod::track_banks", _plain, mutates_args=("tracks",),
                              device_types="cpu")
_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(tracks, balls, max_balls, *settings):
    return tracks.new_empty((tracks.shape[0], max_balls, 4))
