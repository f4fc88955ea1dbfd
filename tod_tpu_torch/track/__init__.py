"""Temporal ball tracking (a Kalman track bank over the fusion centroids)."""

from tod_tpu_torch.track.tracker import (
    init_tracks,
    shift_tracks,
    track_update,
    tracks_to_balls,
)

__all__ = ["init_tracks", "shift_tracks", "track_update", "tracks_to_balls"]
