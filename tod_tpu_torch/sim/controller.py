"""Direction-follower: executes a served Path as motion commands (the
port's copy of the JAX package's ``sim/controller.py``).

The RoboRIO-side consumer the reference never shipped: interprets the
planner's signed-turn direction list (PlannerConfig.signed_turns — "turn
rotation[i], advance magnitude[i]") into one ``(turn, advance_mm)`` command
per control tick.  The closed loop replans every tick (drop-old semantics —
same policy as the serving engine), so the follower only ever consumes the
FIRST hops of each path; steering gain and a turn-dependent speed damp make
the discrete grid-plan chain into a stable continuous controller.

Grid→metric scale: one birdseye row equals ``max_depth_mm / H`` millimetres
of camera-forward distance (geometry/fusion.birdseye_project:
``z = floor(H·depth/max_depth)``), so hop magnitudes — grid-cell Euclidean
costs on flat floor — convert to millimetres by that row pitch.  Columns are
pixel-projective rather than metric; replanning each tick absorbs the
distortion (the test suite gates convergence, tests/test_torch_sim.py).
"""

from __future__ import annotations

import math

from tod_tpu_torch.core.config import CameraConfig, PlannerConfig
from tod_tpu_torch.core.types import Path


class DirectionFollower:
    """Path → one ``(turn_rad, advance_mm)`` command per tick.

    Pure-pursuit steering: the signed turn chain is walked ``lookahead_cells``
    grid cells forward to reconstruct the lookahead point's displacement,
    and the command aims at THAT bearing — steering on ``rotation[0]`` alone
    would quantize to 45° steps (the first hop is one 8-neighbor grid move)
    and bang-bang oscillate.  ``gain`` under-steers (proportional damping),
    ``max_turn`` bounds a tick's rotation, and advance slows through turns.

    Empty-path fallbacks (the camera is blind below ~(cam_height−r)·fy/H_px
    forward distance — a near ball exits the frame bottom): first
    ``blind_ticks`` of straight dead-reckoning at the last advance (the
    intake-runs-blind final approach every FRC robot does), then a rotate-
    in-place search toward the side the ball was last steered to.
    """

    def __init__(
        self,
        cam: CameraConfig,
        pcfg: PlannerConfig | None = None,
        lookahead_cells: float = 30.0,
        gain: float = 0.5,
        smoothing: float = 0.5,
        max_turn: float = math.pi / 4,
        max_advance_mm: float = 420.0,
        blind_ticks: int = 3,
        search_turn: float = math.pi / 8,
    ):
        pcfg = pcfg or PlannerConfig()
        if not pcfg.signed_turns:
            raise ValueError(
                "DirectionFollower needs PlannerConfig.signed_turns=True — the "
                "reference-parity unsigned acos angles (straight = pi, no "
                "left/right sign) are not drivable"
            )
        self.mm_per_cell = cam.max_depth_mm / cam.height
        self.lookahead_cells = lookahead_cells
        self.gain = gain
        self.smoothing = smoothing
        self.max_turn = max_turn
        self.max_advance_mm = max_advance_mm
        self.blind_ticks = blind_ticks
        self.search_turn = search_turn
        self._last: tuple[float, float] | None = None
        self._blind_left = 0
        self._bearing_ema: float | None = None

    def command(self, path: Path | None) -> tuple[float, float]:
        """One control command; search/blind fallback when there is no path."""
        if path is None or not path.directions:
            if self._blind_left > 0 and self._last is not None and self._last[1] > 0:
                # blind finish: the ball just dropped below the FOV — keep
                # driving straight at the last commanded speed
                self._blind_left -= 1
                return 0.0, self._last[1]
            # search: rotate toward the side we last steered to
            s = (
                math.copysign(1.0, self._last[0])
                if self._last is not None and self._last[0] != 0.0
                else 1.0
            )
            return s * self.search_turn, 0.0

        # pure pursuit: walk the turn chain to the lookahead displacement
        dx = dz = 0.0
        hx, hz = 0.0, -1.0  # initial facing, up the map (grid x, z=row)
        cells = 0.0
        for mag, rot in path.directions:
            c, s = math.cos(rot), math.sin(rot)
            hx, hz = c * hx - s * hz, s * hx + c * hz
            take = min(mag, self.lookahead_cells - cells)
            if take <= 0.0:
                break
            dx += take * hx
            dz += take * hz
            cells += take
            if cells >= self.lookahead_cells:
                break
        if cells <= 0.0:
            return 0.0, 0.0
        bearing = math.atan2(dx, -dz)  # signed from straight-ahead (0, -1)
        # EMA across replans: flat-floor shortest paths are tie-degenerate
        # (L-shaped staircases whose leg ORDER flips between replans), so the
        # raw lookahead bearing oscillates; smoothing recovers the mean —
        # which IS the straight-line bearing the degenerate set surrounds
        if self._bearing_ema is None:
            self._bearing_ema = bearing
        else:
            a = self.smoothing
            self._bearing_ema = a * self._bearing_ema + (1.0 - a) * bearing
        turn = max(-self.max_turn, min(self.max_turn, self.gain * self._bearing_ema))
        advance = min(math.hypot(dx, dz) * self.mm_per_cell, self.max_advance_mm)
        # slow through turns: full speed straight, ~30% at max_turn
        advance *= max(0.3, math.cos(turn))
        self._last = (turn, advance)
        self._blind_left = self.blind_ticks
        return turn, advance
