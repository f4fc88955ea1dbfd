"""Metric world model for closed-loop simulation (the port's copy of the JAX
package's ``sim/world.py``; numpy and the standard library).

The reference's product is steering: its planner emits ``(magnitude,
rotation)`` driving directions for the robot controller (src/path.rs:93-119,
served over TCP to the RoboRIO), but the repository contains no consumer —
the control side lived on the robot.  This package closes that loop: a flat
FRC-style field in millimetres (balls, robot obstacles, an agent with a pose),
a renderer producing the RGB-D frames the pipeline ingests
(:mod:`tod_tpu_torch.sim.camera`), and a direction-follower that executes
served Paths (:mod:`tod_tpu_torch.sim.controller`) — so "the robot reaches the ball" is a
testable end-to-end property instead of an off-repo promise.

Coordinate frame: the world is the agent's START frame — x to the robot's
initial right, z straight ahead, units mm.  ``heading`` is the yaw angle from
+z, positive toward +x (clockwise from above) — the same sign convention as
the planner's signed turns (PlannerConfig.signed_turns).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Ball:
    """An FRC Power Cell: ~178 mm diameter yellow ball on the floor.

    ``vx``/``vz`` (mm per control tick) make it a MOVING target — balls on a
    competition field roll.  Intercepting one is the scenario that makes
    path freshness a product property: every tick of staleness displaces
    the goal the planner is steering toward."""

    x: float
    z: float
    radius: float = 89.0
    vx: float = 0.0
    vz: float = 0.0


@dataclasses.dataclass
class Obstacle:
    """An opposing robot: a box of ``2·half_w`` width and ``height_mm``
    height sitting on the floor (rendered as the red/blue class the
    detection heads know)."""

    x: float
    z: float
    half_w: float = 350.0
    height_mm: float = 550.0
    team: str = "red"  # "red" (class 1) | "blue" (class 2)


class SimWorld:
    """Agent pose + world objects + the motion model.

    ``step(turn, advance_mm)`` applies one control command: rotate the
    heading by ``turn`` (radians, positive = toward +x), then drive
    ``advance_mm`` straight along the new heading — exactly the
    "turn rotation[i], advance magnitude[i]" reading of a signed-turn Path.
    """

    def __init__(
        self,
        balls: list[Ball] | None = None,
        obstacles: list[Obstacle] | None = None,
        agent_xz: tuple[float, float] = (0.0, 0.0),
        heading: float = 0.0,
        cam_height_mm: float = 400.0,
    ):
        self.balls = list(balls or [])
        self.obstacles = list(obstacles or [])
        self.x, self.z = agent_xz
        self.heading = heading
        self.cam_height_mm = cam_height_mm
        self.trail: list[tuple[float, float]] = [(self.x, self.z)]

    # --- motion -----------------------------------------------------------
    def step(self, turn: float, advance_mm: float) -> None:
        self.heading += turn
        self.x += advance_mm * math.sin(self.heading)
        self.z += advance_mm * math.cos(self.heading)
        for b in self.balls:
            b.x += b.vx
            b.z += b.vz
        self.trail.append((self.x, self.z))

    # --- frames -----------------------------------------------------------
    def to_camera(self, px: float, pz: float) -> tuple[float, float]:
        """World point → camera frame (Xc right, Zc forward), mm."""
        dx, dz = px - self.x, pz - self.z
        c, s = math.cos(self.heading), math.sin(self.heading)
        return c * dx - s * dz, s * dx + c * dz

    # --- queries ----------------------------------------------------------
    def ball_distance(self) -> float:
        """Planar distance from the agent to the nearest ball, mm."""
        if not self.balls:
            return math.inf
        return min(math.hypot(b.x - self.x, b.z - self.z) for b in self.balls)

    def obstacle_clearance(self) -> float:
        """Distance from the agent to the nearest obstacle center minus its
        half-width (≤0 means the drive base overlaps the box footprint)."""
        if not self.obstacles:
            return math.inf
        return min(
            math.hypot(o.x - self.x, o.z - self.z) - o.half_w
            for o in self.obstacles
        )
