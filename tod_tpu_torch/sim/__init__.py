"""Closed-loop drive-to-ball simulation (counterpart of the JAX package's
``sim``): a metric world, an RGB-D renderer consistent with the fusion, a
follower that drives served signed-turn Paths, and the loop that closes
them through the port's fusion, tracker kernel, planner and ``Engine``
(``tests/test_torch_sim.py``)."""

from tod_tpu_torch.sim.camera import render
from tod_tpu_torch.sim.controller import DirectionFollower
from tod_tpu_torch.sim.loop import run_closed_loop
from tod_tpu_torch.sim.world import Ball, Obstacle, SimWorld

__all__ = [
    "Ball",
    "DirectionFollower",
    "Obstacle",
    "SimWorld",
    "render",
    "run_closed_loop",
]
