"""Pose-parameterized RGB-D renderer, projection-consistent with the fusion
stage (the port's copy of the JAX package's ``sim/camera.py``, numpy).

The pipeline back-projects stored depth with the reference's per-pixel
perspective correction and maps (pixel column, corrected depth) onto the
birdseye grid (geometry/fusion.py ``birdseye_project``, reproducing
shaders/pt_cloud.comp:93-114 verbatim — including its uncentered
``cos(atan(tan(fov/2)·2c/dim))`` coordinate quirk).  This renderer is the
exact inverse sensor model: for a world point at planar camera distance Z it
stores ``Z / corr(y, x)`` so the fused scene places the point at birdseye
row ``H − floor(H·Z/max_depth)`` — i.e. sim-world geometry and planner-grid
geometry agree by construction, which the consistency test gates
(tests/test_torch_sim.py).

Colors mimic the procedural training distribution
(train/synthetic_data.py: floor ramp, yellow balls, red/blue robot boxes) so
the pinned checkpoint detects the rendered objects without retraining.
"""

from __future__ import annotations

import math

import numpy as np

from tod_tpu_torch.core.config import CameraConfig
from tod_tpu_torch.core.types import Frame
from tod_tpu_torch.sim.world import SimWorld

BALL_CLASS = 3
_FAR_DEPTH = 65535  # beyond the max-depth clamp after any correction ≥ h/65535


def _correction(cam: CameraConfig, h: int, w: int) -> np.ndarray:
    """NumPy mirror of geometry.fusion.depth_correction_factors (same
    uncentered formula, pt_cloud.comp:93-95)."""
    y = np.arange(h, dtype=np.float32)
    x = np.arange(w, dtype=np.float32)
    fy = np.cos(np.arctan(np.tan(cam.y_fov / 2.0) * y * 2.0 / h))
    fx = np.cos(np.arctan(np.tan(cam.x_fov / 2.0) * x * 2.0 / w))
    return fy[:, None] * fx[None, :]


def render(
    world: SimWorld,
    cam: CameraConfig,
    noise_sigma: float = 4.0,
    seed: int = 0,
    annotate: bool = False,
):
    """Render the world from the agent's pose.

    Returns a :class:`Frame` (rgb u8, depth u16 — the stored-depth encoding
    described in the module docstring).  With ``annotate=True`` also returns
    the oracle ``(class_map u8, id_map i32)`` the renderer knows exactly —
    the NN-free perception path for fast controller tests.
    """
    h, w = cam.height, cam.width
    fx = (w / 2.0) / math.tan(cam.x_fov / 2.0)
    fy = (h / 2.0) / math.tan(cam.y_fov / 2.0)
    cx, cy = w / 2.0, h / 2.0
    corr = _correction(cam, h, w)

    rgb = np.zeros((h, w, 3), np.float32)
    stored = np.full((h, w), float(_FAR_DEPTH), np.float32)
    cls = np.zeros((h, w), np.uint8)
    ids = np.full((h, w), -1, np.int32)

    vv = np.arange(h, dtype=np.float32)[:, None]
    uu = np.arange(w, dtype=np.float32)[None, :]

    # --- floor (training-ramp colors) -------------------------------------
    ramp = (vv / max(h - 1, 1)) * np.ones((1, w), np.float32)
    rgb[..., 0] = 30 + 40 * ramp
    rgb[..., 1] = 60 + 80 * ramp
    rgb[..., 2] = 20 + 30 * ramp
    below = vv > cy + 0.5
    z_floor = np.where(
        below, world.cam_height_mm * fy / np.maximum(vv - cy, 1e-3), float("inf")
    ) * np.ones((1, w), np.float32)
    np.copyto(stored, np.minimum(z_floor / corr, _FAR_DEPTH), where=below & np.isfinite(z_floor))

    # far-to-near painter's order so nearer objects overwrite
    objs = [("obstacle", o) for o in world.obstacles] + [
        ("ball", b) for b in world.balls
    ]
    order = []
    for kind, o in objs:
        Xc, Zc = world.to_camera(o.x, o.z)
        if Zc > 150.0:
            order.append((Zc, kind, o, Xc))
    order.sort(key=lambda t: -t[0])

    ball_id = 0
    for Zc, kind, o, Xc in order:
        depth_val = np.minimum(Zc / corr, _FAR_DEPTH)
        if kind == "obstacle":
            u_c = cx + fx * Xc / Zc
            u_half = fx * o.half_w / Zc
            v_top = cy + fy * (world.cam_height_mm - o.height_mm) / Zc
            v_bot = cy + fy * world.cam_height_mm / Zc
            m = (
                (np.abs(uu - u_c) <= u_half)
                & (vv >= v_top)
                & (vv <= v_bot)
            )
            color = (220, 40, 40) if o.team == "red" else (40, 60, 220)
            c_id = 1 if o.team == "red" else 2
        else:  # ball on the floor, center at radius height
            u_c = cx + fx * Xc / Zc
            v_c = cy + fy * (world.cam_height_mm - o.radius) / Zc
            r_px = fx * o.radius / Zc
            m = (uu - u_c) ** 2 + (vv - v_c) ** 2 <= r_px * r_px
            color = (240, 220, 40)
            c_id = BALL_CLASS
        rgb[m] = color
        np.copyto(stored, depth_val, where=m)
        cls[m] = c_id
        if kind == "ball":
            ids[m] = ball_id
            ball_id += 1
        else:
            ids[m] = -1

    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        rgb += rng.normal(0.0, noise_sigma, rgb.shape).astype(np.float32)

    frame = Frame(
        rgb=np.clip(rgb, 0, 255).astype(np.uint8),
        depth=np.clip(stored, 0, 65535).astype(np.uint16),
    )
    if annotate:
        return frame, cls, ids
    return frame
