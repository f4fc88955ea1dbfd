"""The closed loop: render -> perceive -> plan -> steer -> move, to the ball
(counterpart of the JAX package's ``sim/loop.py``).

Two perception modes:

- ``perception="oracle"``: the renderer's own class and id maps go into the
  port's fusion (``geometry.fusion.fuse_scene``, kernel K4 on the card) on
  ``device``; no model.  With ``tracker`` the planner seeds from a bank of
  Kalman tracks stepped by the tracker kernel (``kernels/track.py``), and
  with ``obstacle_memory`` a decayed memory of the robot bumps
  (``robot_occupancy``) joins the height.
- ``perception="model"``: the port's ``Engine`` perceives the rendered frame
  (preprocess, the YOLACT forward, detect with K1, fusion with K4), the
  serving path itself.

Either way ``planner.api.plan_from_height`` plans a signed-turn Path (on the
host, or with ``PlannerConfig(backend="tpu")`` the relaxation kernel on the
device) and the ``DirectionFollower`` drives it, so a run that reaches the
ball shows the whole product working.

CLI::

    python -m tod_tpu_torch.sim --ball -700,2400 --obstacle 0,1500 --ticks 40
    python -m tod_tpu_torch.sim --perception model --checkpoint X.npz

It runs on the card; ``main([...], device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from tod_tpu_torch.core.config import CameraConfig, GeometryConfig, PlannerConfig
from tod_tpu_torch.core.device import resolve_device
from tod_tpu_torch.sim.camera import render
from tod_tpu_torch.sim.controller import DirectionFollower
from tod_tpu_torch.sim.world import Ball, Obstacle, SimWorld


@dataclasses.dataclass
class TickLog:
    tick: int
    x: float
    z: float
    heading: float
    ball_mm: float
    turn: float
    advance_mm: float
    n_dirs: int


def _shift_map(mem: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Integer-cell translate with zero fill: the (H, W) map counterpart of
    ``track.tracker.shift_tracks`` for ego-motion-compensating the obstacle
    memory (the memory decays within ~1 / (1 - decay) ticks, so sub-cell
    drift never accumulates)."""
    h, w = mem.shape
    dyi, dxi = int(round(dy)), int(round(dx))
    if abs(dyi) >= h or abs(dxi) >= w:
        return np.zeros_like(mem)
    out = np.zeros_like(mem)
    out[
        max(dyi, 0): h + min(dyi, 0), max(dxi, 0): w + min(dxi, 0)
    ] = mem[max(-dyi, 0): h + min(-dyi, 0), max(-dxi, 0): w + min(-dxi, 0)]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def run_closed_loop(
    world: SimWorld,
    cam: CameraConfig,
    pcfg: PlannerConfig | None = None,
    geom: GeometryConfig | None = None,
    engine=None,
    perception: str = "oracle",
    ticks: int = 40,
    reach_mm: float = 300.0,
    follower: DirectionFollower | None = None,
    path_store=None,
    log_fn=None,
    tracker=None,
    measurement_blackout: tuple[int, int] | None = None,
    obstacle_blackout: tuple[int, int] | None = None,
    obstacle_memory: float = 0.0,
    device=None,
) -> dict:
    """Drive the agent until it reaches the nearest ball or the ticks run
    out -> ``reached``, ``ticks_used``, ``final_ball_mm``,
    ``min_obstacle_clearance_mm`` and the per-tick ``log``.

    ``device`` is where the oracle fusion and the tracker run (the card
    unless the caller asks for the CPU; a model run uses its engine's).
    ``tracker`` (a ``TrackerConfig``) seeds the planner from the track bank
    in place of the raw centroids, ego-motion compensated from the last
    command; ``measurement_blackout=(t0, t1)`` zeroes the ball
    measurements for ticks ``t0 <= t < t1`` before the tracker;
    ``obstacle_blackout=(t0, t1)`` erases the robot classes from the oracle
    maps for those ticks, and ``obstacle_memory=d > 0`` keeps the decayed,
    ego-motion-shifted maximum of past robot bump layers in the height
    (oracle perception only).
    """
    pcfg = pcfg or PlannerConfig(signed_turns=True, start_offset=cam.width // 2,
                                 backend="numpy")
    geom = geom or GeometryConfig()
    follower = follower or DirectionFollower(cam, pcfg)

    if perception == "model":
        if engine is None:
            raise ValueError("perception='model' needs an Engine")
        if obstacle_blackout is not None or obstacle_memory > 0.0:
            raise ValueError(
                "obstacle_blackout/obstacle_memory are oracle-perception sim "
                "controls (the Engine has its own --obstacle-memory mode)"
            )
        dev = engine.device
    elif perception == "oracle":
        dev = resolve_device(device)
    else:
        raise ValueError(f"unknown perception {perception!r}")
    if not (0.0 <= obstacle_memory < 1.0):
        raise ValueError("obstacle_memory must be in [0, 1)")

    from tod_tpu_torch.geometry.fusion import fuse_scene, robot_occupancy
    from tod_tpu_torch.kernels.track import track_banks
    from tod_tpu_torch.planner.api import plan_from_height
    from tod_tpu_torch.track.tracker import init_tracks, shift_tracks

    tracks = None if tracker is None else init_tracks(tracker, device=dev)
    obstacle_mem = None  # (H, W) f32 decayed robot-bump memory

    log: list[TickLog] = []
    min_clear = world.obstacle_clearance()
    reached = False
    for t in range(ticks):
        if perception == "model":
            frame = render(world, cam, seed=t)
            scene, _dets = engine.process(frame)
        else:
            frame, cls, ids = render(world, cam, seed=t, annotate=True)
            if obstacle_blackout is not None and (
                obstacle_blackout[0] <= t < obstacle_blackout[1]
            ):
                # the detector misses the robot: robot classes become the
                # no-bump ball class (ids stay -1 there)
                cls = np.where((cls == 1) | (cls == 2), 3, cls).astype(np.uint8)
            depth_d = torch.from_numpy(frame.depth.astype(np.int32)).to(dev)
            cls_d = torch.from_numpy(cls).to(dev)
            scene = fuse_scene(depth_d, cls_d, torch.from_numpy(ids).to(dev), cam, geom)
        height = _host(scene.height)
        balls = _host(scene.balls)

        # ego-motion of the camera-relative birdseye frame from the previous
        # commanded maneuver (the sim's odometry), for the bank and the memory
        d_col = d_row = 0.0
        if log:
            prev = log[-1]
            d_col = -prev.turn * cam.width / (2.0 * math.tan(cam.x_fov / 2.0))
            d_row = prev.advance_mm * cam.height / cam.max_depth_mm

        if obstacle_memory > 0.0:
            fresh = _host(robot_occupancy(depth_d, cls_d, cam, geom))
            if obstacle_mem is None:
                obstacle_mem = fresh
            else:
                if log:
                    obstacle_mem = _shift_map(obstacle_mem, d_col, d_row)
                obstacle_mem = np.maximum(fresh, obstacle_mem * obstacle_memory)
            height = np.maximum(height, obstacle_mem)

        if measurement_blackout is not None and (
            measurement_blackout[0] <= t < measurement_blackout[1]
        ):
            balls = np.zeros_like(balls)  # detector outage / full occlusion
        if tracker is not None:
            if log:  # ego-motion compensation from the previous command
                tracks = shift_tracks(tracks, d_col, d_row)
            # the tracker kernel: the bank stepped in place, the seed slots out
            seeds = track_banks(tracks, torch.from_numpy(balls).to(dev), tracker,
                                balls.shape[0])
            balls = _host(seeds)

        # the device planner relaxes on the device the maps came from
        path = plan_from_height(torch.from_numpy(height).to(dev) if pcfg.backend == "tpu"
                                else height, balls, pcfg)
        if path_store is not None:
            path_store.set(path)
        turn, advance = follower.command(path)
        world.step(turn, advance)
        min_clear = min(min_clear, world.obstacle_clearance())
        d = world.ball_distance()
        log.append(TickLog(t, world.x, world.z, world.heading, d, turn, advance,
                           len(path.directions)))
        if log_fn is not None:
            log_fn(
                f"tick {t:3d}: pos=({world.x:7.0f},{world.z:7.0f}) "
                f"head={math.degrees(world.heading):6.1f}° ball={d:6.0f}mm "
                f"turn={math.degrees(turn):6.1f}° adv={advance:5.0f}mm "
                f"dirs={len(path.directions)}"
            )
        if d <= reach_mm:
            reached = True
            break
    return {
        "reached": reached,
        "ticks_used": len(log),
        "final_ball_mm": world.ball_distance(),
        "min_obstacle_clearance_mm": min_clear,
        "log": log,
    }


def model_engine(cam: CameraConfig, checkpoint: str | None = None, device=None):
    """The detect-mode ``Engine`` of the sim's model perception: the model
    at the camera's size rounded down to a multiple of 8, the host planner
    with signed turns, the weights of the ``.npz`` ``checkpoint`` (the
    pinned ``yolact_dr`` weights when None)."""
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig
    from tod_tpu_torch.core.weights import load_checkpoint
    from tod_tpu_torch.runtime.engine import Engine

    mcfg = ModelConfig(input_size=(cam.height // 8 * 8, cam.width // 8 * 8))
    cfg = PipelineConfig(
        camera=cam, model=mcfg,
        planner=PlannerConfig(signed_turns=True, start_offset=cam.width // 2,
                              backend="numpy"),
    )
    params = None if checkpoint is None else load_checkpoint(checkpoint, mcfg)
    return Engine(cfg, params=params, mode="detect", device=device)


def main(argv=None, device=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="tod_tpu_torch.sim",
                                description="closed-loop drive-to-ball simulation")
    p.add_argument("--ball", action="append", default=None,
                   help="x,z in mm (repeatable); default -700,2400")
    p.add_argument("--obstacle", action="append", default=None,
                   help="x,z in mm (repeatable)")
    p.add_argument("--ticks", type=int, default=40)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--perception", choices=("oracle", "model"), default="oracle")
    p.add_argument("--checkpoint", default=None,
                   help="with --perception model: a checkpoint .npz (default the pinned "
                   "yolact_dr weights)")
    p.add_argument("--dump-dir", default=None,
                   help="write a top-down trail.png of the run here")
    args = p.parse_args(argv)

    def _parse(items, default, flag):
        if not items:
            return default
        out = []
        for it in items:
            parts = it.split(",")
            try:
                if len(parts) != 2:
                    raise ValueError
                out.append((float(parts[0]), float(parts[1])))
            except ValueError:
                p.error(f"{flag} expects 'x,z' in mm, got {it!r}")
        return out

    cam = CameraConfig(width=args.width, height=args.height)
    world = SimWorld(
        balls=[Ball(x, z) for x, z in _parse(args.ball, [(-700.0, 2400.0)], "--ball")],
        obstacles=[Obstacle(x, z) for x, z in _parse(args.obstacle, [], "--obstacle")],
    )
    engine = None
    if args.perception == "model":
        engine = model_engine(cam, args.checkpoint, device)
    t0 = time.perf_counter()
    m = run_closed_loop(world, cam, engine=engine, perception=args.perception,
                        ticks=args.ticks, log_fn=print, device=device)
    print(
        f"{'REACHED' if m['reached'] else 'not reached'} in {m['ticks_used']} ticks "
        f"({time.perf_counter() - t0:.1f}s); final ball distance "
        f"{m['final_ball_mm']:.0f} mm; min obstacle clearance "
        f"{m['min_obstacle_clearance_mm']:.0f} mm"
    )
    if args.dump_dir:
        print("trail plot:", dump_run(world, args.dump_dir))
    return 0 if m["reached"] else 1


def dump_run(world: SimWorld, out_dir: str, mm_per_px: float = 10.0) -> str:
    """Write a top-down metric plot of the run (trail, balls, obstacles) as
    ``trail.png`` in ``out_dir`` through the port's PNG writer."""
    import pathlib

    from tod_tpu_torch.utils.image_io import save_rgb

    xs = [p[0] for p in world.trail] + [b.x for b in world.balls] + [
        o.x for o in world.obstacles
    ]
    zs = [p[1] for p in world.trail] + [b.z for b in world.balls] + [
        o.z for o in world.obstacles
    ]
    margin = 500.0
    x0, x1 = min(xs) - margin, max(xs) + margin
    z0, z1 = min(zs) - margin, max(zs) + margin
    w = max(int((x1 - x0) / mm_per_px), 32)
    h = max(int((z1 - z0) / mm_per_px), 32)
    img = np.full((h, w, 3), 235, np.uint8)

    def px(x, z):
        # world +z up the image
        return (
            min(max(int((z1 - z) / mm_per_px), 0), h - 1),
            min(max(int((x - x0) / mm_per_px), 0), w - 1),
        )

    def blot(r, c, rad, color):
        rr, cc = np.mgrid[max(r - rad, 0):min(r + rad + 1, h),
                          max(c - rad, 0):min(c + rad + 1, w)]
        m = (rr - r) ** 2 + (cc - c) ** 2 <= rad * rad
        img[rr[m], cc[m]] = color

    for o in world.obstacles:
        r0, c0 = px(o.x - o.half_w, o.z + o.half_w)
        r1, c1 = px(o.x + o.half_w, o.z - o.half_w)
        img[min(r0, r1):max(r0, r1) + 1, min(c0, c1):max(c0, c1) + 1] = (
            (220, 60, 60) if o.team == "red" else (60, 80, 220)
        )
    for b in world.balls:
        blot(*px(b.x, b.z), max(int(b.radius / mm_per_px), 2), (230, 200, 30))
    for x, z in world.trail:
        blot(*px(x, z), 2, (40, 150, 60))
    blot(*px(*world.trail[0]), 4, (0, 0, 0))          # start
    blot(*px(world.x, world.z), 4, (200, 40, 160))    # end

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trail.png"
    save_rgb(path, img)
    return str(path)


if __name__ == "__main__":
    raise SystemExit(main())
