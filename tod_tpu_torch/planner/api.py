"""Planner facade: scene -> Path over the backends (counterpart of the JAX
package's ``planner/api.py``).

- ``numpy``   host Dijkstra with a priority queue (``planner/dijkstra.py``)
- ``native``  C++ Dijkstra through ctypes (``planner/native.py``, ``native/``)
- ``tpu``     the relaxation on the device (``kernels/relax.py``), on the
              height tensor's device: the card's kernel on a CUDA tensor
- ``auto``    native if its library builds, else numpy
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from tod_tpu_torch.core.config import PLANNER_BACKENDS, PlannerConfig
from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS, Path
from tod_tpu_torch.planner.dijkstra import (
    dijkstra_grid,
    extract_directions,
    seeds_from_balls,
    start_node_yx,
)

log = logging.getLogger(__name__)


def host_backend(backend: str) -> str:
    """The planner that ``backend`` selects on the host: ``auto`` is
    ``native`` when its library builds (at first use; the loader logs a
    failed build) and ``numpy`` otherwise; ``native`` raises when the
    library is missing."""
    from tod_tpu_torch.native import loader

    if backend not in PLANNER_BACKENDS:
        raise ValueError(f"unknown planner backend {backend!r}")
    if backend == "auto":
        backend = "native" if loader.available() else "numpy"
    elif backend == "native" and not loader.available():
        raise RuntimeError("native planner backend requested but its library is unavailable")
    return backend


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _connections_from_height(height: np.ndarray) -> np.ndarray:
    """The (H, W, 8) edge weights from the height map with NumPy shifts, as
    the JAX package's host planner computes them."""
    h, w = height.shape
    padded = np.pad(height.astype(np.float32), 1, constant_values=np.nan)
    conns = np.empty((h, w, 8), np.float32)
    for i, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        nh = padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        d = np.sqrt(dx * dx + dy * dy + (height - nh) ** 2)
        conns[..., i] = np.where(np.isnan(nh), -1.0, d)
    return conns


def _pos_from_height(height: np.ndarray) -> np.ndarray:
    h, w = height.shape
    pos = np.empty((h, w, 3), np.float32)
    pos[..., 0] = np.arange(w, dtype=np.float32)[None, :]
    pos[..., 1] = height
    pos[..., 2] = np.arange(h, dtype=np.float32)[:, None]
    return pos


def _relaxed_directions(height: np.ndarray, connections: np.ndarray, pos: np.ndarray, seeds,
                        start, cfg: PlannerConfig, device) -> list:
    """The ``tpu`` backend: the relaxation on ``device``, then the host walk
    over its next-hop map (the JAX package's ``extract_directions_from_next``)."""
    from tod_tpu_torch.kernels.relax import INF, bellman_ford_grid

    hw = height.shape
    seed_mask = np.zeros(hw, bool)
    for y, x in seeds:
        seed_mask[y, x] = True
    maps = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (height, connections, seed_mask))
    dist, next_dir, _ = bellman_ford_grid(*maps, max_iters=cfg.tpu_max_iters)
    dist, next_dir = _host(dist), _host(next_dir)
    w = hw[1]
    parent = np.full(hw, -1, np.int64)
    ys, xs = np.nonzero(next_dir >= 0)
    for y, x in zip(ys, xs):
        dy, dx = NEIGHBOR_OFFSETS[next_dir[y, x]]
        parent[y, x] = (y + dy) * w + (x + dx)
    dist = np.where(dist >= INF, np.inf, dist)
    return extract_directions(dist, parent, pos, start, signed=cfg.signed_turns)


def plan_from_height(height, balls, cfg: PlannerConfig | None = None) -> Path:
    """Plan from the height map and the ball slots alone.

    The connection weights and world positions are functions of the height
    map, so the host-planner serving loop reads back only the height (as
    f16) and the balls, and the native backend derives the edges inline.
    ``height`` and ``balls`` are numpy arrays or tensors; the ``tpu``
    backend relaxes on ``height``'s device.
    """
    cfg = cfg or PlannerConfig()
    device = height.device if isinstance(height, torch.Tensor) else torch.device("cpu")
    height = np.ascontiguousarray(_host(height), np.float32)
    hw = height.shape
    seeds = seeds_from_balls(_host(balls).astype(np.float32), cfg.max_seed_balls, hw,
                             min_pixels=cfg.min_ball_pixels)
    if not seeds:
        return Path(created=time.time(), directions=[])
    start = start_node_yx(hw, offset=cfg.start_offset)
    pos = _pos_from_height(height)
    backend = cfg.backend if cfg.backend == "tpu" else host_backend(cfg.backend)
    if backend == "native":
        from tod_tpu_torch.native import loader

        dist = np.empty(hw, np.float64)
        parent = np.empty(hw, np.int64)
        seed_arr = np.ascontiguousarray(np.array(seeds, np.int32))
        lib = loader.get()
        fn = lib.tod_dijkstra_height_bidir if cfg.bidirectional else lib.tod_dijkstra_height
        fn(height.reshape(-1), hw[0], hw[1], seed_arr.reshape(-1), len(seeds), start[0],
           start[1], dist.reshape(-1), parent.reshape(-1))
        directions = extract_directions(dist, parent, pos, start, signed=cfg.signed_turns)
    elif backend == "tpu":
        directions = _relaxed_directions(height, _connections_from_height(height), pos, seeds,
                                         start, cfg, device)
    else:
        dist, parent = dijkstra_grid(height, _connections_from_height(height), seeds)
        directions = extract_directions(dist, parent, pos, start, signed=cfg.signed_turns)
    return Path(created=time.time(), directions=directions)


def dispatch_plan_device(height, balls, cfg: PlannerConfig | None = None,
                         start_yx: tuple[int, int] | None = None) -> torch.Tensor:
    """Enqueue the device plan (``planner/relax.py plan_on_device``: seeds,
    the relaxation, the path walk) on the height map's device, without
    waiting -> the (max_steps + 1, 2) f32 plan buffer there (row 0 the
    header with n_valid)."""
    from tod_tpu_torch.planner.relax import plan_on_device

    cfg = cfg or PlannerConfig()
    h, w = height.shape
    start = start_yx or start_node_yx((h, w), offset=cfg.start_offset)
    buf, _ = plan_on_device(height, balls, start, max_seeds=cfg.max_seed_balls,
                            min_pixels=cfg.min_ball_pixels, max_steps=cfg.max_path_steps,
                            max_iters=cfg.tpu_max_iters, signed=cfg.signed_turns)
    return buf


def plan_directions_device(height, balls, cfg: PlannerConfig | None = None,
                           start_yx: tuple[int, int] | None = None) -> Path:
    """Plan on the device and read back only the plan buffer (a few KB,
    where the height map is ~1 MB) -> the Path."""
    return materialize_path(dispatch_plan_device(height, balls, cfg, start_yx))


_warned_truncated = False


def materialize_path(plan) -> Path:
    """Decode a plan buffer read back from the device planner (row 0
    ``(n_valid, truncated)``) into a Path; a truncated plan is logged once
    per process, and ``Path.truncated`` carries it per plan."""
    global _warned_truncated
    path = Path.from_plan(plan)
    if path.truncated and not _warned_truncated:
        _warned_truncated = True
        log.warning("device plan truncated at %d steps (PlannerConfig.max_path_steps); further "
                    "truncations reported via Path.truncated only", len(path.directions))
    return path


def plan(scene, cfg: PlannerConfig | None = None) -> Path:
    """Driving directions from a fused :class:`~tod_tpu_torch.core.types.Scene`
    (its fields numpy arrays or tensors); the ``tpu`` backend relaxes on the
    scene's device."""
    cfg = cfg or PlannerConfig()
    device = (scene.height.device if isinstance(scene.height, torch.Tensor)
              else torch.device("cpu"))
    height = _host(scene.height).astype(np.float32)
    connections = _host(scene.connections).astype(np.float32)
    pos = _host(scene.pos).astype(np.float32)
    balls = _host(scene.balls).astype(np.float32)
    hw = height.shape
    seeds = seeds_from_balls(balls, cfg.max_seed_balls, hw, min_pixels=cfg.min_ball_pixels)
    start = start_node_yx(hw, offset=cfg.start_offset)
    if not seeds:
        return Path(created=time.time(), directions=[])
    backend = cfg.backend if cfg.backend == "tpu" else host_backend(cfg.backend)
    if backend == "tpu":
        directions = _relaxed_directions(height, connections, pos, seeds, start, cfg, device)
    else:
        if backend == "native":
            from tod_tpu_torch.planner.native import dijkstra_native

            dist, parent = dijkstra_native(height, connections, seeds)
        else:
            dist, parent = dijkstra_grid(height, connections, seeds)
        directions = extract_directions(dist, parent, pos, start, signed=cfg.signed_turns)
    return Path(created=time.time(), directions=directions)
