"""Multi-source Dijkstra over the fused scene grid: the host planner's NumPy
backend and the path extraction (counterpart of the JAX package's
``planner/dijkstra.py``, whose code this is).

It implements the intent of the reference's ``modify_path``: arrays sized to
the real H x W grid, ball seeds at ``x + y*W``, a true priority queue, and all
8 neighbours, matching the 8 connection weights of the fusion stage.  The
edge cost from node n to neighbour m via direction i is
``connections[n][i] + |height[n] - height[m]|``.

The direction extraction walks from the start node to the nearest ball,
emitting ``(magnitude, rotation)`` pairs: the cost drop along each hop and the
ground-plane turning angle between consecutive segments.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS


def seeds_from_balls(
    balls: np.ndarray,
    max_seeds: int,
    grid_hw: tuple[int, int],
    min_pixels: float = 0.0,
):
    """Ball SSBO slots (max_balls, 4) of (x̄, ȳ, count, 0) → list of in-grid
    (y, x) integer seeds, strongest (most pixels) first, at most ``max_seeds``.

    The reference unconditionally sliced the first 3 slots (src/path.rs:37),
    seeding garbage when fewer balls exist; intent: only real detections.
    ``min_pixels`` suppresses phantom slots backed by a few fringe pixels
    (e.g. a duplicate detection surviving Fast-NMS).
    """
    h, w = grid_hw
    order = np.argsort(-balls[:, 2])
    seeds = []
    for i in order[:max_seeds]:
        if balls[i, 2] <= max(min_pixels, 0.0):
            break
        y = int(round(float(balls[i, 1])))
        x = int(round(float(balls[i, 0])))
        if 0 <= y < h and 0 <= x < w:
            seeds.append((y, x))
    return seeds


def dijkstra_grid(height: np.ndarray, connections: np.ndarray, seeds):
    """Multi-source Dijkstra. → (dist (H, W) f64, parent (H, W) i32 linear
    next-hop toward the nearest seed, −1 at seeds/unreached)."""
    h, w = height.shape
    dist = np.full((h, w), np.inf, np.float64)
    parent = np.full((h, w), -1, np.int64)
    pq: list[tuple[float, int, int]] = []
    for y, x in seeds:
        dist[y, x] = 0.0
        heapq.heappush(pq, (0.0, y, x))
    while pq:
        d, y, x = heapq.heappop(pq)
        if d > dist[y, x]:
            continue
        for i, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
            ny, nx = y + dy, x + dx
            if not (0 <= ny < h and 0 <= nx < w):
                continue
            c = connections[ny, nx, (i + 4) % 8]  # edge as seen from the neighbor
            if c < 0:
                continue
            nd = d + c + abs(float(height[ny, nx]) - float(height[y, x]))
            if nd < dist[ny, nx]:
                dist[ny, nx] = nd
                parent[ny, nx] = y * w + x
                heapq.heappush(pq, (nd, ny, nx))
    return dist, parent


def extract_directions(
    dist: np.ndarray,
    parent: np.ndarray,
    pos: np.ndarray,
    start_yx: tuple[int, int],
    max_steps: int | None = None,
    signed: bool = False,
):
    """Walk the parent chain from the start node, emitting (magnitude, rotation)
    per hop.

    ``signed=False`` (default) reproduces the reference's semantics verbatim
    (src/path.rs:93-111): rotation = UNSIGNED acos between the backward and
    forward ground-plane segments at each node (straight ahead = π, left and
    right indistinguishable), first rotation = 0.

    ``signed=True`` is the drivable turn-chain intent
    (PlannerConfig.signed_turns): rotation[i] = signed atan2 turn from the
    current heading to hop i's segment (0 = straight, positive = toward +x),
    heading starts at the robot's facing (0, −1) — up the map — and follows
    each hop.  "Turn rotation[i], advance magnitude[i]" then traces the path.
    """
    h, w = dist.shape
    y, x = start_yx
    if not np.isfinite(dist[y, x]):
        return []
    directions = []
    rotation = 0.0
    hx, hz = 0.0, -1.0  # signed mode: initial facing, up the map
    steps = 0
    limit = max_steps if max_steps is not None else h * w
    while parent[y, x] >= 0 and steps < limit:
        p = int(parent[y, x])
        py, px = divmod(p, w)
        magnitude = float(dist[y, x] - dist[py, px])
        if signed:
            # hop segment in the ground plane (pos components x=0, z=2)
            sx = float(pos[py, px, 0] - pos[y, x, 0])
            sz = float(pos[py, px, 2] - pos[y, x, 2])
            if sx != 0.0 or sz != 0.0:
                rotation = math.atan2(hx * sz - hz * sx, hx * sx + hz * sz)
                hx, hz = sx, sz
            else:
                rotation = 0.0
            directions.append((magnitude, float(rotation)))
        else:
            directions.append((magnitude, float(rotation)))
            # turning angle for the NEXT hop, between segment (prev←cur) and
            # (next←cur), in the ground plane (pos components x=0, y=2)
            pp = int(parent[py, px]) if parent[py, px] >= 0 else p
            gy, gx = divmod(pp, w)
            a = (pos[y, x, 0] - pos[py, px, 0], pos[y, x, 2] - pos[py, px, 2])
            b = (pos[gy, gx, 0] - pos[py, px, 0], pos[gy, gx, 2] - pos[py, px, 2])
            na, nb = math.hypot(*a), math.hypot(*b)
            if na > 0 and nb > 0:
                cosang = max(-1.0, min(1.0, (a[0] * b[0] + a[1] * b[1]) / (na * nb)))
                rotation = math.acos(cosang)
            else:
                rotation = 0.0
        y, x = py, px
        steps += 1
    return directions


def start_node_yx(grid_hw: tuple[int, int], offset: int = 240) -> tuple[int, int]:
    """The robot's own position on the map: the reference's START_NODE is
    ``H·W − 240`` → (H−1, W−240) for its 640-wide grid (src/path.rs:93);
    generalized as an offset from the end of the bottom row, clamped onto
    the grid (offset ≤ 0 would otherwise index column w — one past the
    row, and a heap overflow at the native planner's C ABI)."""
    h, w = grid_hw
    return h - 1, min(max(0, w - offset), w - 1)
