"""Grid planner: Bellman-Ford relaxation to a fixpoint on the device, then
the path walk (counterpart of the JAX package's ``planner/tpu_relax.py``).

Each sweep updates, over the 8 directions at once,

    dist[n] = min(dist[n], min_i dist[n + off_i] + connections[n][i] + |dheight|)

The JAX graph tests for a change after every sweep inside its while loop.
Here the host would have to read a flag back per sweep (up to 2048 syncs),
so the loop runs ``CHECK_EVERY`` sweeps per block, records each sweep's
change flag on the device, and reads the block's flags at once: the
distances and the sweep count are those of the JAX loop, since sweeps past
the fixpoint change nothing.

The path walk follows ``next_dir`` from the start node on the device
(``kernels/path_walk.py``), so only the plan buffer is read back; it has the
JAX layout: row 0 is ``(n_valid, truncated)``, rows 1.. the (magnitude,
rotation) pairs, zeros past ``n_valid``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS
from tod_tpu_torch.kernels.connections import connection_weights
from tod_tpu_torch.kernels.path_walk import INF, walk_path
from tod_tpu_torch.ops.nms import top_k

CHECK_EVERY = 16  # sweeps per convergence readback


def start_node_yx(grid_hw: tuple[int, int], offset: int = 240) -> tuple[int, int]:
    """The robot's position: (H-1, W-offset), clamped onto the grid."""
    h, w = grid_hw
    return h - 1, min(max(0, w - offset), w - 1)


def _shifted(x: torch.Tensor, fill: float) -> torch.Tensor:
    """(8, H, W) stack with out[i][p] = x[p + NEIGHBOR_OFFSETS[i]], ``fill`` off-grid."""
    h, w = x.shape
    padded = F.pad(x[None, None], (1, 1, 1, 1), value=fill)[0, 0]
    return torch.stack(
        [padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy, dx in NEIGHBOR_OFFSETS]
    )


def bellman_ford_grid(height: torch.Tensor, connections: torch.Tensor,
                      seed_mask: torch.Tensor, max_iters: int = 2048):
    """height (H, W), connections (H, W, 8) (-1 = no edge), seed_mask (H, W)
    bool -> (dist (H, W) f32, next_dir (H, W) int64, sweeps).

    ``next_dir[p]`` is the NEIGHBOR_OFFSETS index of the next hop toward the
    nearest seed, -1 at seeds and unreached nodes.  ``sweeps`` counts the
    sweeps the JAX while loop would run: up to and including the first one
    that changes nothing, at most ``max_iters``.
    """
    height = height.to(torch.float32)
    edge = connections.to(torch.float32).permute(2, 0, 1)
    has_edge = edge >= 0
    dh = torch.abs(height - _shifted(height, 0.0))

    def candidates(dist):
        return torch.where(has_edge, _shifted(dist, INF) + edge + dh, INF)

    dist = torch.where(seed_mask, 0.0, INF).to(torch.float32)
    sweeps = 0
    while sweeps < max_iters:
        flags = []
        for _ in range(min(CHECK_EVERY, max_iters - sweeps)):
            new = torch.minimum(dist, candidates(dist).amin(dim=0))
            flags.append((new < dist).any())
            dist = new
        changed = torch.stack(flags).cpu().numpy()
        if not changed.all():
            sweeps += int(np.argmin(changed)) + 1
            break
        sweeps += len(flags)
    best = candidates(dist).argmin(dim=0)
    next_dir = torch.where(seed_mask | ~(dist < INF), -1, best)
    return dist, next_dir, sweeps


def _seed_mask(balls: torch.Tensor, hw, max_seeds: int, min_pixels: float) -> torch.Tensor:
    """The ``max_seeds`` ball slots with the most pixels, above ``min_pixels``
    and on the grid, as a boolean seed map."""
    h, w = hw
    topv, topi = top_k(balls[:, 2], max_seeds)
    ys = torch.round(balls[topi, 1]).to(torch.int64)
    xs = torch.round(balls[topi, 0]).to(torch.int64)
    ok = (topv > max(min_pixels, 0.0)) & (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    lin = torch.where(ok, ys * w + xs, 0)
    seed = torch.zeros(h * w, dtype=torch.int32, device=balls.device)
    seed.scatter_reduce_(0, lin, ok.to(torch.int32), reduce="amax")
    return seed.reshape(h, w).bool()


def plan_on_device(height: torch.Tensor, balls: torch.Tensor, start_yx: tuple[int, int],
                   max_seeds: int = 3, min_pixels: float = 3.0, max_steps: int = 1024,
                   max_iters: int = 2048, signed: bool = False):
    """Ball slots -> seeds -> relaxation (edges from kernel K2) -> path walk
    (kernel ``path_walk``).

    Returns ``(plan, sweeps)``: the (max_steps + 1, 2) f32 plan buffer on
    ``height``'s device, and the relaxation sweeps to convergence.
    """
    with record_function("stage/relaxation"):
        height = height.to(torch.float32).contiguous()
        seed_mask = _seed_mask(balls, height.shape, max_seeds, min_pixels)
        _, conns = connection_weights(height)
        dist, next_dir, sweeps = bellman_ford_grid(height, conns, seed_mask, max_iters)
    with record_function("stage/walk"):
        plan = walk_path(dist, next_dir, start_yx, max_steps, signed)
    return plan, sweeps
