"""Grid planner on the device: seeds from the ball slots, Bellman-Ford to a
fixpoint, then the path walk (counterpart of the JAX package's
``planner/tpu_relax.py``).

The relaxation (``kernels/relax.py``) and the walk (``kernels/path_walk.py``)
are kernels on the card, so ``plan_on_device`` on a CUDA tensor only enqueues
work: nothing is read back until the caller copies the plan.  The plan
buffer has the JAX layout: row 0 is ``(n_valid, truncated)``, rows 1.. the
(magnitude, rotation) pairs, zeros past ``n_valid``.
"""

from __future__ import annotations

import torch

from tod_tpu_torch.kernels.connections import connection_planes
from tod_tpu_torch.kernels.path_walk import walk_path
from tod_tpu_torch.kernels.relax import bellman_ford_grid
from tod_tpu_torch.ops.nms import top_k
from tod_tpu_torch.planner.dijkstra import start_node_yx
from tod_tpu_torch.runtime.profiler import span

__all__ = ["bellman_ford_grid", "plan_on_device", "start_node_yx"]


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
    """Ball slots -> seeds -> relaxation (edges from kernel K2) -> path walk.

    Returns ``(plan, sweeps)``: the (max_steps + 1, 2) f32 plan buffer and
    the relaxation's sweep count (a 0-dim int32 tensor), both on
    ``height``'s device.
    """
    with span("stage/relaxation"):
        height = height.to(torch.float32).contiguous()
        seeds = _seed_mask(balls, height.shape, max_seeds, min_pixels)
        conns = connection_planes(height)
        dist, next_dir, sweeps = bellman_ford_grid(height, conns, seeds, max_iters)
    with span("stage/walk"):
        plan = walk_path(dist, next_dir, start_yx, max_steps, signed)
    return plan, sweeps
