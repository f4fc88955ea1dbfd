"""The planner's relaxation: Bellman-Ford over the 8-neighbour grid to a
fixpoint, then the next-hop argmin.

Counterpart of ``bellman_ford_grid`` in the JAX package's
``planner/tpu_relax.py``, a ``lax.while_loop`` that XLA keeps on the
device.  On a CUDA tensor the wrapper launches ``csrc/relax.cu``, one
cooperative kernel for the whole loop, and reads nothing back; on a CPU
tensor it runs the plain version below; while ``torch.export`` traces it,
it calls the custom op ``tod::bellman_ford_grid`` (the same two).  ``relax_tiling`` chooses the
kernel's tiles and batch depth from the map's shape and the SM count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tod_tpu_torch.core.device import sm_count
from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS
from tod_tpu_torch.kernels import _build
from tod_tpu_torch.kernels._build import SMEM_LIMIT

SOURCE = "relax"
SIGNATURES = {
    "tod_relax": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
}
INF = 3.4e38  # "unreached" (f32)
CHECK_EVERY = 16  # sweeps per convergence readback in the plain version
K = 8  # Jacobi sweeps per grid barrier (the ghost ring's width)
MAX_K = 32  # the kernel reads a batch's change flags as one warp's ballot
NODE_BYTES = 44  # shared memory a region node takes: 8 edges, height, 2 distances
THREADS = 512  # threads a block, csrc/relax.cu's TOD_THREADS


def smem_bytes(tile_h: int, tile_w: int, k: int, threads: int = THREADS) -> int:
    """A block's shared memory: the region's nodes, and a word a thread and
    ring for its share of each ring's sweeps."""
    return NODE_BYTES * (tile_h + 2 * k) * (tile_w + 2 * k) + 4 * k * threads


def region_fits(tile_h: int, tile_w: int, k: int, threads: int = THREADS) -> bool:
    """Whether the kernel takes the region: one column a thread (its width
    less the outer ring at most ``threads``), a column in 10 bits of the
    sweep plan and a row in 11."""
    rh, rw = tile_h + 2 * k, tile_w + 2 * k
    return rw - 2 <= threads and rw <= 1023 and rh <= 2047


class Tiling(NamedTuple):
    """How ``csrc/relax.cu`` cuts a map: ``tile_h`` x ``tile_w`` tiles, each
    held with a ring ``k`` nodes wide, ``blocks`` co-resident blocks (one a
    tile when ``tiles <= blocks``, else each loops over several)."""

    tile_h: int
    tile_w: int
    k: int
    tiles: int
    blocks: int
    smem_bytes: int


def _sides(n: int) -> list[int]:
    """The distinct tile sides ceil(n / m) for m = 1..n."""
    return sorted({-(-n // m) for m in range(1, n + 1)})


@functools.lru_cache(maxsize=64)
def relax_tiling(h: int, w: int, sms: int, k: int = K,
                 tile: tuple[int, int] | None = None) -> Tiling:
    """The tiling of an (h, w) map for a card with ``sms`` SMs, one block an SM.

    With ``tile`` None it takes, among the tiles that fit ``SMEM_LIMIT``
    and ``region_fits``, the one whose blocks sweep the fewest nodes (tiles
    a block x region, each region row counted in whole warps of 32: the
    kernel's warps walk its columns), preferring tilings that give every
    tile a block of its own.  Ties go to fewer tiles.  The choice depends on
    the arguments alone.
    """
    if min(h, w, sms, k) < 1 or k > MAX_K:
        raise ValueError(f"relax_tiling needs h, w, sms >= 1 and 1 <= k <= {MAX_K}, got "
                         f"{(h, w, sms, k)}")

    def tiling(th: int, tw: int) -> Tiling:
        tiles = -(-h // th) * -(-w // tw)
        return Tiling(th, tw, k, tiles, min(tiles, sms), smem_bytes(th, tw, k))

    if tile is not None:
        got = tiling(*tile)
    else:
        best = None
        for th in _sides(h):
            for tw in _sides(w):
                t = tiling(th, tw)
                if t.smem_bytes > SMEM_LIMIT or not region_fits(th, tw, k):
                    continue
                per_block = -(-t.tiles // sms)
                warp_nodes = (th + 2 * k) * -(-(tw + 2 * k) // 32) * 32
                key = (per_block > 1, per_block * warp_nodes, t.tiles)
                if best is None or key < best[0]:
                    best = key, t
        if best is None:
            raise ValueError(f"no tile fits {SMEM_LIMIT} bytes of shared memory at k={k}")
        got = best[1]
    if got.smem_bytes > SMEM_LIMIT or not region_fits(got.tile_h, got.tile_w, k):
        raise ValueError(f"tiling {got} needs more than {SMEM_LIMIT} bytes of shared memory "
                         f"or a region wider than {THREADS + 2} nodes")
    return got


def _shifted(x: torch.Tensor, fill: float) -> torch.Tensor:
    """(8, H, W) stack with out[i][p] = x[p + NEIGHBOR_OFFSETS[i]], ``fill`` off-grid."""
    h, w = x.shape
    padded = F.pad(x[None, None], (1, 1, 1, 1), value=fill)[0, 0]
    return torch.stack(
        [padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy, dx in NEIGHBOR_OFFSETS]
    )


def plain_bellman_ford_grid(height: torch.Tensor, connections: torch.Tensor,
                            seed_mask: torch.Tensor, max_iters: int = 2048):
    """The plain version -> (dist, next_dir, sweeps as an int).

    Each sweep updates, over the 8 directions at once,

        dist[n] = min(dist[n], min_i dist[n + off_i] + connections[n][i] + |dheight|)

    The JAX graph tests for a change after every sweep inside its while
    loop; here the host would have to read a flag back per sweep, so the loop
    runs ``CHECK_EVERY`` sweeps per block, records each sweep's change flag,
    and reads the block's flags at once.  Sweeps past the fixpoint change
    nothing, so the distances and the count are those of the JAX loop.
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


def bellman_ford_grid(height: torch.Tensor, connections: torch.Tensor,
                      seed_mask: torch.Tensor, max_iters: int = 2048):
    """height (H, W) f32, connections (H, W, 8) f32 (-1 = no edge), seed_mask
    (H, W) bool -> (dist (H, W) f32, next_dir (H, W) int64, sweeps).

    ``next_dir[p]`` is the NEIGHBOR_OFFSETS index of the next hop toward the
    nearest seed, -1 at seeds and unreached nodes.  ``sweeps``, a 0-dim int32
    tensor on the maps' device, counts the sweeps the JAX while loop would
    run: up to and including the first one that changes nothing, at most
    ``max_iters``.  On the card nothing is read back: ``int(sweeps)`` waits
    for the kernel.
    """
    h, w = height.shape
    max_iters = int(max_iters)
    if connections.shape != (h, w, 8) or seed_mask.shape != (h, w) or max_iters < 0:
        raise ValueError(
            f"expected height (H, W), connections (H, W, 8), seed_mask (H, W) and max_iters "
            f">= 0, got {tuple(height.shape)}, {tuple(connections.shape)}, "
            f"{tuple(seed_mask.shape)}, {max_iters}"
        )
    if torch.compiler.is_exporting():
        return _op(height, connections, seed_mask, max_iters)
    if height.device.type == "cpu":
        return _plain(height, connections, seed_mask, max_iters)
    return _launch(height, connections, seed_mask, max_iters)


def _plain(height: torch.Tensor, connections: torch.Tensor, seed_mask: torch.Tensor,
           max_iters: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dist, next_dir, sweeps = plain_bellman_ford_grid(height, connections, seed_mask, max_iters)
    return dist, next_dir, torch.tensor(sweeps, dtype=torch.int32)


def _launch(height: torch.Tensor, connections: torch.Tensor, seed_mask: torch.Tensor,
            max_iters: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h, w = height.shape
    dev = height.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tensors = (height, connections, seed_mask)
    if (height.dtype != torch.float32 or connections.dtype != torch.float32
            or seed_mask.dtype != torch.bool or any(t.device != dev for t in tensors)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"height and connections must be contiguous float32 and seed_mask "
                         f"contiguous bool, all on {dev}")
    if connections.data_ptr() % 16:
        raise ValueError("connections buffer is not 16-byte aligned")
    dist = torch.empty((h, w), dtype=torch.float32, device=dev)
    next_dir = torch.empty((h, w), dtype=torch.int64, device=dev)
    sweeps = torch.empty((), dtype=torch.int32, device=dev)
    if h * w == 0:  # the plain loop's first sweep finds nothing to change
        return dist, next_dir, sweeps.fill_(min(1, max_iters))
    scratch = torch.empty_like(dist)
    flags = torch.empty(max_iters + 1, dtype=torch.int32, device=dev)
    t = relax_tiling(h, w, sm_count(dev))
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.tod_relax(
            height.data_ptr(), connections.data_ptr(), seed_mask.data_ptr(), dist.data_ptr(),
            scratch.data_ptr(), next_dir.data_ptr(), flags.data_ptr(), sweeps.data_ptr(),
            h, w, max_iters, t.tile_h, t.tile_w, t.k, t.blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "relax launch")
    bellman_ford_grid.launches += 1
    return dist, next_dir, sweeps


bellman_ford_grid.launches = 0

_op = torch.library.custom_op("tod::bellman_ford_grid", _plain, mutates_args=(),
                              device_types="cpu")
_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _(height, connections, seed_mask, max_iters):
    return (height.new_empty(height.shape), height.new_empty(height.shape, dtype=torch.int64),
            height.new_empty((), dtype=torch.int32))
