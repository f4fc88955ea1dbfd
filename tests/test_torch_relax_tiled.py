"""The tiled relaxation of ``csrc/relax.cu``, rehearsed in plain torch.

The CUDA kernel runs only on a card.  Its algorithm is rehearsed here step
for step: tiles of ``relax_tiling`` held with a ghost ring k nodes wide, k
Jacobi sweeps a batch over a cone that shrinks by one ring a sweep, change
flags from the tile's own nodes only, the tile's distances kept between
batches when every tile has a block (else each block loops over its tiles
and reloads them), and distances double-buffered between batches.  The
rehearsal is held bit for bit (dist, next_dir, sweep count) against
``plain_bellman_ford_grid`` and exactly (dist, next_dir) against the JAX
package's ``bellman_ford_grid``.  The kernel itself is held against the
plain version on the card by ``chip_smoke.py`` and the marked test below.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.planner.tpu_relax import bellman_ford_grid as jax_bellman_ford_grid
from tod_tpu_torch.core.types import NEIGHBOR_OFFSETS
from tod_tpu_torch.kernels.connections import connection_weights
from tod_tpu_torch.kernels.relax import (
    INF,
    NODE_BYTES,
    SMEM_LIMIT,
    THREADS,
    bellman_ford_grid,
    plain_bellman_ford_grid,
    relax_tiling,
)

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

SMS = 132  # an H100's SM count: the tilings the kernel takes there


def scene(seed: int, h: int, w: int, seeded: bool = True):
    """A rolling height map (a random walk down the rows, as
    ``tests/test_torch_kernels.py`` makes it), its K2 edges and a seed map."""
    rng = np.random.default_rng(seed)
    hm = np.cumsum(rng.normal(0, 0.3, (h, w)), axis=0).astype(np.float32)
    hm -= hm.min()
    seeds = np.zeros((h, w), bool)
    if seeded:
        seeds[8 % h, w - 14] = seeds[h // 2, 10] = True
    height = torch.from_numpy(hm)
    _, conns = connection_weights(height)
    return height, conns, torch.from_numpy(seeds)


def random_edges_scene(seed: int, h: int, w: int):
    """Random heights and edges, some missing and some leading off the map
    (which K2 never gives), with three seeds."""
    rng = np.random.default_rng(seed)
    height = torch.from_numpy(rng.uniform(0, 5, (h, w)).astype(np.float32))
    conns = rng.uniform(0, 2, (h, w, 8)).astype(np.float32)
    conns[rng.random((h, w, 8)) < 0.2] = -1.0
    seeds = np.zeros((h, w), bool)
    seeds[0, 0] = seeds[h - 1, w // 3] = seeds[h // 2, w - 1] = True
    return height, torch.from_numpy(conns), torch.from_numpy(seeds)


def region_index(h: int, w: int, t) -> torch.Tensor:
    """(tiles, rh, rw) flat map index of each region node, -1 off the map."""
    tiles_x = -(-w // t.tile_w)
    ti = torch.arange(t.tiles)
    y0 = (ti // tiles_x) * t.tile_h - t.k
    x0 = (ti % tiles_x) * t.tile_w - t.k
    gy = y0[:, None, None] + torch.arange(t.tile_h + 2 * t.k)[None, :, None]
    gx = x0[:, None, None] + torch.arange(t.tile_w + 2 * t.k)[None, None, :]
    on = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    return torch.where(on, gy * w + gx, -1)


def gather(flat: torch.Tensor, idx: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(idx >= 0, flat[idx.clamp(min=0)], fill)


def sweep(d, e, hgt, on, ring, k, th, tw):
    """One Jacobi sweep of a stack of regions over the nodes at least
    ``ring`` rings inside them -> (the other buffer's update mask and values,
    whether a tile node changed, per region)."""
    n, rh, rw = d.shape
    c = d[:, 1:-1, 1:-1]
    hc = hgt[:, 1:-1, 1:-1]
    best = c
    for i, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        dn = d[:, 1 + dy : rh - 1 + dy, 1 + dx : rw - 1 + dx]
        hn = hgt[:, 1 + dy : rh - 1 + dy, 1 + dx : rw - 1 + dx]
        best = torch.minimum(best, (dn + e[:, i, 1:-1, 1:-1]) + torch.abs(hc - hn))
    best = torch.nn.functional.pad(best, (1, 1, 1, 1), value=INF)
    ys = torch.arange(rh)[:, None]
    xs = torch.arange(rw)[None, :]
    cone = (ys >= ring) & (ys < rh - ring) & (xs >= ring) & (xs < rw - ring)
    own = (ys >= k) & (ys < k + th) & (xs >= k) & (xs < k + tw)
    update = cone & on
    changed = ((best < d) & update & own).flatten(1).any(dim=1)
    return update, best, changed


def rehearse(height, conns, seed_mask, max_iters, t, blocks=None):
    """The kernel's algorithm -> (dist, next_dir, sweeps as an int)."""
    h, w = height.shape
    blocks = t.blocks if blocks is None else blocks
    k, th, tw = t.k, t.tile_h, t.tile_w
    idx = region_index(h, w, t)
    on = idx >= 0
    flat_seed = torch.where(seed_mask, 0.0, INF).flatten()
    # constants: a missing edge is +inf, off-map heights 0
    edges = torch.where(conns >= 0, conns, torch.inf).reshape(h * w, 8)
    e = torch.where(on[:, None], edges[idx.clamp(min=0)].permute(0, 3, 1, 2), torch.inf)
    hgt = gather(height.flatten(), idx, 0.0)
    own = torch.zeros_like(on)
    own[:, k : k + th, k : k + tw] = True
    own &= on
    # the other buffer starts as garbage (0, below any distance) on the map:
    # the cone must never read it
    garbage = torch.where(on, 0.0, INF)
    resident = t.tiles <= blocks
    if resident:  # one region a block, kept in "shared memory" for the launch
        groups = [torch.arange(t.tiles)]
        smem = [gather(flat_seed, idx, INF), garbage.clone()]
    else:  # block b loops over tiles b, b + blocks, ...
        groups = [torch.arange(b, t.tiles, blocks) for b in range(blocks)]
    buf = [torch.empty(h * w), torch.empty(h * w)]
    flags = torch.zeros(max_iters + 1, dtype=torch.bool)
    sweeps = batch = cur = 0
    while sweeps < max_iters:
        kk = min(k, max_iters - sweeps)
        src = buf[batch & 1] if batch else flat_seed
        out = buf[(batch + 1) & 1]
        for tiles in groups:
            if resident:  # only the ring comes from global memory
                ring = gather(src, idx[tiles], INF)
                d = [smem[0][tiles], smem[1][tiles]]
                d[cur] = torch.where(own[tiles], d[cur], ring)
            else:  # each tile reloaded whole
                d = [gather(src, idx[tiles], INF), garbage[tiles]]
                cur = 0
            for j in range(1, kk + 1):
                update, best, changed = sweep(d[cur], e[tiles], hgt[tiles], on[tiles],
                                              k - kk + j, k, th, tw)
                d[cur ^ 1] = torch.where(update, best, d[cur ^ 1])
                flags[sweeps + j - 1] |= bool(changed.any())
                cur ^= 1
            o = own[tiles]
            out[idx[tiles][o]] = d[cur][o]
            if resident:
                smem = d
        window = flags[sweeps : sweeps + kk].tolist()
        batch += 1
        if not all(window):
            sweeps += window.index(False) + 1
            break
        sweeps += kk
    dist = (buf[batch & 1] if batch else flat_seed).reshape(h, w).clone()
    # the epilogue: the first argmin over the 1-ring, with the plain padding
    pd = torch.nn.functional.pad(dist, (1, 1, 1, 1), value=INF)
    ph = torch.nn.functional.pad(height, (1, 1, 1, 1), value=0.0)
    cands = torch.stack([
        torch.where(conns[..., i] >= 0,
                    (pd[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] + conns[..., i])
                    + torch.abs(height - ph[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]), INF)
        for i, (dy, dx) in enumerate(NEIGHBOR_OFFSETS)])
    next_dir = torch.where(seed_mask | ~(dist < INF), -1, cands.argmin(dim=0))
    return dist, next_dir, sweeps


def assert_same(got, want):
    assert got[2] == want[2], f"sweeps {got[2]} against {want[2]}"
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def assert_matches_jax(got, height, conns, seed_mask, max_iters):
    jd, jn = jax_bellman_ford_grid(jnp.asarray(height.numpy()), jnp.asarray(conns.numpy()),
                                   jnp.asarray(seed_mask.numpy()), max_iters=max_iters)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jn).astype(np.int64))


MAPS = {"37x53": (20, 37, 53, True), "61x83": (21, 61, 83, True),
        "37x53 seedless": (22, 37, 53, False), "61x83 random edges": (26, 61, 83, None)}


def map_args(name: str):
    seed, h, w, seeded = MAPS[name]
    return random_edges_scene(seed, h, w) if seeded is None else scene(seed, h, w, seeded)


class TestTiledRehearsal:
    @pytest.mark.parametrize("name", list(MAPS))
    def test_fixpoint_matches_plain_and_jax(self, name):
        args = map_args(name)
        h, w = args[0].shape
        t = relax_tiling(h, w, SMS)
        got = rehearse(*args, 2048, t)
        assert_same(got, plain_bellman_ford_grid(*args, 2048))
        assert_matches_jax(got, *args, 2048)
        if not args[2].any():
            assert got[2] == 1 and (got[1] == -1).all()

    @pytest.mark.parametrize("cap", ["0", "1", "k", "k+1", "sweeps-1", "sweeps-2"])
    @pytest.mark.parametrize("name", ["37x53", "61x83", "61x83 random edges"])
    def test_capped_sweeps_match_plain_and_jax(self, name, cap):
        args = map_args(name)
        h, w = args[0].shape
        t = relax_tiling(h, w, SMS)
        full = plain_bellman_ford_grid(*args, 2048)[2]
        max_iters = {"0": 0, "1": 1, "k": t.k, "k+1": t.k + 1, "sweeps-1": full - 1,
                     "sweeps-2": full - 2}[cap]
        got = rehearse(*args, max_iters, t)
        assert_same(got, plain_bellman_ford_grid(*args, max_iters))
        assert_matches_jax(got, *args, max_iters)
        assert got[2] == max_iters

    @pytest.mark.parametrize("k,tile,blocks", [(3, (9, 10), 8), (4, (5, 7), 5), (1, (16, 16), 2)])
    @pytest.mark.parametrize("name", ["61x83", "61x83 random edges"])
    def test_blocks_looping_over_tiles(self, k, tile, blocks, name):
        args = map_args(name)
        t = relax_tiling(61, 83, blocks, k=k, tile=tile)
        assert t.tiles > t.blocks == blocks
        want = plain_bellman_ford_grid(*args, 2048)
        assert_same(rehearse(*args, 2048, t), want)
        assert_same(rehearse(*args, want[2] - 2, t), plain_bellman_ford_grid(*args, want[2] - 2))

    @pytest.mark.parametrize("k,tile", [(2, (7, 11)), (6, (10, 20)), (5, (30, 83))])
    def test_resident_tilings_of_other_shapes(self, k, tile):
        args = scene(24, 61, 83)
        t = relax_tiling(61, 83, SMS, k=k, tile=tile)
        assert t.tiles <= t.blocks
        assert_same(rehearse(*args, 2048, t), plain_bellman_ford_grid(*args, 2048))


class TestRelaxTiling:
    @pytest.mark.parametrize("h,w", [(480, 640), (479, 641), (960, 1280), (240, 320), (37, 53),
                                     (61, 83), (1, 1), (1, 700)])
    def test_tiles_cover_the_map_and_fit_shared_memory(self, h, w):
        t = relax_tiling(h, w, SMS)
        tiles_y, tiles_x = -(-h // t.tile_h), -(-w // t.tile_w)
        assert (tiles_y - 1) * t.tile_h < h <= tiles_y * t.tile_h
        assert (tiles_x - 1) * t.tile_w < w <= tiles_x * t.tile_w
        assert t.tiles == tiles_y * tiles_x and t.blocks == min(t.tiles, SMS)
        rh, rw = t.tile_h + 2 * t.k, t.tile_w + 2 * t.k
        assert t.smem_bytes == NODE_BYTES * rh * rw + 4 * t.k * THREADS
        assert t.smem_bytes <= SMEM_LIMIT == 227 * 1024
        assert rw - 2 <= THREADS and rw <= 1023 and rh <= 2047

    def test_vga_on_an_h100_is_one_resident_tile_a_block(self):
        t = relax_tiling(480, 640, SMS)
        assert t.tiles <= SMS and t.blocks == t.tiles

    def test_large_map_loops_over_tiles(self):
        t = relax_tiling(960, 1280, SMS)
        assert t.tiles > t.blocks == SMS

    def test_choice_follows_the_arguments_alone(self):
        assert relax_tiling(479, 641, SMS) == relax_tiling(479, 641, SMS)
        assert relax_tiling(480, 640, 66) != relax_tiling(480, 640, SMS)

    def test_rejects_what_cannot_be_tiled(self):
        with pytest.raises(ValueError):
            relax_tiling(0, 5, SMS)
        with pytest.raises(ValueError):
            relax_tiling(480, 640, SMS, tile=(480, 640))
        with pytest.raises(ValueError):
            relax_tiling(10, 10, SMS, k=33)
        with pytest.raises(ValueError):  # even a 1x1 tile's ring is too wide
            relax_tiling(10, 10, SMS, k=32)
        with pytest.raises(ValueError):
            relax_tiling(4, 600, SMS, tile=(4, 600))  # wider than a block's threads


class TestKernelOnCuda:
    @pytest.mark.parametrize("h,w,cap", [(61, 83, None), (37, 53, 9), (479, 641, None)])
    def test_kernel_matches_plain_on_cuda(self, h, w, cap):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
        height, conns, seed_mask = (a.cuda() for a in scene(25, h, w))
        max_iters = 2048 if cap is None else cap
        dist, nxt, sweeps = bellman_ford_grid(height, conns, seed_mask, max_iters)
        want = plain_bellman_ford_grid(height, conns, seed_mask, max_iters)
        assert_same((dist, nxt, int(sweeps)), want)
