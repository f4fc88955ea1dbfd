"""Kernels K1 (mask assembly), K2 (connection weights), the relaxation and
the path walk: the port's plain versions against the JAX package (its Pallas
kernels in interpret mode, and the relaxation and walk of
``planner/tpu_relax.py``), and the wrappers' CPU behaviour.  The CUDA
kernels themselves are held against the plain versions on the card
(``chip_smoke.py``, and the cases below that skip without CUDA)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.kernels.connections import connection_weights as pallas_connections
from tod_tpu.kernels.mask_assembly import assemble_crop_masks as pallas_masks
from tod_tpu_torch.kernels.connections import (
    connection_planes,
    connection_weights,
    plain_connection_weights,
)
from tod_tpu_torch.kernels.mask_assembly import assemble_crop_masks, plain_assemble_crop_masks
from tod_tpu_torch.kernels.path_walk import plain_walk_path, walk_path

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


def k1_inputs(seed: int, b: int, hm: int, wm: int, k: int, n: int):
    rng = np.random.default_rng(seed)
    protos = np.maximum(rng.normal(0, 1, (b, hm, wm, k)), 0).astype(np.float32)
    coeffs = np.tanh(rng.normal(0, 1, (b, n, k))).astype(np.float32)
    centre = rng.uniform(-0.1, 1.1, (b, n, 2))
    size = rng.uniform(0.05, 0.6, (b, n, 2))
    boxes = np.concatenate([centre - size / 2, centre + size / 2], axis=-1).astype(np.float32)
    return protos, coeffs, boxes


def k2_height(seed: int, h: int, w: int, nan_frac: float = 0.05) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 80, (h, w)).astype(np.float32)
    hm[rng.random((h, w)) < nan_frac] = np.nan
    return hm


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


class TestMaskAssembly:
    @pytest.mark.parametrize("hm,wm,k,n", [(64, 80, 32, 32), (13, 17, 5, 7)])
    def test_plain_matches_pallas_interpret(self, hm, wm, k, n):
        protos, coeffs, boxes = k1_inputs(0, 1, hm, wm, k, n)
        got = plain_assemble_crop_masks(*map(torch.from_numpy, (protos, coeffs, boxes)))[0]
        want = np.asarray(
            pallas_masks(jnp.asarray(protos[0]), jnp.asarray(coeffs[0]), jnp.asarray(boxes[0]),
                         interpret=True)
        )
        # 1e-6: sigmoid of a K-term f32 dot product summed in another order
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        # the crop decisions (pixel centres vs box bounds) are identical
        np.testing.assert_array_equal(got.numpy() == 0, want == 0)

    def test_wrapper_on_cpu_runs_plain_version_per_batch(self):
        protos, coeffs, boxes = map(torch.from_numpy, k1_inputs(1, 3, 9, 11, 4, 5))
        before = assemble_crop_masks.launches
        got = assemble_crop_masks(protos, coeffs, boxes)
        assert got.shape == (3, 5, 9, 11) and got.dtype == torch.float32
        for i in range(3):
            want = plain_assemble_crop_masks(protos[i : i + 1], coeffs[i : i + 1], boxes[i : i + 1])
            torch.testing.assert_close(got[i : i + 1], want, atol=0, rtol=0)
        assert assemble_crop_masks.launches == before  # no kernel ran

    def test_wrapper_rejects_mismatched_shapes(self):
        protos, coeffs, boxes = map(torch.from_numpy, k1_inputs(2, 1, 4, 4, 3, 2))
        with pytest.raises(ValueError):
            assemble_crop_masks(protos[0], coeffs[0], boxes[0])
        with pytest.raises(ValueError):
            assemble_crop_masks(protos, coeffs[..., :2], boxes)

    @pytest.mark.parametrize("b,hm,wm,k,n", [
        (1, 64, 80, 32, 32), (2, 13, 17, 5, 7), (1, 37, 53, 32, 32), (1, 64, 80, 32, 1),
        (1, 64, 80, 32, 33), (2, 64, 80, 32, 32), (1, 3, 5, 4, 3),
    ])
    def test_kernel_matches_plain_on_cuda(self, b, hm, wm, k, n):
        require_cuda()
        args = [torch.from_numpy(a).cuda() for a in k1_inputs(3, b, hm, wm, k, n)]
        got = assemble_crop_masks(*args)
        want = plain_assemble_crop_masks(*args)
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
        assert torch.equal(got == 0, want == 0)


class TestConnections:
    @pytest.mark.parametrize("h,w", [(16, 24), (37, 53)])
    def test_plain_matches_pallas_interpret_exactly(self, h, w):
        hm = k2_height(4, h, w)
        pos, conns = plain_connection_weights(torch.from_numpy(hm))
        pos_p, conns_p = pallas_connections(jnp.asarray(hm), interpret=True)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_p))
        np.testing.assert_array_equal(conns.numpy(), np.asarray(conns_p))

    def test_wrapper_on_cpu_runs_plain_version(self):
        hm = torch.from_numpy(k2_height(5, 12, 10))
        before = connection_planes.launches
        pos, conns = connection_weights(hm)
        pos_p, conns_p = plain_connection_weights(hm)
        assert conns.shape == (12, 10, 8) and pos.shape == (12, 10, 3)
        torch.testing.assert_close(conns, conns_p, atol=0, rtol=0, equal_nan=True)
        torch.testing.assert_close(pos, pos_p, atol=0, rtol=0, equal_nan=True)
        assert connection_planes.launches == before
        # off-grid neighbours are -1: the top row has no N, NE, NW edges
        assert (conns[0, :, [0, 1, 7]] == -1).all()

    def test_wrapper_rejects_non_2d(self):
        with pytest.raises(ValueError):
            connection_weights(torch.zeros(2, 3, 4))

    @pytest.mark.parametrize("h,w", [(480, 640), (37, 53), (479, 641), (960, 1280), (1, 1)])
    def test_kernel_matches_plain_on_cuda(self, h, w):
        require_cuda()
        hm = torch.from_numpy(k2_height(6, h, w, nan_frac=0.01)).cuda()
        pos, conns = connection_weights(hm)
        pos_p, conns_p = plain_connection_weights(hm)
        torch.testing.assert_close(conns, conns_p, atol=0, rtol=0, equal_nan=True)
        torch.testing.assert_close(pos, pos_p, atol=0, rtol=0, equal_nan=True)


def walk_scene(seed: int, h: int = 48, w: int = 64):
    """A height map with two seeds, relaxed by the JAX package: its
    (height, dist, next_dir) as numpy, and the robot's start node."""
    from tod_tpu.planner.tpu_relax import bellman_ford_grid as jax_bf

    rng = np.random.default_rng(seed)
    hm = np.cumsum(rng.normal(0, 0.3, (h, w)), axis=0).astype(np.float32)
    hm -= hm.min()
    seeds = np.zeros((h, w), bool)
    seeds[8, w - 14] = seeds[h // 2, 10] = True
    _, conns = pallas_connections(jnp.asarray(hm), interpret=True)
    dist, nxt = jax_bf(jnp.asarray(hm), conns, jnp.asarray(seeds))
    return hm, seeds, np.array(dist), np.asarray(nxt).astype(np.int64), (h - 1, w // 2)


class TestPathWalk:
    @pytest.mark.parametrize("signed", [False, True])
    @pytest.mark.parametrize("max_steps", [256, 7])
    def test_plain_matches_jax_walk(self, signed, max_steps):
        """The walk of the JAX ``plan_on_device`` over the same relaxation."""
        from tod_tpu.planner.tpu_relax import plan_on_device as jax_plan

        hm, seeds, dist, nxt, start = walk_scene(7)
        ys, xs = np.nonzero(seeds)
        balls = np.zeros((8, 4), np.float32)
        balls[: len(ys), 0], balls[: len(ys), 1], balls[: len(ys), 2] = xs, ys, 50.0
        want = np.asarray(jax_plan(jnp.asarray(hm), jnp.asarray(balls), start,
                                   max_steps=max_steps, signed=signed))
        got = plain_walk_path(torch.from_numpy(dist), torch.from_numpy(nxt), start,
                              max_steps, signed).numpy()
        assert int(want[0, 0]) > 5
        # header and magnitudes exact: the same float32 subtractions
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        # turns: XLA's acos/atan2 against libm's, a few float32 ulps of pi
        np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-6, rtol=0)

    @pytest.mark.parametrize("signed", [False, True])
    def test_wrapper_on_cpu_runs_plain_version(self, signed):
        _, _, dist, nxt, start = walk_scene(8)
        d, n = torch.from_numpy(dist), torch.from_numpy(nxt)
        before = walk_path.launches
        got = walk_path(d, n, start, 64, signed)
        assert got.shape == (65, 2) and got.dtype == torch.float32
        torch.testing.assert_close(got, plain_walk_path(d, n, start, 64, signed), atol=0, rtol=0)
        assert walk_path.launches == before

    def test_unreached_start_gives_zeros(self):
        dist = torch.full((5, 6), 3.4e38)
        plan = walk_path(dist, torch.full((5, 6), -1, dtype=torch.int64), (4, 3), 10)
        assert plan.shape == (11, 2) and not plan.any()

    def test_wrapper_rejects_bad_arguments(self):
        dist, nxt = torch.zeros(4, 5), torch.zeros(4, 5, dtype=torch.int64)
        with pytest.raises(ValueError):
            walk_path(dist, nxt[:, :4], (3, 2), 8)
        with pytest.raises(ValueError):
            walk_path(dist, nxt, (4, 2), 8)

    @pytest.mark.parametrize("signed", [False, True])
    def test_kernel_matches_plain_on_cuda(self, signed):
        require_cuda()
        _, _, dist, nxt, start = walk_scene(9)
        d, n = torch.from_numpy(dist).cuda(), torch.from_numpy(nxt).cuda()
        got = walk_path(d, n, start, 256, signed).cpu()
        want = plain_walk_path(d, n, start, 256, signed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[:, 0], want[:, 0])
        # turns: acosf/atan2f against libm in the last bit
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


class TestRelax:
    """The relaxation's plain version against the JAX package's
    ``bellman_ford_grid`` and its wrapper's CPU behaviour; the CUDA kernel is
    held against the plain version bit for bit on the card."""

    @pytest.mark.parametrize("seed,h,w", [(10, 48, 64), (11, 37, 53)])
    def test_plain_matches_jax_exactly(self, seed, h, w):
        from tod_tpu.planner.tpu_relax import bellman_ford_grid as jax_bf
        from tod_tpu_torch.kernels.relax import plain_bellman_ford_grid

        hm, seeds, dist, nxt, _ = walk_scene(seed, h, w)
        _, conns = pallas_connections(jnp.asarray(hm), interpret=True)
        got_d, got_n, sweeps = plain_bellman_ford_grid(
            torch.from_numpy(hm), torch.from_numpy(np.array(conns)), torch.from_numpy(seeds))
        np.testing.assert_array_equal(got_d.numpy(), dist)
        np.testing.assert_array_equal(got_n.numpy(), nxt)
        jd, _ = jax_bf(jnp.asarray(hm), conns, jnp.asarray(seeds), max_iters=sweeps - 1)
        np.testing.assert_array_equal(np.asarray(jd), dist)  # the last sweep changed nothing
        jd, _ = jax_bf(jnp.asarray(hm), conns, jnp.asarray(seeds), max_iters=sweeps - 2)
        assert not np.array_equal(np.asarray(jd), dist)

    def test_wrapper_on_cpu_returns_a_sweep_tensor(self):
        from tod_tpu_torch.kernels.relax import bellman_ford_grid, plain_bellman_ford_grid

        hm, seeds, *_ = walk_scene(12)
        height, seed_mask = torch.from_numpy(hm), torch.from_numpy(seeds)
        _, conns = connection_weights(height)
        before = bellman_ford_grid.launches
        dist, nxt, sweeps = bellman_ford_grid(height, conns, seed_mask, max_iters=300)
        want = plain_bellman_ford_grid(height, conns, seed_mask, 300)
        assert sweeps.shape == () and sweeps.dtype == torch.int32 and int(sweeps) == want[2]
        assert torch.equal(dist, want[0]) and torch.equal(nxt, want[1])
        assert bellman_ford_grid.launches == before
        dist0, nxt0, none = bellman_ford_grid(height, conns, seed_mask, max_iters=0)
        assert int(none) == 0 and torch.equal(dist0 == 0, seed_mask)
        assert (nxt0 == -1).all()

    def test_wrapper_rejects_bad_arguments(self):
        from tod_tpu_torch.kernels.relax import bellman_ford_grid

        height, seeds = torch.zeros(4, 5), torch.zeros(4, 5, dtype=torch.bool)
        with pytest.raises(ValueError):
            bellman_ford_grid(height, torch.zeros(4, 5, 7), seeds)
        with pytest.raises(ValueError):
            bellman_ford_grid(height, torch.zeros(4, 5, 8), seeds[:, :4])
        with pytest.raises(ValueError):
            bellman_ford_grid(height, torch.zeros(4, 5, 8), seeds, max_iters=-1)

    @pytest.mark.parametrize("max_iters", [2048, 40])
    def test_kernel_matches_plain_on_cuda(self, max_iters):
        require_cuda()
        from tod_tpu_torch.kernels.relax import bellman_ford_grid, plain_bellman_ford_grid

        hm, seeds, *_ = walk_scene(13)
        height, seed_mask = torch.from_numpy(hm).cuda(), torch.from_numpy(seeds).cuda()
        _, conns = connection_weights(height)
        dist, nxt, sweeps = bellman_ford_grid(height, conns, seed_mask, max_iters)
        want_d, want_n, want_s = plain_bellman_ford_grid(height, conns, seed_mask, max_iters)
        assert torch.equal(dist, want_d) and torch.equal(nxt, want_n) and int(sweeps) == want_s
