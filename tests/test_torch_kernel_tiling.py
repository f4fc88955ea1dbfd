"""The work plans of kernels K1 (``csrc/mask_assembly.cu``), K2
(``csrc/connections.cu``) and K3/K4 (``csrc/bump.cu``), rehearsed in plain
torch.

Neither CUDA kernel runs here.  What surrounds their arithmetic is
rehearsed step for step instead: K1's pixel tiles, detection groups,
zero-padded staging, rotated register loads and per-warp stores; K2's row
bands staged with a NaN halo at the kernel's column offset and row stride,
and its float4 stores (N, NE, E, SE and their negations); K3/K4's blocks of
32 columns by ``bump_tiling``'s rows.  Each rehearsal
writes every output once, which the tests count, and is held against the
plain torch version and the JAX package's Pallas kernel in interpret mode.
The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and by the cases of ``tests/test_torch_kernels.py`` that
skip without CUDA.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.kernels.connections import connection_weights as pallas_connections
from tod_tpu.kernels.mask_assembly import assemble_crop_masks as pallas_masks
from tod_tpu_torch.kernels import bump as k3
from tod_tpu_torch.kernels import connections as k2
from tod_tpu_torch.kernels import mask_assembly as k1
from tod_tpu_torch.ops import ieee

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

SMS = 132  # an H100's SM count: the plans the kernels take there
NAN = float("nan")


def k1_inputs(seed: int, b: int, hm: int, wm: int, k: int, n: int):
    rng = np.random.default_rng(seed)
    protos = np.maximum(rng.normal(0, 1, (b, hm, wm, k)), 0).astype(np.float32)
    coeffs = np.tanh(rng.normal(0, 1, (b, n, k))).astype(np.float32)
    centre = rng.uniform(-0.1, 1.1, (b, n, 2))
    size = rng.uniform(0.05, 0.6, (b, n, 2))
    boxes = np.concatenate([centre - size / 2, centre + size / 2], axis=-1).astype(np.float32)
    return protos, coeffs, boxes


def k2_height(seed: int, h: int, w: int) -> np.ndarray:
    """Heights with NaN inside and on every edge and corner."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 80, (h, w)).astype(np.float32)
    hm[rng.random((h, w)) < 0.05] = np.nan
    hm[0, w // 2] = hm[h - 1, w // 3] = hm[h // 2, 0] = hm[h // 3, w - 1] = np.nan
    if h * w > 1:
        hm[0, 0] = hm[h - 1, w - 1] = np.nan
    return hm


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf``: the product is exact in float64, the sum rounded there
    and then to float32 (the same as one rounding for these magnitudes)."""
    return (a.double() * b.double() + c.double()).float()


def rehearse_k1(protos, coeffs, boxes, sms: int = SMS):
    """``csrc/mask_assembly.cu`` step for step on the CPU -> (masks
    (B, N, Hm, Wm), how many times each mask value was written)."""
    b, hm, wm, k = protos.shape
    n, hw = coeffs.shape[1], hm * wm
    t = k1.mask_tiling(b, hw, n, k, sms)
    k4 = -(-k // 4)
    kp = 4 * k4
    tiles = -(-hw // t.pixels)
    slices = t.pixels // 32
    blk = torch.arange(t.blocks)[:, None]
    tid = torch.arange(t.threads)[None, :]
    bi = blk // tiles
    p0 = (blk % tiles) * t.pixels
    lane, warp = tid % 32, tid // 32
    px = (warp % slices) * 32 + lane
    g = (warp // slices).expand(t.blocks, -1)
    live = (p0 + px) < hw  # a thread past the ragged tile's last pixel returns
    # staging: the tile's prototype rows and every detection's coefficients,
    # zero-padded to whole float4s (a bulk copy delivers the same bytes)
    flat = torch.zeros(b, tiles * t.pixels, kp)
    flat[:, :hw, :k] = protos.reshape(b, hw, k)
    slab = flat.reshape(b * tiles, t.pixels, kp)
    cf = torch.zeros(b, n, kp)
    cf[:, :, :k] = coeffs
    # each thread's registers: float4 (s + r) % K4 into q[s], then rotated
    rows = slab[blk, px].reshape(t.blocks, t.threads, k4, 4)
    r = (lane % k4).expand(t.blocks, -1)
    idx = (torch.arange(k4)[None, None, :] + r[..., None]) % k4
    q = torch.gather(rows, 2, idx[..., None].expand(-1, -1, -1, 4))
    bit = 1
    while bit < k4:
        on = ((r & bit) != 0)[..., None, None]
        q = torch.where(on, torch.roll(q, bit, dims=2), q)  # t[c] = q[(c - bit) % K4]
        bit <<= 1
    assert torch.equal(q, rows)  # the rotation restored the pixel's row
    q = q.reshape(t.blocks, t.threads, kp)
    p = p0 + px
    y, x = p // wm, p % wm
    ys = ieee.div(y.float() + 0.5, float(hm))
    xs = ieee.div(x.float() + 0.5, float(wm))
    out = torch.zeros(b, n, hw)
    writes = torch.zeros(b, n, hw, dtype=torch.int64)
    for m in range(-(-n // t.groups)):
        j = g + m * t.groups
        ok = live & (j < n)
        c = cf[bi.expand(-1, t.threads), j.clamp(max=n - 1)]
        acc = torch.zeros(t.blocks, t.threads)
        for i in range(kp):  # each chain over k in order
            acc = fma_f32(c[..., i], q[..., i], acc)
        box = boxes[bi.expand(-1, t.threads), j.clamp(max=n - 1)]
        inside = (ys >= box[..., 0]) & (ys <= box[..., 2]) & (xs >= box[..., 1]) & (xs <= box[..., 3])
        val = torch.where(inside, 1.0 / (1.0 + torch.exp(-acc)), 0.0)
        sel = (bi.expand(-1, t.threads)[ok], j[ok], p.expand(t.blocks, -1)[ok])
        out.index_put_(sel, val[ok])
        writes.index_put_(sel, torch.ones_like(val[ok], dtype=torch.int64), accumulate=True)
    return out.reshape(b, n, hm, wm), writes.reshape(b, n, hm, wm)


def rehearse_k2(height: torch.Tensor, sms: int = SMS):
    """``csrc/connections.cu`` step for step on the CPU -> (connections
    (H, W, 8), how many times each float4 was written)."""
    h, w = height.shape
    t = k2.connection_tiling(h, w, sms)
    out = torch.zeros(h * w * 2, 4)
    writes = torch.zeros(h * w * 2, dtype=torch.int64)
    for block in range(t.blocks):
        y0 = block * t.rows
        nr = min(t.rows, h - y0)
        # shared memory: 7.0 where the kernel writes nothing, so a read
        # outside the staged rows and halo would show
        s = torch.full(((t.rows + 2) * t.stride,), 7.0)
        for r in range(nr + 2):
            base = r * t.stride + k2.COL
            s[base - 1] = s[base + w] = NAN
            y = y0 - 1 + r
            s[base : base + w] = height[y] if 0 <= y < h else NAN
        f = torch.arange(nr * 2 * w)
        node, half = f // 2, f % 2
        cp = (node // w + 1) * t.stride + k2.COL + node % w
        sg = 1 - 2 * half
        c = s[cp]
        vals = []
        for i, off in enumerate((-t.stride, 1 - t.stride, 1, t.stride + 1)):
            nh = s[cp + off * sg]
            diff = (c - nh).double()
            d = ieee.sqrt((diff * diff + (2.0 if i % 2 else 1.0)).float())
            vals.append(torch.where(torch.isnan(nh), -1.0, d))
        g = y0 * w * 2 + f
        out[g] = torch.stack(vals, dim=-1)
        writes[g] += 1
    return out.reshape(h, w, 8), writes.reshape(h, w, 2)


K1_SHAPES = [  # (B, Hm, Wm, K, N)
    (1, 64, 80, 32, 32),  # the main path
    (2, 13, 17, 5, 7),  # odd K, a ragged tile
    (1, 37, 53, 32, 32),  # pixels not a multiple of the tile
    (1, 64, 80, 32, 1),
    (1, 64, 80, 32, 33),
    (2, 64, 80, 32, 32),
    (1, 3, 5, 4, 3),  # fewer pixels than a warp
]


class TestMaskTiling:
    @pytest.mark.parametrize("b,hm,wm,k,n", K1_SHAPES)
    def test_plan_within_limits(self, b, hm, wm, k, n):
        t = k1.mask_tiling(b, hm * wm, n, k, SMS)
        assert t.pixels % 32 == 0 and 32 <= t.pixels <= k1.MAX_PIXELS
        assert t.threads == t.pixels * t.groups and t.threads % 32 == 0
        assert t.threads <= k1.MAX_THREADS and t.smem_bytes <= k1.SMEM_LIMIT
        assert t.blocks == b * -(-hm * wm // t.pixels)
        assert -(-n // t.groups) <= k1.DETS or t.threads > k1.MAX_THREADS - t.pixels
        # every SM gets a block where the pixels allow it, and no larger
        # tile would still give every SM one
        if b * -(-hm * wm // 32) >= SMS:
            assert t.blocks >= SMS
        if t.pixels < k1.MAX_PIXELS:
            assert b * -(-hm * wm // (t.pixels + 32)) < SMS

    def test_main_path_plan(self):
        t = k1.mask_tiling(1, 64 * 80, 32, 32, SMS)
        assert (t.pixels, t.groups, t.threads, t.blocks) == (32, 8, 256, 160)
        assert t.smem_bytes == 16 + 4 * (32 * 64 + 4 * 32)

    @pytest.mark.parametrize("b,hm,wm,k,n", K1_SHAPES)
    def test_rehearsal_writes_each_mask_value_once_and_matches_plain(self, b, hm, wm, k, n):
        protos, coeffs, boxes = map(torch.from_numpy, k1_inputs(7, b, hm, wm, k, n))
        got, writes = rehearse_k1(protos, coeffs, boxes)
        assert bool((writes == 1).all())
        want = k1.plain_assemble_crop_masks(protos, coeffs, boxes)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        assert torch.equal(got == 0, want == 0)

    @pytest.mark.parametrize("hm,wm,k,n", [(64, 80, 32, 32), (13, 17, 5, 7)])
    def test_rehearsal_matches_pallas_interpret(self, hm, wm, k, n):
        protos, coeffs, boxes = k1_inputs(8, 1, hm, wm, k, n)
        got, _ = rehearse_k1(*map(torch.from_numpy, (protos, coeffs, boxes)))
        want = np.asarray(pallas_masks(jnp.asarray(protos[0]), jnp.asarray(coeffs[0]),
                                       jnp.asarray(boxes[0]), interpret=True))
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[0].numpy() == 0, want == 0)

    def test_plan_raises_past_its_limits(self):
        with pytest.raises(ValueError, match="MAX_K = 32"):
            k1.mask_tiling(1, 5120, 32, 33, SMS)
        with pytest.raises(ValueError, match="shared memory"):
            k1.mask_tiling(1, 5120, 2000, 32, SMS)


class TestMaskAssemblyWrapperChecks:
    def _args(self, k=4):
        return [torch.from_numpy(a) for a in k1_inputs(9, 1, 6, 7, k, 3)]

    def test_rejects_k_above_the_limit_before_any_launch(self):
        before = k1.assemble_crop_masks.launches
        with pytest.raises(ValueError, match="MAX_K = 32"):
            k1.assemble_crop_masks(*self._args(k=33))
        assert k1.assemble_crop_masks.launches == before

    @pytest.mark.parametrize("which", [0, 1, 2])
    def test_rejects_non_f32(self, which):
        args = self._args()
        args[which] = args[which].double()
        with pytest.raises(ValueError, match="contiguous float32"):
            k1.assemble_crop_masks(*args)

    @pytest.mark.parametrize("which", [0, 1, 2])
    def test_rejects_non_contiguous(self, which):
        args = self._args()
        a = args[which]
        args[which] = torch.flip(a.transpose(-1, -2).contiguous(), [0]).transpose(-1, -2)
        assert not args[which].is_contiguous()
        with pytest.raises(ValueError, match="contiguous float32"):
            k1.assemble_crop_masks(*args)


K2_SHAPES = [(37, 53), (1, 1), (61, 83), (480, 640), (479, 641), (960, 1280), (2, 9)]


class TestConnectionTiling:
    @pytest.mark.parametrize("h,w", K2_SHAPES)
    def test_bands_cover_every_row_once_within_limits(self, h, w):
        t = k2.connection_tiling(h, w, SMS)
        covered = torch.zeros(h, dtype=torch.int64)
        for block in range(t.blocks):
            covered[block * t.rows : min(h, (block + 1) * t.rows)] += 1
        assert bool((covered == 1).all())
        assert t.smem_bytes == k2.smem_bytes(t.rows, w) <= k2.SMEM_LIMIT
        assert t.stride % 16 == 8 and t.stride >= w + k2.COL + 1
        # no band height leaves fewer rows on the busiest SM
        busiest = -(-t.blocks // SMS) * t.rows
        for rows in range(1, h + 1):
            if k2.smem_bytes(rows, w) <= k2.SMEM_LIMIT:
                blocks = -(-h // rows)
                assert busiest <= -(-blocks // SMS) * rows

    def test_main_path_plan(self):
        """Bands of 1, 2 or 4 rows all leave 4 rows on the busiest SM; 2
        rows is the tallest that deals some SM a second band."""
        t = k2.connection_tiling(480, 640, SMS)
        assert (t.rows, t.blocks, t.stride) == (2, 240, 648)
        assert k2.connection_tiling(960, 1280, SMS).rows == 4
        assert k2.connection_tiling(37, 53, SMS).rows == 1

    def test_plan_raises_when_a_row_does_not_fit(self):
        with pytest.raises(ValueError, match="shared memory"):
            k2.connection_tiling(4, 60_000, SMS)

    @pytest.mark.parametrize("h,w", [(37, 53), (1, 1), (61, 83), (2, 9)])
    def test_rehearsal_bit_for_bit_with_plain_and_pallas(self, h, w):
        hm = k2_height(11, h, w)
        got, writes = rehearse_k2(torch.from_numpy(hm))
        assert bool((writes == 1).all())
        want = k2.plain_connection_planes(torch.from_numpy(hm))
        torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
        _, jax_conns = pallas_connections(jnp.asarray(hm), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_conns))

    def test_rehearsal_on_few_sms_takes_taller_bands(self):
        hm = k2_height(12, 61, 83)
        got, writes = rehearse_k2(torch.from_numpy(hm), sms=4)
        assert k2.connection_tiling(61, 83, 4).rows > 1
        assert bool((writes == 1).all())
        torch.testing.assert_close(got, k2.plain_connection_planes(torch.from_numpy(hm)),
                                   atol=0, rtol=0, equal_nan=True)


class TestConnectionPlanes:
    @pytest.mark.parametrize("h,w", [(37, 53), (1, 1), (16, 24)])
    def test_planes_and_pos_exact_against_pallas(self, h, w):
        hm = k2_height(13, h, w)
        before = k2.connection_planes.launches
        planes = k2.connection_planes(torch.from_numpy(hm))
        pos, conns = k2.connection_weights(torch.from_numpy(hm))
        jax_pos, jax_conns = pallas_connections(jnp.asarray(hm), interpret=True)
        np.testing.assert_array_equal(planes.numpy(), np.asarray(jax_conns))
        np.testing.assert_array_equal(conns.numpy(), np.asarray(jax_conns))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jax_pos))
        assert k2.connection_planes.launches == before  # no kernel ran

    def test_rejects_non_f32_and_non_contiguous_before_any_launch(self):
        hm = torch.from_numpy(k2_height(14, 12, 10))
        before = k2.connection_planes.launches
        for bad in (hm.double(), hm.t(), hm[:, ::2]):
            for fn in (k2.connection_planes, k2.connection_weights):
                with pytest.raises(ValueError, match="contiguous float32"):
                    fn(bad)
        with pytest.raises(ValueError, match=r"\(H, W\)"):
            k2.connection_planes(hm[None])
        assert k2.connection_planes.launches == before

    def test_plan_on_device_forms_no_positions(self, monkeypatch):
        """The planner asks K2 for its planes only."""
        from tod_tpu_torch.planner import relax

        calls = []
        monkeypatch.setattr(k2, "positions", lambda *a: calls.append(a))
        plan, _ = relax.plan_on_device(torch.zeros(16, 16), torch.zeros(8, 4), (15, 8))
        assert calls == [] and plan.shape == (1025, 2)


def bump_writes(h: int, w: int, t) -> torch.Tensor:
    """How many times csrc/bump.cu writes each output pixel under tiling t:
    block (bx, by), thread (tx, ty) writes rows ``by * tile_h + ty * pixels
    + p`` of column ``bx * 32 + tx`` that lie on the map."""
    writes = torch.zeros(h, w, dtype=torch.int64)
    oy = (torch.arange(t.blocks_y)[:, None, None] * t.tile_h
          + torch.arange(t.rows)[None, :, None] * t.pixels
          + torch.arange(t.pixels)[None, None, :]).reshape(-1)
    ox = (torch.arange(t.blocks_x)[:, None] * k3.TILE_W + torch.arange(k3.TILE_W)[None, :]).reshape(-1)
    oy, ox = oy[oy < h], ox[ox < w]
    writes.index_put_((oy[:, None].expand(-1, len(ox)), ox[None, :].expand(len(oy), -1)),
                      torch.ones(len(oy), len(ox), dtype=torch.int64), accumulate=True)
    return writes


class TestBumpTiling:
    @pytest.mark.parametrize("h,w", [(480, 640), (240, 320), (37, 53), (960, 1280)])
    @pytest.mark.parametrize("sms", [SMS, 16])
    def test_covers_every_pixel_once_within_limits(self, h, w, sms):
        t = k3.bump_tiling(h, w, 10, sms)
        assert bool((bump_writes(h, w, t) == 1).all())
        assert t.pixels in k3.PIXELS and t.threads == 32 * t.rows <= 1024
        assert t.smem_bytes == k3.smem_bytes(t.tile_h, 10) <= k3.SMEM_LIMIT
        # every SM gets a block, unless the tile is already one row
        assert t.blocks >= sms or t.tile_h == 1

    def test_main_path_plan(self):
        t = k3.bump_tiling(480, 640, 10, SMS)
        assert (t.pixels, t.rows, t.blocks, t.threads) == (2, 4, 1200, 128)
        assert t.smem_bytes == 4 * (8 + 19) * (32 + 19)

    def test_takes_the_sm_count_into_account(self):
        """A small map takes smaller tiles on more SMs, the default on few."""
        few, many = k3.bump_tiling(37, 53, 10, 4), k3.bump_tiling(37, 53, 10, SMS)
        assert (few.pixels, few.rows) == (k3.DEFAULT_PIXELS, k3.DEFAULT_ROWS)
        assert many.tile_h < few.tile_h and many.blocks > few.blocks
        assert k3.bump_tiling(37, 53, 10, 16).tile_h == 4

    def test_given_tilings_and_limits(self):
        t = k3.bump_tiling(480, 640, 10, SMS, pixels=4, rows=4)
        assert (t.tile_h, t.blocks) == (16, 20 * 30)
        assert bool((bump_writes(480, 640, t) == 1).all())
        assert k3.bump_tiling(480, 100, 47, SMS).smem_bytes > 48 * 1024  # needs the opt-in
        with pytest.raises(ValueError, match="bump_size 200"):
            k3.bump_tiling(480, 640, 200, SMS)
        with pytest.raises(ValueError, match="bump_size"):
            k3.bump_tiling(480, 640, 0, SMS)
        with pytest.raises(ValueError, match="no tiling"):
            k3.bump_tiling(480, 640, 10, SMS, pixels=3, rows=4)
        with pytest.raises(ValueError, match="no tiling"):
            k3.bump_tiling(480, 640, 10, SMS, pixels=2, rows=k3.MAX_ROWS + 1)
        # the largest tile fits shared memory at L = 47; the tile shrinks to
        # fit it, down to one row at L = 113, the largest radius that fits
        assert k3.bump_tiling(480, 640, 47, SMS, pixels=4, rows=32).smem_bytes <= k3.SMEM_LIMIT
        assert k3.bump_tiling(480, 640, 112, SMS).tile_h == 4
        assert k3.bump_tiling(480, 640, 113, SMS).tile_h == 1
        with pytest.raises(ValueError, match="bump_size 114"):
            k3.bump_tiling(480, 640, 114, SMS)
