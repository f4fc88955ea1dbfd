"""Kernels K3 and K4 (the terrain bump dilation): the port's wrappers on the
CPU, which run the plain ring loop, against the JAX package's Pallas kernels
in interpret mode and its XLA loop, exactly; the ring table both sides read;
and the ``pallas_bump`` route of the occupancy map.  The CUDA kernel itself
is held against the plain version on the card (``chip_smoke.py``, and the
case below that skips without CUDA)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core import config as jcfg
from tod_tpu.geometry.fusion import _dilate_peaks as jax_ring_loop
from tod_tpu.geometry.fusion import occupancy_map as jax_occupancy
from tod_tpu.kernels.bump import dilate_peaks as pallas_dilate
from tod_tpu.kernels.bump import dilate_peaks_strips as pallas_strips
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.geometry.fusion import occupancy_map
from tod_tpu_torch.kernels.bump import (
    POW_COPY,
    POW_GENERAL,
    POW_ONE,
    POW_RECIPROCAL,
    POW_RSQRT,
    POW_SQRT,
    dilate_peaks,
    dilate_peaks_strips,
    plain_dilate_peaks,
    pow_mode,
    ring_table,
)


def peak_map(seed: int, h: int, w: int, L: int, integral: bool, density: float = 0.08):
    """A P = L padded peak map: uniform floats, or integral values as the
    terrain's image rows are."""
    rng = np.random.default_rng(seed)
    ext = np.zeros((h + 2 * L, w + 2 * L), np.float32)
    m = rng.random(ext.shape) < density
    ext[m] = rng.integers(1, h, m.sum()) if integral else rng.uniform(1, 30, m.sum())
    return ext


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")


class TestAgainstPallas:
    @pytest.mark.parametrize("seed,integral", [(5, False), (6, True)])
    def test_strips_matches_pallas_interpret(self, seed, integral):
        h, w, L = 32, 40, 3
        ext = peak_map(seed, h, w, L, integral)
        want = np.asarray(pallas_strips(jnp.asarray(ext), L, 0.1, (h, w), strip_h=8,
                                        interpret=True))
        got = dilate_peaks_strips(torch.from_numpy(ext), L, 0.1, (h, w), strip_h=8)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed,integral", [(0, False), (1, True)])
    def test_whole_map_matches_pallas_interpret(self, seed, integral):
        h, w, L = 16, 24, 3
        ext = peak_map(seed, h, w, L, integral)
        want = np.asarray(pallas_dilate(jnp.asarray(ext), L, 0.1, (h, w), interpret=True))
        got = dilate_peaks(torch.from_numpy(ext), L, 0.1, (h, w))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_constant_value_delegates_to_the_closed_form(self):
        h, w, L = 16, 24, 5
        ext = peak_map(1, h, w, L, integral=False, density=0.04)
        ext[ext > 0] = 100.0
        want = np.asarray(pallas_dilate(jnp.asarray(ext), L, 0.1, (h, w), constant_val=100.0))
        before = dilate_peaks.launches
        got = dilate_peaks(torch.from_numpy(ext), L, 0.1, (h, w), constant_val=100.0)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), plain_dilate_peaks(torch.from_numpy(ext), L, 0.1, (h, w)).numpy())
        assert dilate_peaks.launches == before

    def test_ring_loop_at_L10_on_48_rows(self):
        """The app's radius: the strip kernel (interpret mode, 16-row strips)
        and the XLA loop against the port's ring loop."""
        h, w, L = 48, 64, 10
        ext = peak_map(3, h, w, L, integral=True, density=0.05)
        got = plain_dilate_peaks(torch.from_numpy(ext), L, 0.1, (h, w)).numpy()
        strips = np.asarray(pallas_strips(jnp.asarray(ext), L, 0.1, (h, w), strip_h=16,
                                          interpret=True))
        loop = np.asarray(jax.jit(jax_ring_loop, static_argnums=(1, 2, 3))(
            jnp.asarray(ext), L, 0.1, (h, w)))
        assert (got > 0).mean() > 0.5
        np.testing.assert_array_equal(got, strips)
        np.testing.assert_array_equal(got, loop)


class TestWrappers:
    def test_rejects_unaligned_strips(self):
        with pytest.raises(ValueError, match="strip_h"):
            dilate_peaks_strips(torch.zeros((36, 44)), 2, 0.1, (30, 40), strip_h=8)
        with pytest.raises(ValueError, match="strip_h"):
            pallas_strips(jnp.zeros((36, 44)), 2, 0.1, (30, 40), strip_h=8)

    def test_rejects_a_map_not_padded_by_L(self):
        with pytest.raises(ValueError, match="padded"):
            dilate_peaks(torch.zeros((34, 44)), 3, 0.1, (32, 40))
        with pytest.raises(ValueError, match="padded"):
            dilate_peaks(torch.zeros((36, 44)), 3, 0.1, (32, 40))

    def test_cpu_tensor_runs_the_plain_version(self):
        h, w, L = 32, 40, 3
        ext = torch.from_numpy(peak_map(2, h, w, L, integral=True))
        counts = dilate_peaks_strips.launches, dilate_peaks.launches
        want = plain_dilate_peaks(ext, L, 0.1, (h, w))
        assert torch.equal(dilate_peaks_strips(ext, L, 0.1, (h, w)), want)
        assert torch.equal(dilate_peaks(ext, L, 0.1, (h, w)), want)
        assert (dilate_peaks_strips.launches, dilate_peaks.launches) == counts

    @pytest.mark.parametrize("h,w,L", [(480, 640, 10), (37, 53, 10), (240, 320, 4)])
    def test_kernel_matches_plain_on_cuda(self, h, w, L):
        require_cuda()
        ext = torch.from_numpy(peak_map(4, h, w, L, integral=True, density=0.02)).cuda()
        want = plain_dilate_peaks(ext, L, 0.1, (h, w))
        assert torch.equal(dilate_peaks(ext, L, 0.1, (h, w)), want)
        if h % 16 == 0:
            assert torch.equal(dilate_peaks_strips(ext, L, 0.1, (h, w)), want)


class TestRingTable:
    @pytest.mark.parametrize("L", [3, 4, 10])
    def test_exponents_are_the_per_displacement_ones(self, L):
        """Every displacement of [-L, L-1]^2 once, in its ring, with the
        exponent the per-displacement loops form, ``(2/L) * sqrt(r2) - 1``
        in float64; rings ascend in r2."""
        rings = ring_table(L)
        seen = [d for _, disps, _ in rings for d in disps]
        assert sorted(seen) == [(dy, dx) for dy in range(-L, L) for dx in range(-L, L)]
        assert [r2 for r2, _, _ in rings] == sorted({dy * dy + dx * dx for dy, dx in seen})
        for r2, disps, exponent in rings:
            for dy, dx in disps:
                assert dy * dy + dx * dx == r2
                assert exponent == 2.0 / L * float((dy * dy + dx * dx) ** 0.5) - 1.0

    def test_exact_torch_special_cases_at_the_app_radius(self):
        """At L = 10 the exponents of r = 0, 5 and 10 are exactly -1, 0 and
        1, which torch evaluates as a reciprocal, a fill and a copy."""
        modes = {r2: pow_mode(e) for r2, _, e in ring_table(10)}
        assert (modes[0], modes[25], modes[100]) == (POW_RECIPROCAL, POW_ONE, POW_COPY)
        assert sum(m != POW_GENERAL for m in modes.values()) == 3
        modes4 = {r2: pow_mode(e) for r2, _, e in ring_table(4)}
        assert (modes4[1], modes4[9]) == (POW_RSQRT, POW_SQRT)

    def test_modes_agree_with_the_plain_pow(self):
        """Each special case gives exactly what ``torch.pow`` with the
        scalar exponent gives on the CPU, which takes the same cases."""
        c1 = torch.from_numpy(np.random.default_rng(0).uniform(1e-6, 300, 4096).astype(np.float32))
        for L in (3, 4, 10):
            for _, _, e in ring_table(L):
                mode = pow_mode(e)
                if mode == POW_GENERAL:
                    continue
                alt = {POW_ONE: torch.ones_like(c1), POW_COPY: c1, POW_SQRT: torch.sqrt(c1),
                       POW_RSQRT: torch.rsqrt(c1), POW_RECIPROCAL: 1.0 / c1}[mode]
                assert torch.equal(torch.pow(c1, e), alt), (L, e)


def test_occupancy_with_pallas_bump_matches_jax():
    """The port's occupancy map with ``pallas_bump=True`` (48 rows, so the
    strip route) against the JAX package's with ``use_pallas=True`` (its
    strip kernel in interpret mode), exactly."""
    rng = np.random.default_rng(7)
    h, w = 48, 64
    depth = rng.integers(200, 3500, (h, w)).astype(np.uint16)
    cls = np.zeros((h, w), np.uint8)
    cls[5:9, 6:10] = 1
    cls[30:33, 40:50] = 2
    cls[20:25, 20:24] = 3
    want = np.asarray(jax_occupancy(
        jnp.asarray(depth), jnp.asarray(cls), jcfg.CameraConfig(width=w, height=h),
        jcfg.GeometryConfig(pallas_bump=True), use_pallas=True,
    ))
    got = occupancy_map(torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(cls),
                        tcfg.CameraConfig(width=w, height=h), tcfg.GeometryConfig(pallas_bump=True))
    assert (want > 0).sum() > 1000 and not math.isnan(float(want.sum()))
    np.testing.assert_array_equal(got.numpy(), want)
