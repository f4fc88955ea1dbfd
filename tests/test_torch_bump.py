"""Kernels K3 and K4 (the terrain bump dilation): the port's wrappers on the
CPU, which run the plain ring loop, against the JAX package's Pallas kernels
in interpret mode and its XLA loop, exactly; the ring table both sides read;
the occupancy map's choice of entry (both run the kernel on the card); that
no module of the main path calls a plain version; the ring table as the
kernel reads it; and the kernel's rule (its memo of the bump, each ring's
value taken one ring late), emulated in NumPy.  The CUDA kernel itself is held
against the plain version on the card (``chip_smoke.py``, and the case
below that skips without CUDA)."""

from __future__ import annotations

import ast
import math
import pathlib
import struct

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
import tod_tpu_torch
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.geometry import fusion
from tod_tpu_torch.geometry.fusion import occupancy_map
from tod_tpu_torch.kernels.bump import (
    POW_COPY,
    POW_GENERAL,
    POW_ONE,
    POW_RECIPROCAL,
    POW_RSQRT,
    POW_SQRT,
    MEMO_VALUES,
    TILE_W,
    _bump_value,
    dilate_peaks,
    dilate_peaks_strips,
    plain_dilate_peaks,
    pow_mode,
    ring_table,
    table_words,
)

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


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


def scene_maps(seed: int, h: int, w: int):
    """Depth and class maps with terrain, both robot classes and a ball."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(200, 3500, (h, w)).astype(np.uint16)
    cls = np.zeros((h, w), np.uint8)
    cls[5:9, 6:10] = 1
    cls[30:33, 20:30] = 2
    cls[20:25, 20:24] = 3
    return depth, cls


@pytest.mark.parametrize("pallas_bump,h,entry", [
    (False, 48, "dilate_peaks"),
    (True, 48, "dilate_peaks_strips"),
    (True, 40, "dilate_peaks"),  # not whole 16-row strips
    (False, 40, "dilate_peaks"),
])
def test_occupancy_takes_a_kernel_entry_and_matches_jax(monkeypatch, pallas_bump, h, entry):
    """``occupancy_map`` calls K3's entry with ``pallas_bump`` on whole
    16-row strips and K4's otherwise (each launches the kernel on a CUDA
    tensor), once a frame; the map equals the JAX package's with
    ``use_pallas`` on and off, exactly."""
    calls = []
    for name in ("dilate_peaks", "dilate_peaks_strips"):
        real = getattr(fusion, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(fusion, name, spy)
    w = 48
    depth, cls = scene_maps(7, h, w)
    got = occupancy_map(torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(cls),
                        tcfg.CameraConfig(width=w, height=h),
                        tcfg.GeometryConfig(pallas_bump=pallas_bump)).numpy()
    assert calls == [entry]
    assert (got > 0).sum() > 500
    for use_pallas in (False, True):
        want = np.asarray(jax_occupancy(
            jnp.asarray(depth), jnp.asarray(cls), jcfg.CameraConfig(width=w, height=h),
            jcfg.GeometryConfig(pallas_bump=pallas_bump), use_pallas=use_pallas,
        ))
        np.testing.assert_array_equal(got, want)


def test_no_plain_version_on_the_main_path():
    """Only the kernels' modules (``kernels/*.py``) and ``ops/quantize.py``,
    which hold the plain versions beside their wrappers, name a ``plain_*``
    function; every other module of the port reaches a kernel's work
    through its wrapper."""
    root = pathlib.Path(tod_tpu_torch.__file__).parent
    allowed = set((root / "kernels").glob("*.py")) | {root / "ops" / "quantize.py"}
    found = []
    for path in sorted(root.rglob("*.py")):
        if path in allowed:
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Name):
                name = node.id
            elif isinstance(node, ast.Attribute):
                name = node.attr
            elif isinstance(node, ast.alias):
                name = node.name.rsplit(".", 1)[-1]
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                name = node.name
            else:
                continue
            if name.startswith("plain_"):
                found.append(f"{path.relative_to(root)}:{node.lineno} {name}")
    assert len(allowed) > 5 and not found, found


def emulate_kernel(ext: np.ndarray, L: int, err: float, out_shape):
    """csrc/bump.cu's rule in NumPy: rings in ascending r^2, each ring's
    NaN-propagating maximum; where it is positive, its bump from the memo
    table (``floor(g(v, r))`` for the integral v below ``MEMO_VALUES``,
    filled with the plain arithmetic) or computed; each ring's value taken
    into the accumulator one ring late with a NaN-propagating max.  Returns
    (the (h, w) map, evaluations read from the memo, evaluations computed)."""
    h, w = out_shape
    pad = (ext.shape[0] - h) // 2
    values = torch.arange(MEMO_VALUES, dtype=torch.float32)
    acc = np.zeros((h, w), np.float32)
    pending = np.full((h, w), -np.inf, np.float32)
    from_memo = computed = 0
    for _, disps, exponent in ring_table(L):
        memo = torch.floor(_bump_value(values, exponent, err)).numpy()
        memo[0] = 0.0
        m = np.full((h, w), -np.inf, np.float32)
        for dy, dx in disps:
            src = ext[pad - dy : pad - dy + h, pad - dx : pad - dx + w]
            m = np.where(np.isnan(m) | np.isnan(src), np.nan, np.maximum(m, src))
        with np.errstate(invalid="ignore"):
            positive = m > 0
            held = positive & (m < MEMO_VALUES) & (m == np.floor(m))
        index = np.where(held, m, 0).astype(np.int64)
        value = torch.floor(_bump_value(torch.from_numpy(np.where(positive, m, 1.0)
                                                         .astype(np.float32)), exponent,
                                        err)).numpy()
        value = np.where(held, memo[index], np.where(positive, value, -np.inf))
        acc = np.where(np.isnan(acc) | np.isnan(pending), np.nan, np.maximum(acc, pending))
        pending = value.astype(np.float32)
        from_memo += int(held.sum())
        computed += int((positive & ~held).sum())
    out = np.where(np.isnan(acc) | np.isnan(pending), np.nan, np.maximum(acc, pending))
    return out.astype(np.float32), from_memo, computed


def special_peaks(seed: int, h: int, w: int, L: int, kind: str) -> np.ndarray:
    """Dense peaks, integral (below and above the memo's range) or float, or
    integral ones with +inf and NaN among them, on a P = L padded map."""
    rng = np.random.default_rng(seed)
    ext = np.zeros((h + 2 * L, w + 2 * L), np.float32)
    m = rng.random(ext.shape) < 0.4
    ext[m] = rng.uniform(20, 39, m.sum()) if kind == "float" else rng.integers(20, 1400, m.sum())
    if kind == "inf and NaN":
        ext[rng.random(ext.shape) < 0.004] = np.inf
        ext[rng.random(ext.shape) < 0.004] = np.nan
    return ext


@pytest.mark.parametrize("L", [4, 10])
@pytest.mark.parametrize("kind", ["integral", "float", "inf and NaN"])
def test_kernel_emulation_equals_the_plain_ring_loop(L, kind):
    """The kernel's memo and its one-ring-late accumulation change no value,
    NaN included: the emulation equals ``plain_dilate_peaks``, with
    evaluations from the memo on integral peaks and computed on the others."""
    h, w = 45, 70
    ext = special_peaks(L, h, w, L, kind)
    want = plain_dilate_peaks(torch.from_numpy(ext), L, 0.1, (h, w)).numpy()
    got, from_memo, computed = emulate_kernel(ext, L, 0.1, (h, w))
    np.testing.assert_array_equal(got, want)
    assert computed > 0 and (from_memo > 0) == (kind != "float")
    if kind == "inf and NaN":
        assert np.isnan(want).any() and (np.isinf(ext).any() and np.isnan(ext).any())


def test_kernel_emulation_on_the_terrain():
    """A synthetic frame's terrain peaks at the app's radius: exact, and
    every evaluation read from the memo (the peaks are image row indices)."""
    from chip_smoke import color_class_map, terrain_peaks
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    f = synth_frame_numpy(0, 0, 96, 128)
    cam, geom = tcfg.CameraConfig(width=128, height=96), tcfg.GeometryConfig()
    ext = terrain_peaks(torch, np, torch.from_numpy(f.depth.astype(np.int32)),
                        torch.from_numpy(color_class_map(np, f.rgb)), cam, geom).numpy()
    L = geom.terrain_norm_const
    want = plain_dilate_peaks(torch.from_numpy(ext), L, geom.bump_err, (96, 128)).numpy()
    got, from_memo, computed = emulate_kernel(ext, L, geom.bump_err, (96, 128))
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 1000 and from_memo > 1000 and computed == 0


@pytest.mark.parametrize("L", [1, 4, 10])
def test_table_words_lay_out_the_ring_table(L):
    """``table_words`` holds the ring table as csrc/bump.cu's ``Table``
    reads it: each displacement's word offset in a tile of row stride
    ``32 + 2L - 1``, the ring starts, the pow modes and the float32
    exponents' bits."""
    rings = ring_table(L)
    words = table_words(L)
    n_disp, n_rings, stride = 4 * L * L, len(rings), TILE_W + 2 * L - 1
    assert words.dtype == np.int32 and words.size == n_disp + 3 * n_rings + 1
    off, start = words[:n_disp], words[n_disp : n_disp + n_rings + 1]
    mode, exp = words[n_disp + n_rings + 1 : n_disp + 2 * n_rings + 1], words[-n_rings:]
    assert start[0] == 0 and start[-1] == n_disp
    for r, (r2, disps, e) in enumerate(rings):
        got = [(int(-o + L * stride + L) // stride - L, int(-o + L * stride + L) % stride - L)
               for o in off[start[r] : start[r + 1]]]
        assert got == list(disps) and all(dy * dy + dx * dx == r2 for dy, dx in got)
        assert mode[r] == pow_mode(e)
        assert struct.unpack("<f", struct.pack("<i", int(exp[r])))[0] == np.float32(e)
