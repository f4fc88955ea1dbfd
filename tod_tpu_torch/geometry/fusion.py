"""Depth + class/id maps -> birdseye occupancy scene (counterpart of
the JAX package's ``geometry/fusion.py``).

Per frame: perspective depth correction and birdseye projection, peak
scatter-max per birdseye cell, the terrain bump dilation (kernel K3 in
16-row strips with ``GeometryConfig.pallas_bump``, kernel K4 over the whole
map otherwise: on the card both launch the one kernel of ``csrc/bump.cu``)
and the robot bump dilation, ball centroids by instance id, and the
8-neighbour connection weights (kernel K2).  ``fuse_scene_batch`` fuses a
batch of frames, one ``fuse_scene`` each.
Every step mirrors the float32 operations of the JAX reference in the same
order; the transcendental functions (tan, atan, cos, pow) come from torch's
libraries and may differ from XLA's by an ulp.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tod_tpu_torch.core.config import CameraConfig, GeometryConfig
from tod_tpu_torch.core.types import Scene
from tod_tpu_torch.kernels.bump import dilate_peaks, dilate_peaks_strips
from tod_tpu_torch.kernels.connections import connection_weights
from tod_tpu_torch.ops.ieee import div, rdiv, sqrt

_F32 = torch.float32


@functools.lru_cache(maxsize=8)
def depth_correction_factors(cam: CameraConfig, shape: tuple[int, int], device) -> torch.Tensor:
    """Per-pixel ``cos(atan(tan(fov/2) * 2c/dim))`` for both axes (pixel
    index scaled by 2/dim, not centred, as the reference shader does).

    Constants of the camera: computed once with the host's tan, atan and
    cos and cached per device, so that every device projects with the same
    bits (the card's transcendentals differ from the host's by an ulp)."""
    h, w = shape
    y = torch.arange(h, dtype=_F32)
    x = torch.arange(w, dtype=_F32)
    ty = torch.tan(torch.full((), cam.y_fov / 2.0, dtype=_F32))
    tx = torch.tan(torch.full((), cam.x_fov / 2.0, dtype=_F32))
    fy = torch.cos(torch.arctan(div(ty * y * 2.0, float(h))))
    fx = torch.cos(torch.arctan(div(tx * x * 2.0, float(w))))
    return (fy[:, None] * fx[None, :]).to(device)


def birdseye_project(depth_mm: torch.Tensor, cam: CameraConfig):
    """Depth (H, W) mm -> (bird_y, bird_x, z) int32; rows may fall off the grid."""
    h, w = depth_mm.shape
    corr = depth_correction_factors(cam, (h, w), depth_mm.device)
    depth_c = depth_mm.to(_F32) * corr
    z = torch.floor(div(h * depth_c, cam.max_depth_mm)).to(torch.int32)
    bird_y = h - z
    bird_x = torch.arange(w, dtype=torch.int32, device=depth_mm.device)[None, :].expand(h, w)
    return bird_y, bird_x, z


def _dilate_const_separable(peaks_ext: torch.Tensor, bump_size: int, val: float,
                            bump_err: float, out_shape):
    """Exact dilation for a constant peak value (robots): the windowed
    min-distance^2 to a source, separable into a column pass and a row pass,
    then one bump evaluation."""
    h, w = out_shape
    pad = (peaks_ext.shape[0] - h) // 2
    L = bump_size
    far = 1e9
    rows = peaks_ext.shape[0]
    dev = peaks_ext.device
    acc = torch.full((rows, w), far, dtype=_F32, device=dev)
    for dx in range(-L, L):
        src = peaks_ext[:, pad - dx : pad - dx + w]
        acc = torch.minimum(acc, torch.where(src > 0, float(dx * dx), far))
    d2 = torch.full((h, w), far, dtype=_F32, device=dev)
    for dy in range(-L, L):
        d2 = torch.minimum(d2, acc[pad - dy : pad - dy + h] + float(dy * dy))
    c1 = torch.full((), val / bump_err - 1.0, dtype=_F32, device=dev)
    c2 = 2.0 / L
    r = sqrt(torch.clamp_max(d2, far))
    # compiled JAX fuses c2 * r - 1 into one multiply-add: form it in float64
    # (the product of two float32 values is exact) and round once
    c2_f32 = float(torch.tensor(c2, dtype=_F32))
    exponent = (r.double() * c2_f32 - 1.0).float()
    g = torch.floor(rdiv(val, 1.0 + torch.pow(c1, exponent)))
    return torch.where(d2 < far * 0.5, g.clamp_min(0.0), 0.0)


def _scatter_peaks(bird_y: torch.Tensor, src_mask: torch.Tensor, values: torch.Tensor,
                   pad: int) -> torch.Tensor:
    """Max of each source's peak value into its birdseye cell on the P-padded
    grid.  ``bird_x`` is always the source column, so this is a max by target
    row per column: ``scatter_reduce("amax")`` over a zero map, with rows
    that fall off the grid sent to a spare row and dropped."""
    h, w = src_mask.shape
    ext_h = h + 2 * pad
    vals = torch.where(src_mask, values, 0.0)
    row = bird_y + pad
    idx = torch.where((row >= 0) & (row < ext_h), row, ext_h).to(torch.int64)
    col = torch.zeros((ext_h + 1, w), dtype=_F32, device=vals.device)
    col.scatter_reduce_(0, idx, vals, reduce="amax", include_self=True)
    return F.pad(col[:ext_h], (pad, pad))


def _border_interior(h: int, w: int, device) -> torch.Tensor:
    """The shader never writes the border ring."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys > 0) & (ys < h - 1) & (xs > 0) & (xs < w - 1)


def _robot_peaks(bird_y, cls_map, geom: GeometryConfig):
    h, w = cls_map.shape
    const = torch.full((h, w), geom.bot_avoidance_const, dtype=_F32, device=cls_map.device)
    return _scatter_peaks(bird_y, (cls_map == 1) | (cls_map == 2), const, geom.bot_norm_const)


def robot_occupancy(depth_mm, cls_map, cam: CameraConfig, geom: GeometryConfig):
    """The robot component of :func:`occupancy_map` alone, border-masked."""
    h, w = depth_mm.shape
    bird_y, _, _ = birdseye_project(depth_mm, cam)
    robots = _dilate_const_separable(
        _robot_peaks(bird_y, cls_map, geom), geom.bot_norm_const,
        geom.bot_avoidance_const, geom.bump_err, (h, w),
    )
    return torch.where(_border_interior(h, w, depth_mm.device), robots, 0.0)


def _layers(depth_mm, cls_map, cam: CameraConfig, geom: GeometryConfig):
    """(terrain, robots, interior): the two bump layers of the occupancy map
    before the border mask, and the mask."""
    h, w = depth_mm.shape
    dev = depth_mm.device
    bird_y, _, _ = birdseye_project(depth_mm, cam)
    rows = torch.arange(h, dtype=_F32, device=dev)[:, None].expand(h, w)
    pad_t = geom.terrain_norm_const
    terrain_peaks = _scatter_peaks(bird_y, cls_map == 0, rows, pad_t)
    # the JAX package's selection rule: the strip kernel (K3) with
    # ``pallas_bump`` on whole 16-row strips, the whole-map entry (K4, where
    # the JAX package runs its fused loop) otherwise.  Both are exact: on the
    # card both launch the same kernel, on a CPU tensor both run the plain
    # ring loop.
    if geom.pallas_bump and h % 16 == 0:
        terrain = dilate_peaks_strips(terrain_peaks, pad_t, geom.bump_err, (h, w), strip_h=16)
    else:
        terrain = dilate_peaks(terrain_peaks, pad_t, geom.bump_err, (h, w))
    robots = _dilate_const_separable(
        _robot_peaks(bird_y, cls_map, geom), geom.bot_norm_const,
        geom.bot_avoidance_const, geom.bump_err, (h, w),
    )
    return terrain, robots, _border_interior(h, w, dev)


def occupancy_map(depth_mm, cls_map, cam: CameraConfig, geom: GeometryConfig):
    """(H, W) f32 height map: terrain pixels (class 0) bump their own image
    row with radius ``terrain_norm_const``; robots (classes 1, 2) bump
    ``bot_avoidance_const`` with radius ``bot_norm_const``; balls write none."""
    terrain, robots, interior = _layers(depth_mm, cls_map, cam, geom)
    return torch.where(interior, torch.maximum(terrain, robots), 0.0)


def occupancy_layers(depth_mm, cls_map, cam: CameraConfig, geom: GeometryConfig):
    """``(occupancy_map, robot_occupancy)`` of one frame, with the projection
    and the robot dilation done once (the obstacle memory's step needs
    both; compiled JAX shares them by common subexpressions)."""
    terrain, robots, interior = _layers(depth_mm, cls_map, cam, geom)
    return (torch.where(interior, torch.maximum(terrain, robots), 0.0),
            torch.where(interior, robots, 0.0))


def ball_centroids(depth_mm, cls_map, id_map, cam: CameraConfig, geom: GeometryConfig):
    """Per-instance ball centroids in birdseye coords -> (max_balls, 4) f32
    ``(x, y, count, 0)``: the mean over each id's ball pixels."""
    bird_y, bird_x, _ = birdseye_project(depth_mm, cam)
    nb = geom.max_balls
    is_ball = (cls_map == 3) & (id_map >= 0) & (id_map < nb)
    seg = torch.where(is_ball, id_map, nb).reshape(-1).to(torch.int64)
    ones = is_ball.reshape(-1).to(_F32)
    vals = torch.stack(
        [bird_x.reshape(-1).to(_F32) * ones, bird_y.reshape(-1).to(_F32) * ones, ones], dim=-1
    )
    sums = torch.zeros((nb + 1, 3), dtype=_F32, device=vals.device)
    sums.index_add_(0, seg, vals)
    sum_x, sum_y, cnt = sums[:nb, 0], sums[:nb, 1], sums[:nb, 2]
    denom = cnt.clamp_min(1.0)
    mean_x = torch.where(cnt > 0, sum_x / denom, 0.0)
    mean_y = torch.where(cnt > 0, sum_y / denom, 0.0)
    return torch.stack([mean_x, mean_y, cnt, torch.zeros_like(cnt)], dim=-1)


def fuse_scene(depth_mm, cls_map, id_map, cam: CameraConfig, geom: GeometryConfig) -> Scene:
    """(depth mm, class uint8, id int32) maps -> :class:`Scene`."""
    height = occupancy_map(depth_mm, cls_map, cam, geom)
    balls = ball_centroids(depth_mm, cls_map, id_map, cam, geom)
    pos, conns = connection_weights(height)
    return Scene(height=height, pos=pos, balls=balls, connections=conns)


def fuse_scene_batch(depth_mm, cls_map, id_map, cam: CameraConfig, geom: GeometryConfig) -> Scene:
    """(B, H, W) depth, class and id maps -> :class:`Scene` of (B, ...) fields.

    The JAX package vmaps ``fuse_scene``'s plain forms; here each frame goes
    through :func:`fuse_scene` in turn, so that on the card every map runs
    the kernels (K4, K2), which take one map a launch, and the result equals
    ``fuse_scene`` frame by frame bit for bit."""
    scenes = [fuse_scene(d, c, i, cam, geom) for d, c, i in zip(depth_mm, cls_map, id_map)]
    return Scene(**{f: torch.stack([getattr(s, f) for s in scenes])
                    for f in ("height", "pos", "balls", "connections")})
