"""The work plans of the connected-components kernel (``csrc/cc_labels.cu``)
and the tracker kernel (``csrc/track.cu``), rehearsed in plain Python on
the CPU.

The cc plan: tiles of ``kernels.cc_labels.TILE`` pixels a side; inside each
tile the runs of a row stand for their pixels, the runs of two rows are
united once a stretch where they touch, and each pixel takes the global
index of its run's local root; then the edges across a tile's top row and
left column are united once a stretch, only where both tiles have a masked
pixel; then every pixel takes its root.  It is held bit for bit against
``plain_root_labels``, against the JAX package's ``connected_components``
(through ``compact_labels``) and against ``scipy.ndimage.label`` on the
masks ``chip_smoke.py`` holds the kernel to, and the border pass is counted
to unite only edges between two tiles.

The tracker plan: one warp a bank, lane l owning the columns l + 32c; with
K <= 8 and M <= 128 each lane keeps a key a column and retakes only the
keys that lay in the winner's row, otherwise one key a lane and a full
rescan; each round two minima across the lanes (the cost bits, then the
flat index among the lanes at that cost); births ranked a chunk of 32
columns at a time.  It is held bit for bit against the plain
``track_update`` and ``tracks_to_balls`` and against JAX's jitted
``track_update``, on banks whose costs tie and on random banks.  The
kernels themselves run only on a card (``chip_smoke.py`` phase 3).
"""

from __future__ import annotations

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

import chip_smoke as cs
from tests.test_torch_track import step_balls
from tod_tpu.core import config as jcfg
from tod_tpu.ops.cc_labels import connected_components as jax_connected_components
from tod_tpu.track import track_update as jax_track_update
from tod_tpu.track import tracks_to_balls as jax_tracks_to_balls
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.kernels import cc_labels as cc_kernel
from tod_tpu_torch.kernels import track as track_kernel
from tod_tpu_torch.kernels.cc_labels import SENTINEL, TILE, plain_root_labels
from tod_tpu_torch.ops.cc_labels import compact_labels
from tod_tpu_torch.track import track_update, tracks_to_balls

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

CSRC = pathlib.Path(cc_kernel.__file__).resolve().parents[1] / "csrc"


# ---------------------------------------------------------------- cc plan


def run_starts(r: int) -> int:
    """The first columns of the runs of a row's bits."""
    return r & ~(r << 1) & 0xFFFFFFFF


def run_start(r: int, x: int) -> int:
    """The first column of the run of row bits ``r`` that holds column x."""
    gaps = ~r & ((1 << x) - 1)
    return gaps.bit_length()


def find(parent, x):
    while parent[x] != x:
        x = parent[x]
    return x


def unite(parent, a, b) -> None:
    """Union by minimum: the larger root hangs under the smaller."""
    a, b = find(parent, a), find(parent, b)
    if a != b:
        parent[max(a, b)] = min(a, b)


def local_pass(mask: np.ndarray, ty: int, tx: int, labels: np.ndarray) -> bool:
    """csrc/cc_labels.cu pass 1 for tile (ty, tx): writes each pixel's
    global local-root index (SENTINEL off the mask) -> the tile has a
    masked pixel."""
    h, w = mask.shape
    y0, x0 = ty * TILE, tx * TILE
    rows = []
    for ry in range(TILE):
        y = y0 + ry
        bits = 0
        if y < h:
            for cx in range(min(TILE, w - x0)):
                bits |= int(mask[y, x0 + cx]) << cx
        rows.append(bits)
    if not any(rows):
        labels[y0:y0 + TILE, x0:x0 + TILE] = SENTINEL
        return False
    parent = {}
    for ry, r in enumerate(rows):
        for cx in range(TILE):
            if (run_starts(r) >> cx) & 1:
                parent[ry * TILE + cx] = ry * TILE + cx
    for ry in range(1, TILE):
        touch = rows[ry] & rows[ry - 1]
        for cx in range(TILE):
            if (run_starts(touch) >> cx) & 1:  # a stretch's first column
                unite(parent, ry * TILE + run_start(rows[ry], cx),
                      (ry - 1) * TILE + run_start(rows[ry - 1], cx))
    for ry, r in enumerate(rows):
        for cx in range(TILE):
            y, x = y0 + ry, x0 + cx
            if y >= h or x >= w:
                continue
            if (r >> cx) & 1:
                root = find(parent, ry * TILE + run_start(r, cx))
                labels[y, x] = (y0 + root // TILE) * w + x0 + root % TILE
            else:
                labels[y, x] = SENTINEL
    return True


def cc_plan(mask: np.ndarray):
    """The kernel's three passes -> (root labels, local labels, the border
    pass's edges as (p, q) linear indices)."""
    h, w = mask.shape
    tiles_y, tiles_x = -(-h // TILE), -(-w // TILE)
    labels = np.empty((h, w), np.int64)
    nonempty = np.zeros((tiles_y, tiles_x), bool)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            nonempty[ty, tx] = local_pass(mask, ty, tx, labels)
    local = labels.copy()
    parent = labels.reshape(-1)  # the labels are the forest's parents
    edges = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            if not nonempty[ty, tx]:
                continue
            y0, x0 = ty * TILE, tx * TILE
            sides = []
            if ty > 0 and nonempty[ty - 1, tx]:  # the top row's edges
                xs = range(x0, min(x0 + TILE, w))
                sides.append([(y0 * w + x, (y0 - 1) * w + x) for x in xs])
            if tx > 0 and nonempty[ty, tx - 1]:  # the left column's edges
                ys = range(y0, min(y0 + TILE, h))
                sides.append([(y * w + x0, y * w + x0 - 1) for y in ys])
            for side in sides:
                both = [bool(mask.flat[p] and mask.flat[q]) for p, q in side]
                for i, (p, q) in enumerate(side):
                    if both[i] and (i == 0 or not both[i - 1]):  # a stretch's first edge
                        edges.append((p, q))
                        unite(parent, p, q)
    for i in np.flatnonzero(mask.reshape(-1)):
        parent[i] = find(parent, i)
    return parent.reshape(h, w), local, edges


def scipy_minima(mask: np.ndarray) -> np.ndarray:
    """Each masked pixel's component minimum (scipy's 4-connected labels),
    SENTINEL off the mask."""
    lab, n = scipy.ndimage.label(mask)
    lin = np.arange(mask.size).reshape(mask.shape)
    minima = np.full(n + 1, SENTINEL, np.int64)
    np.minimum.at(minima, lab[mask], lin[mask])
    return np.where(mask, minima[lab], SENTINEL)


def plan_masks(h: int, w: int) -> dict[str, np.ndarray]:
    gen = np.random.default_rng(h * 1000 + w)
    return {**cs.cc_masks(np, gen, h, w), **cs.tile_masks(np, gen, h, w)}


SIZES = [(1, 1), (1, 64), (64, 1), (37, 53), (97, 131)]
KINDS = list(plan_masks(8, 8))


def test_tile_is_the_kernels():
    """The wrapper's TILE is the constant csrc/cc_labels.cu tiles by."""
    src = (CSRC / "cc_labels.cu").read_text()
    assert re.search(rf"constexpr int kTile = {TILE};", src)
    assert TILE == 32  # a tile row is one warp's 32-bit ballot


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_cc_plan_matches_plain_jax_and_scipy(kind, size):
    h, w = size
    mask = plan_masks(h, w)[kind]
    got, local, edges = cc_plan(mask)
    want = plain_root_labels(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, scipy_minima(mask))
    for cap in (100, h * w):
        ids = compact_labels(torch.from_numpy(got.astype(np.int32)), cap).numpy()
        jax_ids = np.asarray(jax_connected_components(jnp.asarray(mask), max_labels=cap))
        np.testing.assert_array_equal(ids, jax_ids)
        np.testing.assert_array_equal(ids, cs.scipy_ids(np, mask, cap)[0])
    # pass 1 alone: each pixel holds its part's smallest index inside its tile
    for ty in range(-(-h // TILE)):
        for tx in range(-(-w // TILE)):
            sl = np.s_[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE]
            part = scipy_minima(mask[sl])
            lin = np.where(mask[sl], part, 0)
            gy, gx = lin // mask[sl].shape[1] + ty * TILE, lin % mask[sl].shape[1] + tx * TILE
            np.testing.assert_array_equal(local[sl], np.where(mask[sl], gy * w + gx, SENTINEL))
    # pass 2 unites only edges between two tiles, both ends masked
    for p, q in edges:
        (py, px), (qy, qx) = divmod(p, w), divmod(q, w)
        assert abs(py - qy) + abs(px - qx) == 1 and mask[py, px] and mask[qy, qx]
        assert (py // TILE, px // TILE) != (qy // TILE, qx // TILE)
    if kind == "tile bridges" and h > TILE and w > TILE:
        assert edges  # the bridges cross tile borders


def test_cc_plan_border_work_at_the_main_path():
    """The synthetic frame's balls at 640x480: the border pass has a few
    stretches to unite, nowhere near the per-pixel unions of one launch a
    pixel."""
    from tod_tpu_torch.core.config import CameraConfig
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    cam = CameraConfig()
    f = synth_frame_numpy(0, 3, cam.height, cam.width)
    mask = cs.color_class_map(np, f.rgb) == 3
    got, _, edges = cc_plan(mask)
    np.testing.assert_array_equal(got, scipy_minima(mask))
    n_edges = int((mask[1:] & mask[:-1]).sum() + (mask[:, 1:] & mask[:, :-1]).sum())
    assert 0 < len(edges) < n_edges // 50


# ----------------------------------------------------------- tracker plan

F32 = np.float32
INF = F32(3.4e38)
NONE = 0xFFFFFFFF
REG_ROWS = 8  # csrc/track.cu kRegRows


def fma(a, b, c):
    """a * b + c rounded once to f32, as the plain version forms it."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def bits(v) -> int:
    return int(np.asarray(v, F32).view(np.uint32))


def lane_plan(tracks: np.ndarray, balls: np.ndarray, cfg, max_balls: int,
              register: bool | None = None):
    """csrc/track.cu's warp on one bank, lane by lane -> (new bank, seeds,
    the number of column keys retaken).  ``register``: the build with a key
    a column (the kernel takes it for K <= 8 and M <= 128); else one key a
    lane and full rescans."""
    k, m = tracks.shape[0], balls.shape[0]
    if register is None:
        register = k <= REG_ROWS and -(-m // 32) <= 4
    q = cfg.accel_var
    c_pos, c_pv, c_vel = F32(q * 0.25), F32(q * 0.5), F32(q)
    gate2, meas_var, min_pixels = F32(cfg.gate**2), F32(cfg.meas_var), F32(cfg.min_pixels)
    t = tracks.astype(F32).copy()
    for r in t:  # predict
        pos, pv, vel = r[4], r[5], r[6]
        r[0], r[1] = F32(r[0] + r[2]), F32(r[1] + r[3])
        r[4] = F32(F32(F32(pos + F32(F32(2) * pv)) + vel) + c_pos)
        r[5] = F32(F32(pv + vel) + c_pv)
        r[6] = F32(vel + c_vel)
    valid = [bool(balls[j, 2] > min_pixels) for j in range(m)]
    cost = np.empty((k, m), F32)
    for i in range(k):
        for j in range(m):
            dx, dy = F32(t[i, 0] - balls[j, 0]), F32(t[i, 1] - balls[j, 1])
            d2 = fma(dy, dy, F32(dx * dx))
            cost[i, j] = d2 if t[i, 9] > 0 and valid[j] and d2 <= gate2 else INF
    cols = {lane: list(range(lane, m, 32)) for lane in range(32)}
    assign = [-1] * k
    free = list(valid)
    retaken = 0
    rows_left = set(range(k))

    def col_key(j):  # a column's smallest key over the rows left, first row on ties
        best, row = NONE, 0
        for i in sorted(rows_left):
            if bits(cost[i, j]) < best:
                best, row = bits(cost[i, j]), i
        return best, row

    def lane_key(lane):
        best = (NONE, NONE)
        for i in range(k):
            for j in cols[lane]:
                best = min(best, (bits(cost[i, j]), i << 16 | j))
        return best

    if register:
        key = {j: col_key(j) for j in range(m)}
    else:
        lane_best = {lane: lane_key(lane) for lane in range(32)}
    for _ in range(k):
        if register:
            lane_best = {lane: min(((key[j][0], key[j][1] << 16 | j) for j in cols[lane]),
                                   default=(NONE, NONE)) for lane in range(32)}
        won_bits = min(b for b, _ in lane_best.values())  # the first warp minimum
        if not np.uint32(won_bits).view(F32) < INF:
            break
        won = min(f for b, f in lane_best.values() if b == won_bits)  # the second
        ti, mi = won >> 16, won & 0xFFFF
        assign[ti] = mi
        free[mi] = False
        rows_left.discard(ti)
        if register:
            key[mi] = (NONE, 0)
            for j in range(m):
                if j != mi and key[j][0] != NONE and key[j][1] == ti:
                    key[j] = col_key(j)
                    retaken += 1
        else:
            cost[ti, :] = INF
            cost[:, mi] = INF
            for lane, (b, f) in lane_best.items():
                if f != NONE and (f >> 16 == ti or f & 0xFFFF == mi):
                    lane_best[lane] = lane_key(lane)
                    retaken += len(cols[lane])
    slot_free = []
    for i, r in enumerate(t):  # Kalman update and lifecycle
        a = assign[i]
        matched = a >= 0
        zx, zy = balls[max(a, 0), 0], balls[max(a, 0), 1]
        pos, pv, vel = r[4], r[5], r[6]
        s = F32(pos + meas_var)
        k1, k2 = F32(pos / s), F32(pv / s)
        rx, ry = F32(zx - r[0]), F32(zy - r[1])
        r[0] = F32(r[0] + (F32(k1 * rx) if matched else F32(0)))
        r[1] = F32(r[1] + (F32(k1 * ry) if matched else F32(0)))
        r[2] = F32(r[2] + (F32(k2 * rx) if matched else F32(0)))
        r[3] = F32(r[3] + (F32(k2 * ry) if matched else F32(0)))
        if matched:
            keep = F32(F32(1) - k1)
            r[4], r[5], r[6] = F32(keep * pos), F32(keep * pv), fma(-k2, pv, vel)
        active = r[9] > 0
        hits = F32(r[7] + 1) if matched else r[7]
        misses = F32(0) if matched else (F32(r[8] + 1) if active else F32(0))
        alive = bool(active and misses <= F32(cfg.max_misses))
        r[7], r[8], r[9] = (hits, misses, F32(1)) if alive else (F32(0), F32(0), F32(0))
        slot_free.append(not alive)
    # births: one ballot a chunk of 32 columns, stopping once the chunks hold
    # as many free measurements as there are free slots
    n_slots = sum(slot_free)
    ranks = {i: sum(slot_free[:i]) for i in range(k) if slot_free[i]}
    before = 0
    for c in range(-(-m // 32)):
        if before >= n_slots:
            break
        ballot = [j for j in range(32 * c, min(32 * c + 32, m)) if free[j]]
        for i, rank in ranks.items():
            if before <= rank < before + len(ballot):
                j = ballot[rank - before]
                t[i] = [balls[j, 0], balls[j, 1], 0, 0, meas_var, 0, F32(cfg.vel0_var), 1, 0, 1]
        before += len(ballot)
    seeds = np.zeros((max_balls, 4), F32)
    for i, r in enumerate(t):
        seeds[i, :2] = r[:2]
        if r[9] > 0 and r[7] >= F32(cfg.min_hits):
            seeds[i, 2] = F32(F32(100) + r[7])
    return t, seeds, retaken


JCFG, TCFG = jcfg.TrackerConfig(enabled=True), tcfg.TrackerConfig(enabled=True)
jitted_update = jax.jit(jax_track_update, static_argnums=2)


def hold_plan(bank: np.ndarray, balls: np.ndarray, register: bool | None = None) -> int:
    """The lane plan on one bank against the plain port and jitted JAX, bit
    for bit -> the column keys retaken."""
    got, seeds, retaken = lane_plan(bank, balls, TCFG, 100, register)
    want = track_update(torch.from_numpy(bank), torch.from_numpy(balls), TCFG)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(seeds, tracks_to_balls(want, TCFG, 100).numpy())
    jax_bank = np.asarray(jitted_update(jnp.asarray(bank), jnp.asarray(balls), JCFG))
    np.testing.assert_array_equal(got, jax_bank)
    np.testing.assert_array_equal(seeds, np.asarray(jax_tracks_to_balls(jax_bank, JCFG, 100)))
    return retaken


@pytest.mark.parametrize("register", [True, False], ids=["key a column", "key a lane"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_track_plan_on_tie_banks(seed, register):
    """Integer cells: a ball as far from two tracks as a track from two
    balls, and equal costs in different rows and columns, so the flat-index
    tie-break decides rounds."""
    gen = np.random.default_rng(seed)
    banks, balls = cs.tie_banks(np, gen, 4)
    assert cs.tied_costs(np, banks, balls, TCFG) > 0
    for bank, ball in zip(banks, balls):
        hold_plan(bank, ball, register)


def test_track_plan_tie_break_by_hand():
    """Round 1: tracks 1 and 2 as far from ball 3, and track 5 as far from
    ball 80, all at cost 4: the smallest flat index, track 1 and ball 3.
    Round 2: track 2's cost to ball 3 went with its column; track 5 and
    ball 80 at 4.  Round 3: track 2 and ball 35 at 13, not 9 + 4 from two
    balls.  Balls 40 and 70, as far from track 5 (cost 9) as each other,
    are then born in slot order, ball 40 first."""
    bank = np.zeros((8, 10), np.float32)
    bank[1] = [10, 10, 0, 0, 1, 0, 1, 3, 0, 1]
    bank[2] = [14, 10, 0, 0, 1, 0, 1, 3, 0, 1]
    bank[5] = [40, 40, 0, 0, 1, 0, 1, 3, 0, 1]
    balls = np.zeros((100, 4), np.float32)
    balls[3] = [12, 10, 9, 0]
    balls[35] = [12, 13, 9, 0]
    balls[40] = [43, 40, 9, 0]
    balls[70] = [37, 40, 9, 0]
    balls[80] = [40, 42, 9, 0]
    hold_plan(bank, balls)
    new = track_update(torch.from_numpy(bank), torch.from_numpy(balls), TCFG).numpy()
    assert new[1, 7] == 4 and new[1, 0] > 10  # track 1 took ball 3 (x = 12)
    assert new[2, 7] == 4 and new[2, 1] > 10  # track 2 took ball 35 (y = 13)
    assert new[5, 7] == 4 and new[5, 1] > 40 and new[5, 0] == 40  # track 5 took ball 80
    assert new[0, 0] == 43 and new[3, 0] == 37  # births: ball 40 in slot 0, ball 70 in 3


@pytest.mark.parametrize("register", [True, False], ids=["key a column", "key a lane"])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_track_plan_on_random_banks(n, register):
    """``chip_smoke.py``'s random banks (contended gates, a third of the
    tracks inactive, counts on both sides of min_pixels)."""
    gen = np.random.default_rng(n)
    banks, balls = cs.random_banks(np, gen, n)
    retaken = [hold_plan(bank, ball, register) for bank, ball in zip(banks, balls)]
    if register:  # a round retakes a few column keys, not every lane's columns
        assert sum(retaken) < n * 8 * 100


@pytest.mark.parametrize("clustered", [False, True])
def test_track_plan_over_random_steps(clustered):
    """The random steps of ``tests/test_torch_track.py``: 30 steps of a
    bank, births and deaths included, each from the plain step's bank."""
    rng = np.random.default_rng(10 + int(clustered))
    bank = np.zeros((8, 10), np.float32)
    changes = 0
    for _ in range(30):
        balls = step_balls(rng, 100, clustered)
        hold_plan(bank, balls)
        new = track_update(torch.from_numpy(bank), torch.from_numpy(balls), TCFG).numpy()
        changes += int((new[:, 9] != bank[:, 9]).sum())
        bank = new
    assert changes > 3


@pytest.mark.parametrize("k,m", [(8, 20), (8, 50), (8, 300), (12, 100), (3, 7)])
def test_track_plan_at_other_shapes(k, m):
    """The kernel's one- and two-column builds (M = 20, 50), its build for
    any shape (M = 300, K = 12) and a small bank, on random banks."""
    gen = np.random.default_rng(k * 1000 + m)
    banks, balls = cs.random_banks(np, gen, 2, k=k, m=m)
    for bank, ball in zip(banks, balls):
        hold_plan(bank, ball)


def test_track_kernel_builds_match_the_plan():
    """The shapes the C entry sends to each build are the plan's: the
    register builds for K <= kRegRows and at most 4 columns a lane (1, 2,
    4), the shared-memory build otherwise, K up to the wrapper's
    MAX_TRACKS (a track a lane)."""
    src = (CSRC / "track.cu").read_text()
    assert re.search(rf"constexpr int kRegRows = {REG_ROWS};", src)
    assert re.search(rf"constexpr int kMaxTracks = {track_kernel.MAX_TRACKS};", src)
    for build in ("launch<1>", "launch<2>", "launch<4>", "launch<0>"):
        assert build in src
