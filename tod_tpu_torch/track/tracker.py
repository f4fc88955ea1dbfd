"""Temporal ball tracking: a bank of constant-velocity Kalman tracks over the
fusion ball centroids (counterpart of the JAX package's ``track/tracker.py``).

The planner seeds from the tracks instead of the per-frame centroids: a
track coasts through a few missed detections on its velocity estimate
(``max_misses``), must be measured ``min_hits`` times before it seeds the
planner, and smooths the centroid's jitter.

State row (f32): ``[x, y, vx, vy, p_pos, p_pv, p_vel, hits, misses,
active]``.  Both axes share one 2x2 covariance (they share the noise model
and are always updated together), so a track carries 3 covariance floats.
Positions are birdseye grid cells, velocities cells per update (one update
a planning frame).

:func:`track_update` is the plain version of the tracker kernel
(``kernels/track.py``, ``csrc/track.cu``): torch on a ``(K, 10)`` bank or an
``(N, K, 10)`` stack of banks, with the JAX package's float32 operations in
the same order.  Where compiled XLA contracts a product and a sum into one
fused multiply-add (the squared distance's second term, and
``p_vel - k2 * p_pv``), the sum is formed in float64 from the exact product
and rounded once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tod_tpu_torch.core.config import TrackerConfig

_F32 = torch.float32
INF = 3.4e38  # "no pair" in the association's cost matrix (rounded to f32)

# state-row field indices
X, Y, VX, VY, P_POS, P_PV, P_VEL, HITS, MISSES, ACTIVE = range(10)
STATE_WIDTH = 10

# a confirmed track's pseudo pixel count in the ball-slot format: clears the
# planner's min_pixels seed gate whatever its hit count
SEED_COUNT_BASE = 100.0


def init_tracks(cfg: TrackerConfig, n: int | None = None, device="cpu") -> torch.Tensor:
    """An all-inactive bank, ``(max_tracks, 10)`` f32 zeros, or ``n`` of
    them stacked."""
    lead = () if n is None else (n,)
    return torch.zeros((*lead, cfg.max_tracks, STATE_WIDTH), dtype=_F32, device=device)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-dim tensor on ``like``'s device."""
    return torch.full((), value, dtype=_F32, device=like.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once: the float64 product of two float32 values
    is exact."""
    return (a.double() * b.double() + c.double()).to(_F32)


def _predict(t: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """Constant-velocity predict (dt = 1): x += v; P <- F P F^T + Q."""
    q = cfg.accel_var
    out = t.clone()
    out[..., X] = t[..., X] + t[..., VX]
    out[..., Y] = t[..., Y] + t[..., VY]
    out[..., P_POS] = t[..., P_POS] + 2.0 * t[..., P_PV] + t[..., P_VEL] + _const(q * 0.25, t)
    out[..., P_PV] = t[..., P_PV] + t[..., P_VEL] + _const(q * 0.5, t)
    out[..., P_VEL] = t[..., P_VEL] + _const(q, t)
    return out


def _associate(t: torch.Tensor, meas_xy: torch.Tensor, meas_valid: torch.Tensor,
               cfg: TrackerConfig) -> torch.Tensor:
    """Gated greedy global-nearest-neighbour assignment over ``(N, K, M)``
    costs: ``max_tracks`` rounds, each taking the smallest cost left (the
    first in row-major order on a tie), while it is below ``INF``, and
    retiring its row and column -> ``(N, K)`` int32 measurement index per
    track, -1 for none."""
    n, k = t.shape[:2]
    m = meas_xy.shape[1]
    dx = t[..., X, None] - meas_xy[:, None, :, 0]
    dy = t[..., Y, None] - meas_xy[:, None, :, 1]
    d2 = _fma(dy, dy, dx * dx)
    inf = _const(INF, t)
    ok = ((t[..., ACTIVE] > 0)[..., None] & meas_valid[:, None, :]
          & (d2 <= _const(cfg.gate**2, t)))
    cost = torch.where(ok, d2, inf)
    assign = torch.full((n, k), -1, dtype=torch.int32, device=t.device)
    rows = torch.arange(k, device=t.device)[None, :, None]
    cols = torch.arange(m, device=t.device)[None, None, :]
    for _ in range(k):
        flat = cost.reshape(n, k * m).argmin(dim=1)
        hit = cost.reshape(n, k * m).gather(1, flat[:, None])[:, 0] < inf
        ti, mi = flat // m, flat % m
        current = assign.gather(1, ti[:, None])[:, 0]
        assign.scatter_(1, ti[:, None], torch.where(hit, mi.to(torch.int32), current)[:, None])
        kill = hit[:, None, None] & ((rows == ti[:, None, None]) | (cols == mi[:, None, None]))
        cost = torch.where(kill, inf, cost)
    return assign


def track_update(tracks: torch.Tensor, balls: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """One tracker step: predict, associate, Kalman update, lifecycle,
    births.

    ``tracks``: ``(K, 10)`` f32 bank (or ``(N, K, 10)``); ``balls``: the
    ``(M, 4)`` fusion centroid slots ``(x, y, count, 0)`` (or ``(N, M, 4)``)
    -> the new bank, a new tensor.  A measurement is valid when its count is
    above ``min_pixels``.  Births come after the lifecycle, so a track that
    dies frees its slot in the same step; the i-th free slot takes the i-th
    valid measurement no track took.
    """
    single = tracks.dim() == 2
    t = _predict((tracks[None] if single else tracks).to(_F32), cfg)
    b = (balls[None] if single else balls).to(_F32)
    n, k = t.shape[:2]
    meas_xy = b[..., :2]
    meas_valid = b[..., 2] > _const(cfg.min_pixels, b)
    assign = _associate(t, meas_xy, meas_valid, cfg)

    matched = assign >= 0
    safe = assign.clamp_min(0).to(torch.int64)
    z = meas_xy.gather(1, safe[..., None].expand(n, k, 2))
    zero = _const(0.0, t)
    # Kalman update (shared isotropic 2x2 P; H = [1 0])
    s = t[..., P_POS] + _const(cfg.meas_var, t)
    k1 = t[..., P_POS] / s
    k2 = t[..., P_PV] / s
    rx = z[..., 0] - t[..., X]
    ry = z[..., 1] - t[..., Y]
    upd = t.clone()
    upd[..., X] = t[..., X] + torch.where(matched, k1 * rx, zero)
    upd[..., Y] = t[..., Y] + torch.where(matched, k1 * ry, zero)
    upd[..., VX] = t[..., VX] + torch.where(matched, k2 * rx, zero)
    upd[..., VY] = t[..., VY] + torch.where(matched, k2 * ry, zero)
    upd[..., P_POS] = torch.where(matched, (1.0 - k1) * t[..., P_POS], t[..., P_POS])
    upd[..., P_PV] = torch.where(matched, (1.0 - k1) * t[..., P_PV], t[..., P_PV])
    upd[..., P_VEL] = torch.where(matched, _fma(-k2, t[..., P_PV], t[..., P_VEL]), t[..., P_VEL])

    # lifecycle: hits, misses, death
    active = t[..., ACTIVE] > 0
    hits = torch.where(matched, t[..., HITS] + 1.0, t[..., HITS])
    misses = torch.where(matched, zero, torch.where(active, t[..., MISSES] + 1.0, zero))
    alive = active & (misses <= _const(cfg.max_misses, t))
    upd[..., HITS] = torch.where(alive, hits, zero)
    upd[..., MISSES] = torch.where(alive, misses, zero)
    upd[..., ACTIVE] = alive.to(_F32)

    # births: the i-th free slot takes the i-th unassigned valid measurement
    m = b.shape[1]
    taken = torch.zeros((n, m), dtype=torch.int32, device=t.device).scatter_reduce(
        1, safe, matched.to(torch.int32), reduce="amax") > 0
    meas_free = meas_valid & ~taken
    slot_free = ~alive
    slot_rank = torch.cumsum(slot_free.to(torch.int32), dim=1) - 1
    meas_rank = torch.cumsum(meas_free.to(torch.int32), dim=1) - 1
    match = (slot_free[..., None] & meas_free[:, None, :]
             & (slot_rank[..., None] == meas_rank[:, None, :]))
    birth = match.any(dim=2)
    bz = meas_xy.gather(1, match.to(torch.uint8).argmax(dim=2)[..., None].expand(n, k, 2))
    newborn = torch.zeros_like(upd)
    newborn[..., X] = bz[..., 0]
    newborn[..., Y] = bz[..., 1]
    newborn[..., P_POS] = cfg.meas_var
    newborn[..., P_VEL] = cfg.vel0_var
    newborn[..., HITS] = 1.0
    newborn[..., ACTIVE] = 1.0
    out = torch.where(birth[..., None], newborn, upd)
    return out[0] if single else out


def track_update_oracle(tracks, balls, cfg: TrackerConfig):
    """Sequential numpy mirror of :func:`track_update` for one ``(K, 10)``
    bank, the oracle of the tests -> the new bank (f32 numpy)."""
    import numpy as np

    t = np.array(tracks, np.float32)
    balls = np.asarray(balls, np.float32)
    q = cfg.accel_var
    # predict
    t[:, X] += t[:, VX]
    t[:, Y] += t[:, VY]
    p_pos = t[:, P_POS] + 2 * t[:, P_PV] + t[:, P_VEL] + q * 0.25
    p_pv = t[:, P_PV] + t[:, P_VEL] + q * 0.5
    t[:, P_VEL] += q
    t[:, P_POS], t[:, P_PV] = p_pos, p_pv
    # associate: the global minimum cost, pair by pair
    meas_valid = balls[:, 2] > cfg.min_pixels
    k, m = t.shape[0], balls.shape[0]
    d2 = ((t[:, None, [X, Y]] - balls[None, :, :2]) ** 2).sum(-1)
    cost = np.where((t[:, ACTIVE] > 0)[:, None] & meas_valid[None, :] & (d2 <= cfg.gate ** 2),
                    d2, np.inf)
    assign = np.full(k, -1, np.int32)
    for _ in range(min(k, m)):
        if not np.isfinite(cost).any():
            break
        ti, mi = np.unravel_index(np.argmin(cost), cost.shape)
        assign[ti] = mi
        cost[ti, :] = np.inf
        cost[:, mi] = np.inf
    # Kalman update and lifecycle
    taken = set()
    for i in range(k):
        if assign[i] >= 0:
            taken.add(int(assign[i]))
            z = balls[assign[i], :2]
            s = t[i, P_POS] + cfg.meas_var
            k1, k2 = t[i, P_POS] / s, t[i, P_PV] / s
            r = z - t[i, [X, Y]]
            t[i, X] += k1 * r[0]
            t[i, Y] += k1 * r[1]
            t[i, VX] += k2 * r[0]
            t[i, VY] += k2 * r[1]
            p_old = t[i, P_PV]
            t[i, P_POS] *= 1 - k1
            t[i, P_PV] *= 1 - k1
            t[i, P_VEL] -= k2 * p_old
            t[i, HITS] += 1
            t[i, MISSES] = 0
        elif t[i, ACTIVE] > 0:
            t[i, MISSES] += 1
            if t[i, MISSES] > cfg.max_misses:
                t[i, HITS] = t[i, MISSES] = t[i, ACTIVE] = 0
    # births
    free_meas = [j for j in range(m) if meas_valid[j] and j not in taken]
    free_slots = [i for i in range(k) if t[i, ACTIVE] <= 0]
    for i, j in zip(free_slots, free_meas):
        t[i] = [balls[j, 0], balls[j, 1], 0, 0, cfg.meas_var, 0, cfg.vel0_var, 1, 0, 1]
    return t


def tracks_to_balls(tracks: torch.Tensor, cfg: TrackerConfig, max_balls: int) -> torch.Tensor:
    """The confirmed tracks in the planner's ball-slot format -> ``(max_balls,
    4)`` (or ``(N, max_balls, 4)``): slot i holds track i's position and,
    when it is confirmed (active, ``hits >= min_hits``), the pseudo count
    ``100 + hits``, else 0; the slots past the tracks are zero.  Raises when
    ``max_balls`` is below the bank's track count."""
    k = tracks.shape[-2]
    if max_balls < k:
        raise ValueError(f"max_balls ({max_balls}) < max_tracks ({k})")
    confirmed = (tracks[..., ACTIVE] > 0) & (tracks[..., HITS] >= _const(cfg.min_hits, tracks))
    cnt = torch.where(confirmed, SEED_COUNT_BASE + tracks[..., HITS], _const(0.0, tracks))
    slots = torch.stack([tracks[..., X], tracks[..., Y], cnt, torch.zeros_like(cnt)], dim=-1)
    return F.pad(slots, (0, 0, 0, max_balls - k))


def shift_tracks(tracks: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Ego-motion compensation: every track position moved by ``(dx, dy)``
    grid cells (velocities and covariances unchanged); a new tensor."""
    out = tracks.clone()
    out[..., X] += _const(dx, tracks)
    out[..., Y] += _const(dy, tracks)
    return out
