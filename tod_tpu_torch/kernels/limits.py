"""What the card's kernels cannot take, checked before anything loads.

The plain versions take any configuration the JAX package serves; the
hand-written kernels keep a few limits of their own (a prototype row in a
thread's registers, a bank in a warp's lanes, a tile in shared memory).
:func:`kernel_limits` names each limit a configuration breaks, with the
wrappers' own constants, so that an engine on the card refuses it up front
instead of at the first launch (ROADMAP.md D, D5).  The CPU runs the plain
versions and keeps serving such configurations.
"""

from __future__ import annotations

import torch

from tod_tpu_torch.core.config import PipelineConfig
from tod_tpu_torch.kernels import bump, cc_labels, connections, mask_assembly, track
from tod_tpu_torch.kernels._build import SMEM_LIMIT

D5 = "ROADMAP.md D, D5"


def kernel_limits(cfg: PipelineConfig, mode: str = "detect") -> list[str]:
    """One line for each limit of a card kernel that ``cfg`` served in
    ``mode`` breaks, naming the limit, its value and ``D5``; empty when the
    card takes it."""
    problems = []
    mcfg, geom, cam, tk = cfg.model, cfg.geometry, cfg.camera, cfg.tracker
    if mode == "detect":
        k, n = mcfg.num_prototypes, mcfg.max_detections
        if not 1 <= k <= mask_assembly.MAX_K:
            problems.append(f"model.num_prototypes = {k}: kernel K1 (csrc/mask_assembly.cu) "
                            f"takes 1 to MAX_K = {mask_assembly.MAX_K} prototypes ({D5})")
        elif mask_assembly.smem_bytes(32, n, k) > SMEM_LIMIT:
            problems.append(f"model.max_detections = {n} at {k} prototypes: kernel K1 needs "
                            f"{mask_assembly.smem_bytes(32, n, k)} bytes of shared memory a "
                            f"block, above SMEM_LIMIT = {SMEM_LIMIT} ({D5})")
    L = geom.terrain_norm_const
    if L < 1 or bump.smem_bytes(1, L) > SMEM_LIMIT:
        problems.append(f"geometry.terrain_norm_const = {L}: kernels K3/K4 (csrc/bump.cu) take "
                        f"a radius from 1 whose one-row tile fits SMEM_LIMIT = {SMEM_LIMIT} "
                        f"bytes, L <= {max_bump_radius()} ({D5})")
    if connections.smem_bytes(1, cam.width) > SMEM_LIMIT:
        problems.append(f"camera.width = {cam.width}: kernel K2 (csrc/connections.cu) stages "
                        f"three rows within SMEM_LIMIT = {SMEM_LIMIT} bytes ({D5})")
    if mode == "semantic" and (cam.height * cam.width >= cc_labels.SENTINEL
                               or -(-cam.height // cc_labels.TILE) > cc_labels.MAX_TILE_ROWS):
        problems.append(f"camera {cam.height}x{cam.width}: the cc kernel (csrc/cc_labels.cu) "
                        f"takes H*W < {cc_labels.SENTINEL} and H <= "
                        f"{cc_labels.TILE * cc_labels.MAX_TILE_ROWS} ({D5})")
    if tk.enabled:
        k, m = tk.max_tracks, geom.max_balls
        if not 1 <= k <= track.MAX_TRACKS:
            problems.append(f"tracker.max_tracks = {k}: the tracker kernel (csrc/track.cu) "
                            f"takes 1 to MAX_TRACKS = {track.MAX_TRACKS} tracks ({D5})")
        elif 4 * k * m + m > SMEM_LIMIT:
            problems.append(f"tracker.max_tracks = {k} x geometry.max_balls = {m}: the "
                            f"tracker kernel's cost matrix takes {4 * k * m + m} bytes, above "
                            f"SMEM_LIMIT = {SMEM_LIMIT} ({D5})")
    return problems


def refuse_kernel_limits(cfg: PipelineConfig, mode: str, device: torch.device) -> None:
    """Raise ``ValueError`` with every :func:`kernel_limits` line when
    ``device`` is a card; the CPU takes any configuration."""
    if device.type == "cuda":
        problems = kernel_limits(cfg, mode)
        if problems:
            raise ValueError("the card's kernels cannot serve this PipelineConfig: "
                             + "; ".join(problems))


def max_bump_radius() -> int:
    """The largest radius whose one-row K3/K4 tile fits ``SMEM_LIMIT``."""
    L = 1
    while bump.smem_bytes(1, L + 1) <= SMEM_LIMIT:
        L += 1
    return L
