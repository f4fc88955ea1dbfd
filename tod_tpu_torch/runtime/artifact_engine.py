"""Engine-compatible serving from a frozen artifact (counterpart of the JAX
package's ``runtime/artifact_engine.py``).

:class:`ArtifactEngine` wraps a loaded :class:`~tod_tpu_torch.deploy.ServingArtifact`
in the :class:`~tod_tpu_torch.runtime.engine.Engine` surface that ``run``,
``run_supervised`` and the app's ``GetStat`` read, so ``python -m
tod_tpu_torch.app --todx model.todx`` gets the production loop (watchdog
restarts, the whole server protocol, bounded dispatch, in-stream planning)
from the frozen step.  It skips ``Engine.__init__``: no model is built and
no module of ``tod_tpu_torch.models`` is imported.  By artifact mode:

- ``"plan"``: every frame runs the frozen frame+plan step (the artifact has
  no frame-only step); every ``plan_every``-th output is read back.
- ``"track_plan"``: planning frames run the step on the run's bank, which
  the tracker kernel advances in place.  The other frames run it on a copy
  of the bank: the JAX loop runs them on the current bank and drops the
  update, and an exported step that mutates its input would otherwise
  advance the bank every frame.
- ``"scene"``: the height and balls (f32) read back for the host planner.
- ``"packed"``: the wire-packed f16 height and f32 balls, as the engine's
  own ``serve_step_packed``.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from tod_tpu_torch.core.config import (
    CameraConfig,
    ModelConfig,
    PipelineConfig,
    ServerConfig,
    TrackerConfig,
)
from tod_tpu_torch.deploy import planner_config_from_meta
from tod_tpu_torch.runtime.engine import Engine
from tod_tpu_torch.runtime.profiler import FPSMeter, StageTimer


def pipeline_config_from_meta(meta: dict, server: ServerConfig | None = None) -> PipelineConfig:
    """The serving ``PipelineConfig`` an artifact was exported with: the
    camera of its packed-input contract, the planner semantics of its
    header, the model facts for display, and the tracker for a
    ``track_plan`` artifact (its bank sized from the header)."""
    cam = meta["camera"]
    model = meta.get("model", {})
    kwargs: dict[str, Any] = {}
    if server is not None:
        kwargs["server"] = server
    tk = meta.get("tracker")
    if tk:
        kwargs["tracker"] = TrackerConfig(enabled=True, max_tracks=int(tk["max_tracks"]))
    return PipelineConfig(
        camera=CameraConfig(width=cam["width"], height=cam["height"]),
        model=ModelConfig(
            input_size=tuple(model.get("input_size",
                                       (cam["height"] // 8 * 8, cam["width"] // 8 * 8))),
            quantized=bool(model.get("quantized", False)),
            backbone=model.get("backbone", "mobilenetv2"),
            dtype=model.get("dtype", "bfloat16"),
        ),
        planner=planner_config_from_meta(meta),
        **kwargs,
    )


class ArtifactEngine(Engine):
    """The production serving loop driven by a frozen artifact; never
    builds the model."""

    def __init__(self, artifact, server: ServerConfig | None = None):
        # not Engine.__init__: no model, no weights
        self.artifact = artifact
        self.meta = artifact.meta
        self.cfg = pipeline_config_from_meta(artifact.meta, server=server)
        self.mode = artifact.meta.get("engine_mode", "detect")
        self.boot = artifact.boot
        self.device = artifact.device
        self.cam_hw = (self.cfg.camera.height, self.cfg.camera.width)
        self.timer = StageTimer()
        self.fps = FPSMeter()
        self.restarts = 0
        self._abort = False
        self._tracks_d: torch.Tensor | None = None
        self._mem_d = None
        self._obstacle_mem_mode = False
        self._sweeps = None  # a frozen plan step returns the plan alone
        self._amode = artifact.meta["mode"]
        if self._amode not in ("plan", "track_plan", "scene", "packed"):
            raise ValueError(f"unknown artifact mode {self._amode!r}")
        self._plan_on_device_mode = self._amode in ("plan", "track_plan")

    # -- the Engine surface ------------------------------------------------

    def serve_step_plan(self, packed: torch.Tensor) -> torch.Tensor:
        if self._amode != "plan":
            raise ValueError(f"serve_step_plan needs a 'plan' artifact, this is {self._amode!r}")
        return self.artifact.call(packed)

    def serve_step_track_plan(self, packed: torch.Tensor, tracks: torch.Tensor):
        return self.artifact.call(packed, tracks)

    def serve_step_scene(self, packed: torch.Tensor):
        """The device-planner modes' off-cadence frame: the frozen step,
        whose plan is not read (on a copy of the bank in ``track_plan``)."""
        if self._amode == "track_plan":
            bank = self._tracks_d if self._tracks_d is not None else self._init_tracks()
            return self.artifact.call(packed, bank.clone())[0]
        return self.artifact.call(packed)

    def serve_step_packed(self, packed: torch.Tensor) -> torch.Tensor:
        """The host-planner modes' step -> one uint8 buffer: the ``packed``
        artifact's own, or a ``scene`` artifact's f32 height and balls
        bytes (``_unpack_plan_buffer`` decodes either)."""
        out = self.artifact.call(packed)
        if self._amode == "scene":
            height, balls = out
            return torch.cat([height.reshape(-1).view(torch.uint8),
                              balls.reshape(-1).view(torch.uint8)])
        return out

    def _init_tracks(self) -> torch.Tensor:
        return self.artifact.init_tracks()

    def _unpack_plan_buffer(self, buf) -> tuple[np.ndarray, np.ndarray]:
        if self._amode == "scene":
            h, w = self.cam_hw
            raw = buf.numpy() if isinstance(buf, torch.Tensor) else np.asarray(buf)
            return (raw[: h * w * 4].view(np.float32).reshape(h, w),
                    raw[h * w * 4:].view(np.float32).reshape(-1, 4))
        return super()._unpack_plan_buffer(buf)

    def warmup(self) -> float:
        """One all-zero frame through the frozen step with the device
        synchronised (the kernels' build or load; none on an ``aot``
        boot); returns seconds, also in ``warmup_breakdown``."""
        t0 = time.perf_counter()
        packed = self._packed_zeros()
        if self._amode == "track_plan":
            self.artifact.call(packed, self._init_tracks())
        else:
            self.artifact.call(packed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.warmup_breakdown = {f"artifact_{self._amode}": round(dt, 2)}
        return dt

    def _plan_payload(self, out):
        raise RuntimeError("ArtifactEngine plans in-stream (plan artifacts) or on the host "
                           "(scene/packed): pass plan_every >= 1")

    def run(self, source, **kw):
        if kw.get("plan_paths", True) and kw.get("plan_every") is None:
            raise ValueError("ArtifactEngine requires plan_every >= 1 (the artifact freezes "
                             "no separate plan step for the batch sync points)")
        return super().run(source, **kw)

    def process(self, frame):
        raise RuntimeError("ArtifactEngine serves the frozen step only; process() needs the "
                           "full Engine")
