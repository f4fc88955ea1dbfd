"""Pipeline-parallel serving: the frame graph split into two stages on two
devices (counterpart of the JAX package's ``parallel/pipeline.py``).

    stage 1 (``devices[0]``):  preprocess -> YOLACT forward
    stage 2 (``devices[-1]``): detect (K1) -> height and balls (K4) ->
                               plan_device (K2, the relaxation, the walk)

The host uploads frame n's RGB to the first device and its depth to the
second, launches stage 1, copies the head outputs to the second device in
one copy that does not wait, and launches stage 2: on two cards each
device's stream runs frame n's stage 1 beside frame n-1's stage 2, so the
steady state approaches ``1 / max(stage)`` in place of ``1 / sum``, and
each device holds its stage's working set alone.  The head outputs are the
smallest set of tensors between the stages, and stage 2 has no parameters
(the anchors are constants), so only stage 1's weights live on the first
device.  With one device both stages share it and the hop copies nothing:
the split then costs its second dispatch and nothing is gained.

On a card ``dispatch`` never waits on the device.  Where stage 2 runs on
the CPU behind a card (the card-plus-CPU split that checks the hop), the
hop has to wait for the card's copy before the CPU reads it.  Each stage
runs in a profiler range, ``stage/pipeline_1`` and ``stage/pipeline_2``,
which measure the port's own split.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Mapping

import numpy as np
import torch

from tod_tpu_torch.core.config import PipelineConfig
from tod_tpu_torch.parallel.mesh import visible_devices
from tod_tpu_torch.parallel.sharding import upload
from tod_tpu_torch.runtime.profiler import span


class TwoStagePipeline:
    """Stage-split serving over two devices.

    ``devices``: ``(stage 1 device, stage 2 device)``, the first two visible
    cards by default; one device serves both stages.  ``params`` is the
    port's serving state dict (the pinned weights when None)."""

    def __init__(self, cfg: PipelineConfig | None = None, devices=None,
                 params: Mapping[str, torch.Tensor] | None = None):
        from tod_tpu_torch.kernels.limits import refuse_kernel_limits
        from tod_tpu_torch.planner.dijkstra import start_node_yx
        from tod_tpu_torch.runtime.engine import serving_model

        self.cfg = cfg or PipelineConfig()
        devs = [torch.device(d) for d in (visible_devices()[:2] if devices is None
                                          else devices)]
        if not devs:
            raise ValueError("need at least one device (no CUDA device is visible; pass "
                             "devices=[...] for the CPU)")
        self.d_fwd, self.d_post = devs[0], devs[-1]
        for dev in {self.d_fwd, self.d_post}:
            refuse_kernel_limits(self.cfg, "detect", dev)
        # stage 1's weights on the first device only (stage 2 has none)
        self.model, self.dtype, anchors = serving_model(self.cfg, params, self.d_fwd)
        self.anchors = anchors.to(self.d_post)
        cam = self.cfg.camera
        self.cam_hw = (cam.height, cam.width)
        self.start_yx = start_node_yx(self.cam_hw, offset=self.cfg.planner.start_offset)

    def stage1(self, rgb: torch.Tensor):
        """(H, W, 3) uint8 on the first device -> the head outputs."""
        from tod_tpu_torch.ops.preprocess import preprocess_frame

        with span("stage/pipeline_1"):
            return self.model(preprocess_frame(rgb, self.cfg.model.input_size, self.dtype))

    def hop(self, out):
        """The head outputs onto the second device: one copy each that does
        not wait, nothing where both stages share a device.  A card's
        outputs bound for the CPU are waited for before the CPU reads
        them."""
        if self.d_post == self.d_fwd:
            return out
        moved = type(out)(**{f.name: upload(getattr(out, f.name), self.d_post)
                             for f in dataclasses.fields(out)})
        if self.d_fwd.type == "cuda" and self.d_post.type == "cpu":
            torch.cuda.current_stream(self.d_fwd).synchronize()
        return moved

    def stage2(self, out, depth: torch.Tensor) -> torch.Tensor:
        """Head outputs and (H, W) int32 depth on the second device -> the
        ``(max_path_steps + 1, 2)`` plan buffer."""
        from tod_tpu_torch.models.yolact import detect
        from tod_tpu_torch.runtime.engine import height_and_balls, plan_device

        with span("stage/pipeline_2"):
            dets = detect(out, self.cfg.model, self.anchors, out_hw=self.cam_hw)
            plan, _ = plan_device(*height_and_balls(depth, dets, self.cfg), self.start_yx,
                                  self.cfg.planner)
            return plan

    def dispatch(self, rgb_np: np.ndarray, depth_np: np.ndarray) -> torch.Tensor:
        """One frame through both stages -> the plan buffer on the second
        device (on cards, launched and not waited for)."""
        rgb = upload(torch.from_numpy(np.ascontiguousarray(rgb_np, np.uint8)), self.d_fwd)
        depth = upload(torch.from_numpy(np.asarray(depth_np, np.int32)), self.d_post)
        with torch.inference_mode():
            return self.stage2(self.hop(self.stage1(rgb)), depth)

    def _event(self):
        """An event after the work queued so far on the second device (None
        on the CPU, whose stages return finished)."""
        if self.d_post.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.d_post))
        return ev

    def warmup(self) -> float:
        """One all-zero frame through both stages (cuDNN plans, kernel
        builds and loads), waited for; returns seconds."""
        h, w = self.cam_hw
        t0 = time.perf_counter()
        self.dispatch(np.zeros((h, w, 3), np.uint8), np.zeros((h, w), np.uint16))
        for dev in {self.d_fwd, self.d_post}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def run(self, source, n_frames: int | None = None, path_store=None, warmup: bool = True,
            max_inflight: int | None = 4) -> dict:
        """The streaming loop: every frame is planned.  At most
        ``max_inflight`` plans are in flight; past that the loop waits for
        the oldest by its own event (never for the whole device), and the
        plan it waited for lands in ``path_store``; the last plan does at
        the end."""
        from tod_tpu_torch.planner.api import materialize_path

        compile_s = self.warmup() if warmup else 0.0
        inflight: deque = deque()
        n_done = 0
        t0 = time.perf_counter()
        for frame in source.frames():
            if n_frames is not None and n_done >= n_frames:
                break
            inflight.append((self.dispatch(frame.rgb, frame.depth), self._event()))
            if max_inflight is not None and len(inflight) > max_inflight:
                plan, ev = inflight.popleft()
                if ev is not None:
                    ev.synchronize()
                if path_store is not None:
                    path_store.set(materialize_path(plan))
            n_done += 1
        last = None
        for plan, ev in inflight:  # drain
            if ev is not None:
                ev.synchronize()
            last = plan
        if path_store is not None and last is not None:
            path_store.set(materialize_path(last))
        wall = time.perf_counter() - t0
        return {
            "n_frames": n_done,
            "wall_s": wall,
            "fps": n_done / wall if wall > 0 else 0.0,
            "compile_s": compile_s,
            "stage1_device": str(self.d_fwd),
            "stage2_device": str(self.d_post),
        }
