"""The serving engine: packed frame -> masks -> scene -> plan
(counterpart of the JAX package's ``runtime/engine.py``).

``serve_step_plan`` is the port of the fused frame+plan graph
``Engine._serve_step_plan``: one packed uint8 frame (H*W*3 RGB bytes, then
the depth as little-endian u16) in, one ``(max_path_steps + 1, 2)`` f32 plan
buffer out.  It runs eagerly on the engine's device: preprocess, the YOLACT
forward in ``ModelConfig.dtype``, detection cleanup (kernel K1), the
occupancy map and ball centroids, then the planner (kernel K2 for its edges).
The JAX graph dead-codes the scene's connection/pos maps that nothing reads;
here they are simply not computed on this path.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.profiler import record_function

from tod_tpu_torch.core.config import PipelineConfig, validate
from tod_tpu_torch.core.device import resolve_device
from tod_tpu_torch.core.weights import check_state, load_pinned
from tod_tpu_torch.geometry.fusion import ball_centroids, occupancy_map
from tod_tpu_torch.models.yolact import Yolact, detect
from tod_tpu_torch.ops.anchors import generate_anchors
from tod_tpu_torch.ops.preprocess import preprocess_frame, unpack_frame
from tod_tpu_torch.planner.relax import plan_on_device, start_node_yx


class Engine:
    """Holds the model on its device and serves packed frames.

    ``params`` is the port's state dict (``core.weights.load_pinned`` when
    None: the engine never starts from random weights).  ``device`` defaults
    to ``cuda``; the tests pass ``"cpu"``.
    """

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: Mapping[str, torch.Tensor] | None = None, device=None):
        self.cfg = cfg or PipelineConfig()
        problems = validate(self.cfg)
        if problems:
            raise ValueError("invalid PipelineConfig: " + "; ".join(problems))
        self.device = resolve_device(device)
        mcfg = self.cfg.model
        self.dtype = getattr(torch, mcfg.dtype)
        self.model = Yolact(mcfg)
        state = load_pinned(cfg=mcfg) if params is None else params
        check_state(self.model, state)
        self.model.load_state_dict(state)
        self.model.to(device=self.device, dtype=self.dtype).eval()
        self.anchors = torch.from_numpy(generate_anchors(mcfg)).to(self.device)
        cam = self.cfg.camera
        self.cam_hw = (cam.height, cam.width)
        self.start_yx = start_node_yx(self.cam_hw, offset=self.cfg.planner.start_offset)
        self.last_sweeps: int | None = None

    @torch.inference_mode()
    def serve_step_scene(self, packed: torch.Tensor):
        """Packed frame -> (height (H, W) f32, balls (max_balls, 4) f32).

        Each stage runs inside a ``stage/<name>`` profiler range, which a
        profiler (``chip_smoke.py``) reads and which costs nothing without one.
        """
        with record_function("stage/upload+preprocess"):
            rgb, depth = unpack_frame(packed.to(self.device, non_blocking=True), self.cam_hw)
            x = preprocess_frame(rgb, self.cfg.model.input_size, self.dtype)
        with record_function("stage/forward"):
            out = self.model(x)
        with record_function("stage/detect"):
            dets = detect(out, self.cfg.model, self.anchors, out_hw=self.cam_hw)
        with record_function("stage/fusion"):
            cam, geom = self.cfg.camera, self.cfg.geometry
            height = occupancy_map(depth, dets.class_map, cam, geom)
            balls = ball_centroids(depth, dets.class_map, dets.id_map, cam, geom)
        return height, balls

    @torch.inference_mode()
    def serve_step_plan(self, packed: torch.Tensor) -> torch.Tensor:
        """Packed frame -> (max_path_steps + 1, 2) f32 plan buffer; the
        relaxation's sweep count lands in ``self.last_sweeps``."""
        height, balls = self.serve_step_scene(packed)
        pcfg = self.cfg.planner
        plan, self.last_sweeps = plan_on_device(
            height, balls, self.start_yx,
            max_seeds=pcfg.max_seed_balls,
            min_pixels=pcfg.min_ball_pixels,
            max_steps=pcfg.max_path_steps,
            max_iters=pcfg.tpu_max_iters,
            signed=pcfg.signed_turns,
        )
        return plan
