"""The serving engine: packed frame -> masks -> scene -> plan, and the
streaming loop around it (counterpart of the JAX package's
``runtime/engine.py``).

``serve_step_plan`` is the port of the fused frame+plan graph
``Engine._serve_step_plan``: one packed uint8 frame (H*W*3 RGB bytes, then
the depth as little-endian u16) in, one ``(max_path_steps + 1, 2)`` f32 plan
buffer out.  It runs eagerly on the engine's device: preprocess, the YOLACT
forward in ``ModelConfig.dtype``, then the class and ball-id maps by the
engine's ``mode``: ``detect``, detection cleanup (kernel K1); ``semantic``,
the reference's own path, the argmax of the semantic logits upsampled to
the frame and the connected components of its ball class (the cc kernel).
Then the occupancy map (the terrain dilation kernel: K3's strips with
``GeometryConfig.pallas_bump``, K4's whole map otherwise) and ball
centroids, then the planner (kernel K2 for its edges, the relaxation
kernel, the path walk kernel).
The JAX graph dead-codes the scene's connection/pos maps that nothing reads;
here they are simply not computed on this path.

With ``TrackerConfig.enabled`` (the device planner only) a planning frame
runs ``serve_step_track_plan``: the tracker kernel (``kernels/track.py``)
updates the ``(max_tracks, 10)`` bank in place on the device and the planner
seeds from its confirmed tracks; with ``obstacle_memory`` > 0,
``serve_step_track_plan_mem`` also keeps a decayed maximum of the robot
bumps on the device, and the planner's height is the larger of it and the
fresh map.  ``run`` starts a fresh bank and memory each run; nothing of
either is read back.

``run`` streams a frame source through it in one of the JAX package's two
modes, chosen by ``PlannerConfig.backend`` as the JAX package chooses:
``tpu``, or ``auto`` on the card, is the device-planner mode (every
``plan_every``-th frame through ``serve_step_plan``, the others through
``serve_step_scene``); ``numpy``, ``native``, or ``auto`` on the CPU, is
the host-planner mode (every frame through ``serve_step_packed``, whose f16
height and f32 ball bytes a planning frame reads back for
``planner.api.plan_from_height``).  A CUDA event recorded after each frame
stands in for ``block_until_ready``.  Three helper threads touch no device
tensor: the uploader packs frames into (pinned) host memory, the planner
waits on a readback's event and plans or decodes its host copy, the latency
sampler waits on frame events.  On the card a planning frame only enqueues
work (the relaxation and the walk are kernels that read nothing back), so
``max_inflight`` bounds planning frames as it bounds the others.  The JAX
package's ``probe_rtt`` measures a remote TPU transport and has no
counterpart on a local card.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from collections import deque
from typing import Mapping

import numpy as np
import torch

from tod_tpu_torch.core.config import PipelineConfig, validate
from tod_tpu_torch.core.device import resolve_device
from tod_tpu_torch.core.types import Detections, Frame, Path, Scene
from tod_tpu_torch.core.weights import check_state, load_pinned
from tod_tpu_torch.geometry.fusion import (
    ball_centroids,
    fuse_scene,
    occupancy_layers,
    occupancy_map,
)
from tod_tpu_torch.kernels.limits import refuse_kernel_limits
from tod_tpu_torch.kernels.track import track_banks
from tod_tpu_torch.ops.anchors import generate_anchors
from tod_tpu_torch.ops.cc_labels import connected_components
from tod_tpu_torch.ops.packing import unpack_height_balls
from tod_tpu_torch.ops.postprocess import semantic_argmax, upsample_nearest
from tod_tpu_torch.ops.preprocess import (
    pack_frame,
    preprocess_frame,
    unpack_frame,
    upscale_to_frame,
)
from tod_tpu_torch.planner.api import host_backend, materialize_path, plan_from_height
from tod_tpu_torch.planner.dijkstra import start_node_yx
from tod_tpu_torch.planner.relax import plan_on_device
from tod_tpu_torch.runtime.frame_source import SyntheticSource
from tod_tpu_torch.runtime.profiler import FPSMeter, StageTimer, span
from tod_tpu_torch.track.tracker import init_tracks


MODES = ("detect", "semantic")


def _serving(step):
    """Run a serve step under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` while ``torch.export`` traces it (``deploy.py``
    freezes the steps; an inference tensor cannot be traced)."""
    @functools.wraps(step)
    def wrapper(*args, **kwargs):
        mode = torch.no_grad() if torch.compiler.is_exporting() else torch.inference_mode()
        with mode:
            return step(*args, **kwargs)

    return wrapper


def serving_model(cfg: PipelineConfig, params: Mapping[str, torch.Tensor] | None,
                  device: torch.device) -> tuple[torch.nn.Module, torch.dtype, torch.Tensor]:
    """``(model, compute dtype, anchors)`` of ``cfg.model`` on ``device``,
    loaded from the state dict ``params`` (the pinned weights when None);
    shared by :class:`Engine` and the multistream engine.  With
    ``ModelConfig.quantized`` a float state dict is prepared for int8 first
    (``_calibrate_int8``), a prepared one is served as it is, and the model
    keeps each tensor's own type (s8 kernels, f32 scales and biases)."""
    from tod_tpu_torch.core.registry import get_model
    from tod_tpu_torch.models.qconv import is_prepared, load_prepared
    from tod_tpu_torch.models.resnet import keep_f32

    mcfg = cfg.model
    dtype = getattr(torch, mcfg.dtype)
    model = get_model(mcfg.name, mcfg)
    state = load_pinned(cfg=mcfg) if params is None else params
    if mcfg.quantized:
        if not is_prepared(state):
            state = _calibrate_int8(cfg, state, device)
        load_prepared(model, state)
        model.to(device=device).eval()
    else:
        check_state(model, state)
        model.load_state_dict(state)
        model.to(device=device, dtype=dtype).eval()
        keep_f32(model, state)  # a ResNet's unfolded BatchNorms compute in f32
    return model, dtype, torch.from_numpy(generate_anchors(mcfg)).to(device)


def _calibrate_int8(cfg: PipelineConfig, state: Mapping[str, torch.Tensor],
                    device: torch.device, n_calib: int = 4) -> dict[str, torch.Tensor]:
    """The static int8 state dict of the folded float ``state``: ``n_calib``
    synthetic frames (seed 101, the training distribution) preprocessed at
    the model's input size in its dtype run through the dynamic branch of a
    quantized model on ``device`` (on the card, the int8 kernel), or with
    ``ModelConfig.qat`` through its QAT branch, then the quantization
    (``models/prepare.py``)."""
    from tod_tpu_torch.core.registry import get_model
    from tod_tpu_torch.models.prepare import prepare_int8_params
    from tod_tpu_torch.models.qconv import conv_sites

    mcfg = cfg.model
    dtype = getattr(torch, mcfg.dtype)
    model = get_model(mcfg.name, mcfg)
    if mcfg.qat:
        for site in conv_sites(model).values():
            site.set_branch("qat")
    check_state(model, state)
    model.to(device=device).eval()
    src = SyntheticSource(cfg.camera, seed=101, n_frames=n_calib)
    batches = [preprocess_frame(torch.from_numpy(f.rgb).to(device), mcfg.input_size, dtype)
               for f in src.frames()]
    return prepare_int8_params(model, {k: v.to(device) for k, v in state.items()}, batches,
                               quantize_depthwise=mcfg.quantize_depthwise)


class Engine:
    """Holds the model on its device and serves packed frames.

    ``params`` is the port's state dict (``core.weights.load_pinned`` when
    None: the engine never starts from random weights).  ``device`` defaults
    to ``cuda``; the tests pass ``"cpu"``.  ``mode``:

    - ``"detect"``: the full YOLACT path, boxes, instance masks and the
      class and id maps from them;
    - ``"semantic"``: the reference's shipped path, the semantic head's
      argmax and the connected components of its ball class; the
      ``Detections`` it returns hold no boxes.
    """

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: Mapping[str, torch.Tensor] | None = None, device=None,
                 mode: str = "detect"):
        self.cfg = cfg or PipelineConfig()
        problems = validate(self.cfg)
        if problems:
            raise ValueError("invalid PipelineConfig: " + "; ".join(problems))
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.device = resolve_device(device)
        refuse_kernel_limits(self.cfg, mode, self.device)
        self.model, self.dtype, self.anchors = serving_model(self.cfg, params, self.device)
        cam = self.cfg.camera
        self.cam_hw = (cam.height, cam.width)
        self.start_yx = start_node_yx(self.cam_hw, offset=self.cfg.planner.start_offset)
        # the JAX package's rule, with the card in place of the TPU
        backend = self.cfg.planner.backend
        self._plan_on_device_mode = backend == "tpu" or (
            backend == "auto" and self.device.type == "cuda")
        tkcfg = self.cfg.tracker
        if tkcfg.enabled and not self._plan_on_device_mode:
            raise ValueError(
                "tracker.enabled requires the device planner (the track bank "
                "lives on the device inside the frame+plan step) - set "
                "planner.backend='tpu'"
            )
        self._obstacle_mem_mode = tkcfg.enabled and tkcfg.obstacle_memory > 0.0
        self._decay = torch.full((), tkcfg.obstacle_memory, dtype=torch.float32,
                                 device=self.device)
        self._tracks_d: torch.Tensor | None = None  # a run's bank (tracker mode)
        self._mem_d: torch.Tensor | None = None  # a run's obstacle memory
        self._sweeps: torch.Tensor | None = None
        self.timer = StageTimer()
        self.fps = FPSMeter()
        self.restarts = 0
        self._abort = False

    def _prepare_int8(self, state: Mapping[str, torch.Tensor],
                      n_calib: int = 4) -> dict[str, torch.Tensor]:
        """The JAX engine's shim: ``_calibrate_int8`` for this engine's
        configuration and device."""
        return _calibrate_int8(self.cfg, state, self.device, n_calib)

    @property
    def last_sweeps(self) -> int | None:
        """The relaxation sweeps of the last device plan (None before one).
        Read when asked: on the card it waits for that plan's relaxation."""
        return None if self._sweeps is None else int(self._sweeps)

    def _step(self, packed: torch.Tensor) -> tuple[torch.Tensor, Detections]:
        """Packed frame -> (depth (H, W) int32 mm, detections).

        Each stage runs inside a ``stage/<name>`` span (``runtime/profiler.py``):
        a profiler range while a profiler is active (``chip_smoke.py`` reads
        them), its host time in ``SPANS`` always.
        """
        with span("stage/upload+preprocess"):
            rgb, depth = unpack_frame(packed.to(self.device, non_blocking=True), self.cam_hw)
            x = preprocess_frame(rgb, self.cfg.model.input_size, self.dtype)
        with span("stage/forward"):
            out = self.model(x)
        if self.mode == "semantic":
            with span("stage/semantic"):
                mcfg = self.cfg.model
                cls_small = semantic_argmax(out.sem_logits[0], mcfg.meaningful_classes)
                cls_map = upscale_to_frame(upsample_nearest(cls_small, 8), self.cam_hw)
                ids = connected_components(cls_map == 3, max_labels=self.cfg.geometry.max_balls)
                return depth, _empty_detections(mcfg, self.cam_hw, cls_map, ids)
        with span("stage/detect"):
            dets = _detect(out, self.cfg.model, self.anchors, out_hw=self.cam_hw)
        return depth, dets

    @_serving
    def serve_step_scene(self, packed: torch.Tensor):
        """Packed frame -> (height (H, W) f32, balls (max_balls, 4) f32)."""
        depth, dets = self._step(packed)
        with span("stage/fusion"):
            return height_and_balls(depth, dets, self.cfg)

    @_serving
    def serve_step_packed(self, packed: torch.Tensor) -> torch.Tensor:
        """The host-planner mode's step: packed frame -> one uint8 buffer,
        the height map as f16 bytes, then the ball slots as f32 bytes (the
        JAX package's ``_serve_step_packed``); ``_unpack_plan_buffer``
        decodes its host copy."""
        height, balls = self.serve_step_scene(packed)
        return torch.cat([height.to(torch.float16).reshape(-1).view(torch.uint8),
                          balls.to(torch.float32).reshape(-1).view(torch.uint8)])

    def serve_step(self, rgb, depth) -> torch.Tensor:
        """:meth:`serve_step_packed` on an unpacked frame: rgb (H, W, 3)
        uint8 and depth (H, W) uint16, as numpy arrays."""
        return self.serve_step_packed(torch.from_numpy(pack_frame(rgb, depth)))

    @_serving
    def process(self, frame: Frame) -> tuple[Scene, Detections]:
        """One frame -> (the full scene, its detections) on the device."""
        depth, dets = self._step(torch.from_numpy(pack_frame(frame.rgb, frame.depth)))
        scene = fuse_scene(depth, dets.class_map, dets.id_map, self.cfg.camera, self.cfg.geometry)
        return scene, dets

    def _unpack_plan_buffer(self, buf) -> tuple[np.ndarray, np.ndarray]:
        """Host copy of a :meth:`serve_step_packed` buffer -> (height f16,
        balls f32) numpy arrays."""
        return unpack_height_balls(buf, *self.cam_hw)

    @_serving
    def serve_step_plan(self, packed: torch.Tensor) -> torch.Tensor:
        """Packed frame -> (max_path_steps + 1, 2) f32 plan buffer; the
        relaxation's sweep count is ``self.last_sweeps``."""
        return self.plan_scene(*self.serve_step_scene(packed))

    @_serving
    def plan_scene(self, height: torch.Tensor, balls: torch.Tensor) -> torch.Tensor:
        """The device planner on one scene -> the plan buffer.  On the card
        this enqueues work and reads nothing back."""
        plan, self._sweeps = plan_device(height, balls, self.start_yx, self.cfg.planner)
        return plan

    def _init_tracks(self) -> torch.Tensor:
        """An all-inactive ``(max_tracks, 10)`` bank on the device."""
        return init_tracks(self.cfg.tracker, device=self.device)

    def _init_obstacle_mem(self) -> torch.Tensor:
        """An empty ``(H, W)`` f32 obstacle memory on the device."""
        return torch.zeros(self.cam_hw, dtype=torch.float32, device=self.device)

    def _track(self, tracks: torch.Tensor, balls: torch.Tensor) -> torch.Tensor:
        """The tracker kernel on one bank, in place -> the seed slots."""
        with span("stage/track"):
            return track_banks(tracks, balls, self.cfg.tracker, self.cfg.geometry.max_balls)

    @_serving
    def serve_step_track_plan(self, packed: torch.Tensor, tracks: torch.Tensor):
        """Packed frame and ``(max_tracks, 10)`` bank -> ``(plan, bank)``: the
        tracker kernel updates the bank in place (the same tensor comes back)
        and the planner seeds from its confirmed tracks.  Reads nothing
        back."""
        if not self.cfg.tracker.enabled:
            raise ValueError("the tracked steps need tracker.enabled")
        height, balls = self.serve_step_scene(packed)
        return self.plan_scene(height, self._track(tracks, balls)), tracks

    @_serving
    def serve_step_track_plan_mem(self, packed: torch.Tensor, tracks: torch.Tensor,
                                  mem: torch.Tensor):
        """:meth:`serve_step_track_plan` with the obstacle memory ->
        ``(plan, bank, memory)``: ``mem = max(robots, mem * decay)`` in place,
        with ``robots`` the frame's robot bump layer and ``decay`` the f32 of
        ``obstacle_memory``, and the planner's height ``max(height, mem)``."""
        if not self._obstacle_mem_mode:
            raise ValueError("the memory step needs tracker.obstacle_memory > 0")
        depth, dets = self._step(packed)
        with span("stage/fusion"):
            cam, geom = self.cfg.camera, self.cfg.geometry
            height, robots = occupancy_layers(depth, dets.class_map, cam, geom)
            balls = ball_centroids(depth, dets.class_map, dets.id_map, cam, geom)
            torch.maximum(robots, mem * self._decay, out=mem)
            height = torch.maximum(height, mem)
        return self.plan_scene(height, self._track(tracks, balls)), tracks, mem

    def _packed_zeros(self) -> torch.Tensor:
        h, w = self.cam_hw
        return torch.zeros(h * w * 5, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def warmup(self) -> float:
        """Serve one all-zero frame through the mode's steps (cuDNN plans,
        kernel builds and loads; in the host-planner mode also the host
        planner's choice and native build); returns seconds, per step in
        ``warmup_breakdown``."""
        breakdown: dict[str, float] = {}
        t_total = time.perf_counter()
        if self._plan_on_device_mode:
            steps = (("serve_step_scene", self.serve_step_scene),
                     ("serve_step_plan", self.serve_step_plan))
            # the tracked step on a throwaway bank (a run starts its own)
            if self._obstacle_mem_mode:
                steps += (("serve_step_track_plan_mem", lambda p: self.serve_step_track_plan_mem(
                    p, self._init_tracks(), self._init_obstacle_mem())),)
            elif self.cfg.tracker.enabled:
                steps += (("serve_step_track_plan", lambda p: self.serve_step_track_plan(
                    p, self._init_tracks())),)
        else:
            steps = (("serve_step_packed", self.serve_step_packed),
                     ("host_planner", lambda _: host_backend(self.cfg.planner.backend)))
        for name, step in steps:
            t0 = time.perf_counter()
            step(self._packed_zeros())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            breakdown[name] = round(time.perf_counter() - t0, 2)
        self.warmup_breakdown = breakdown
        return time.perf_counter() - t_total

    def _plan_payload(self, out):
        """What the planner thread gets for the output of a step: the device
        plan's readback, or in the host-planner mode the readback of the
        packed height and balls."""
        if self._plan_on_device_mode:
            return _readback(self.plan_scene(*out))
        return _readback(out)

    def run(
        self,
        source,
        n_frames: int | None = None,
        path_store=None,
        plan_paths: bool = True,
        warmup: bool = True,
        watchdog=None,
        sync_every: int = 16,
        max_inflight: int | None = None,
        plan_every: int | None = None,
    ) -> dict:
        """Stream ``source`` through the engine; returns the JAX package's
        metrics (fps, wall time, stage percentiles, plans done).

        ``max_inflight`` bounds the frames queued on the device (the loop
        waits on the event of frame n - k); ``plan_every`` plans every n-th
        frame inside its step, and ``None`` plans the last scene of each
        ``sync_every`` batch instead.  The planner publishes the freshest plan
        only (drop-old).  The ``frame`` stage is the batch mean between
        syncs, ``latency`` a sampled dispatch-to-done time, ``plan`` the
        planner thread's wait and decode, and ``dispatch_plan`` /
        ``dispatch_scene`` the loop thread's time in each step.  With the
        tracker a planning frame runs the tracked step on a bank (and
        memory) made fresh for this run, and ``plan_every`` is required.
        """
        tracked = self.cfg.tracker.enabled and plan_paths
        if tracked and plan_every is None:
            raise ValueError(
                "tracker.enabled plans in-stream: pass plan_every "
                "(the tracker steps once per planning dispatch)"
            )
        compile_s = self.warmup() if warmup else 0.0
        if watchdog is not None:
            watchdog.heartbeat()  # set-up is not a stall
        planner = _PlannerWorker(self, path_store) if plan_paths else None
        uploader = _UploadWorker(source, n_frames, pin=self.device.type == "cuda")
        serve_fn = self.serve_step_scene if self._plan_on_device_mode else self.serve_step_packed
        plan_fn = self.serve_step_plan if self._plan_on_device_mode else self.serve_step_packed
        if tracked:
            self._tracks_d = self._init_tracks()  # a fresh bank each run
            if self._obstacle_mem_mode:
                self._mem_d = self._init_obstacle_mem()
                plan_fn = lambda p: self.serve_step_track_plan_mem(  # noqa: E731
                    p, self._tracks_d, self._mem_d)[0]
            else:
                plan_fn = lambda p: self.serve_step_track_plan(p, self._tracks_d)[0]  # noqa: E731
        sampler = _LatencySampler(self.timer)
        inflight: deque = deque()
        n_done = batch_n = 0
        out = done = None
        self._abort = False
        t_start = t_batch = time.perf_counter()
        while True:
            item = uploader.next(timeout=0.25)
            if item is _UploadWorker.TIMEOUT:
                if self._abort:
                    break
                continue
            if item is None:
                break
            t_dispatch = time.perf_counter()
            plan_frame = planner is not None and plan_every is not None and n_done % plan_every == 0
            if plan_frame:
                with self.timer.stage("dispatch_plan"):
                    out = plan_fn(item)
                planner.submit(_readback(out))
            else:
                with self.timer.stage("dispatch_scene"):
                    out = serve_fn(item)
            done = _record_event() if self.device.type == "cuda" else None
            if max_inflight is not None:
                inflight.append(done)
                if len(inflight) > max_inflight:
                    _wait(inflight.popleft())
            sampler.submit(done, t_dispatch)
            if watchdog is not None:
                watchdog.heartbeat()
            n_done += 1
            batch_n += 1
            if batch_n >= sync_every:
                _wait(done)
                if planner is not None and plan_every is None:
                    planner.submit(self._plan_payload(out))
                t_batch = self._record_batch(t_batch, batch_n)
                if watchdog is not None:
                    watchdog.heartbeat()
                batch_n = 0
        # the watchdog guards frame progress: the drain below is not a stall
        if watchdog is not None:
            watchdog.stop()
        if out is not None and batch_n:
            _wait(done)
            if planner is not None and plan_every is None:
                planner.submit(self._plan_payload(out))
            self._record_batch(t_batch, batch_n)
        wall = time.perf_counter() - t_start
        uploader.close()
        sampler.finish()
        t_drain = time.perf_counter()
        last_path = planner.finish() if planner is not None else None
        return {
            "n_frames": n_done,
            "wall_s": wall,
            "fps": n_done / wall if wall > 0 else 0.0,
            "plan_drain_s": time.perf_counter() - t_drain,
            "compile_s": compile_s,
            "stages": self.timer.summary(),
            "plans_done": planner.n_planned if planner is not None else 0,
            "last_path_len": len(last_path.directions) if last_path else 0,
            "rtt_saturated": 0,  # no transport probe on a local card
        }

    def _record_batch(self, t_batch: float, batch_n: int) -> float:
        now = time.perf_counter()
        for _ in range(batch_n):
            self.timer.record("frame", (now - t_batch) / batch_n)
            self.fps.tick()
        return now

    def abort(self) -> None:
        """Ask a running ``run()`` loop to exit at its next idle poll (the
        watchdog's recovery hook; safe from any thread)."""
        self._abort = True

    def run_supervised(self, source_factory, n_frames: int | None = None, path_store=None,
                       max_restarts: int = 3, stall_timeout_s: float = 5.0, **run_kw) -> dict:
        """``run()`` under a watchdog that recovers from source stalls: a
        stall aborts the loop, the source is closed and a fresh one from
        ``source_factory`` takes over, up to ``max_restarts`` times.  The
        count is in the metrics and in ``self.restarts`` (read by GetStat).
        A hang inside a device step blocks the loop's thread itself and needs
        supervision of the process."""
        from tod_tpu_torch.runtime.watchdog import Watchdog

        self.restarts = 0
        total: dict = {"n_frames": 0, "wall_s": 0.0, "plans_done": 0}
        warm = run_kw.pop("warmup", True)
        while True:
            wd = Watchdog(timeout_s=stall_timeout_s, on_stall=lambda age: self.abort())
            wd.start()
            source = source_factory()
            try:
                m = self.run(
                    source,
                    n_frames=None if n_frames is None else n_frames - total["n_frames"],
                    path_store=path_store, warmup=warm, watchdog=wd, **run_kw,
                )
            finally:
                wd.stop()
                # a wedged source's close() may hang itself: close it on a
                # daemon thread with a short grace period
                closer = threading.Thread(target=_call_quietly, args=(source.close,),
                                          daemon=True, name="tod-source-closer")
                closer.start()
                closer.join(timeout=2.0)
            warm = False
            total["n_frames"] += m["n_frames"]
            total["wall_s"] += m["wall_s"]
            total["plans_done"] += m.get("plans_done", 0)
            total.update({k: m[k] for k in ("compile_s", "stages", "last_path_len") if k in m})
            done = n_frames is not None and total["n_frames"] >= n_frames
            if not self._abort or done or self.restarts >= max_restarts:
                break
            self.restarts += 1
        total["fps"] = total["n_frames"] / total["wall_s"] if total["wall_s"] > 0 else 0.0
        total["restarts"] = self.restarts
        return total


def height_and_balls(depth: torch.Tensor, dets: Detections, cfg: PipelineConfig):
    """The serve steps' fusion: (height (H, W) f32, balls (max_balls, 4)
    f32), without the connection planes that only ``fuse_scene`` adds."""
    cam, geom = cfg.camera, cfg.geometry
    return (occupancy_map(depth, dets.class_map, cam, geom),
            ball_centroids(depth, dets.class_map, dets.id_map, cam, geom))


def plan_device(height: torch.Tensor, balls: torch.Tensor, start_yx, pcfg):
    """The device planner on one scene -> (plan buffer, relaxation sweeps)."""
    return plan_on_device(
        height, balls, start_yx,
        max_seeds=pcfg.max_seed_balls,
        min_pixels=pcfg.min_ball_pixels,
        max_steps=pcfg.max_path_steps,
        max_iters=pcfg.tpu_max_iters,
        signed=pcfg.signed_turns,
    )


def _detect(*args, **kwargs) -> Detections:
    """``models.yolact.detect``, imported at the first frame: the module
    loads the model code only for an engine that builds a model (an
    ``ArtifactEngine`` serves a frozen graph without it)."""
    from tod_tpu_torch.models.yolact import detect

    return detect(*args, **kwargs)


def _empty_detections(mcfg, cam_hw, cls_map: torch.Tensor, ids: torch.Tensor) -> Detections:
    """Semantic mode's ``Detections``: no boxes, the class and id maps."""
    n, dev = mcfg.max_detections, cls_map.device
    return Detections(
        boxes=torch.zeros((n, 4), device=dev),
        scores=torch.zeros((n,), device=dev),
        classes=torch.zeros((n,), dtype=torch.int32, device=dev),
        masks=torch.zeros((n, cam_hw[0] // 4, cam_hw[1] // 4), device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        class_map=cls_map,
        id_map=ids,
    )


def _call_quietly(fn) -> None:
    try:
        fn()
    except Exception:
        pass


def _readback(out: torch.Tensor):
    """Start a device tensor's copy to the host: ``(host tensor, done event)``;
    a CPU tensor is its own copy, with no event."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    return host, _record_event()


def _record_event() -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(event) -> None:
    """Wait for a frame's event; ``None`` (the CPU, whose steps return
    finished) has nothing to wait for."""
    if event is not None:
        event.synchronize()


class _UploadWorker:
    """Packs each frame into one flat uint8 buffer (RGB, then little-endian
    u16 depth), pinned for an asynchronous copy when serving on the card,
    while the loop serves the previous frame."""

    _SENTINEL = object()
    TIMEOUT = object()

    def __init__(self, source, n_frames: int | None, pin: bool, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False

        def _loop():
            try:
                n = 0
                for frame in source.frames():
                    if self._stop or (n_frames is not None and n >= n_frames):
                        break
                    h, w = frame.depth.shape
                    packed = np.empty((h * w * 5,), np.uint8)
                    packed[: h * w * 3] = np.ascontiguousarray(frame.rgb, np.uint8).reshape(-1)
                    packed[h * w * 3 :] = (
                        np.ascontiguousarray(frame.depth, "<u2").view(np.uint8).reshape(-1)
                    )
                    t = torch.from_numpy(packed)
                    self._q.put(t.pin_memory() if pin else t)
                    n += 1
            finally:
                # the sentinel must reach the loop even if the source raises
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=_loop, daemon=True, name="tod-uploader")
        self._thread.start()

    def next(self, timeout: float | None = None):
        """The next packed frame; None when the source is exhausted; TIMEOUT
        if nothing arrived within ``timeout`` (the abortable poll)."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return self.TIMEOUT
        return None if item is self._SENTINEL else item

    def close(self) -> None:
        self._stop = True
        try:  # drain so the producer can reach the sentinel and exit
            while self._q.get_nowait() is not self._SENTINEL:
                pass
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class _PlannerWorker:
    """Depth-1 latest-plan thread (drop-old): waits for a readback to reach
    the host, then decodes the device plan or, in the host-planner mode,
    plans from the height and balls, and publishes the path."""

    def __init__(self, engine: Engine, path_store):
        self.engine = engine
        self.path_store = path_store
        self.n_planned = 0
        self.last_path: Path | None = None
        self._slot = None
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tod-planner")
        self._thread.start()

    def submit(self, readback) -> None:
        with self._cv:
            self._slot = readback  # overwrite: plan the freshest frame only
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._slot is None and not self._stop:
                    self._cv.wait()
                if self._slot is None and self._stop:
                    return
                (host, done), self._slot = self._slot, None
            with self.engine.timer.stage("plan"):
                _wait(done)
                if self.engine._plan_on_device_mode:
                    path = materialize_path(host)
                else:
                    height, balls = self.engine._unpack_plan_buffer(host)
                    path = plan_from_height(height, balls, self.engine.cfg.planner)
            self.n_planned += 1
            self.last_path = path
            if self.path_store is not None:
                self.path_store.set(path)

    def finish(self) -> Path | None:
        deadline = time.time() + 10.0
        while time.time() < deadline:
            with self._cv:
                if self._slot is None:
                    break
            time.sleep(0.005)
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10)
        return self.last_path


class _LatencySampler:
    """Per-frame dispatch-to-done latency, sampled: waits on the event of
    the freshest submitted frame (drop-old) and records the ``latency``
    stage, without ever stalling the loop."""

    def __init__(self, timer: StageTimer):
        self.timer = timer
        self._slot = None
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tod-latency")
        self._thread.start()

    def submit(self, done, t_dispatch: float) -> None:
        with self._cv:
            self._slot = (done, t_dispatch)
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._slot is None and not self._stop:
                    self._cv.wait()
                if self._slot is None and self._stop:
                    return
                (done, t0), self._slot = self._slot, None
            _wait(done)
            self.timer.record("latency", time.perf_counter() - t0)

    def finish(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)
