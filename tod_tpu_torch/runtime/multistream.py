"""Multi-stream serving: N camera feeds through one batched step a tick
(counterpart of the JAX package's ``runtime/multistream.py``).

Each tick gathers the latest frame of every stream (drop-old per stream),
packs them into one ``(N, H*W*5)`` uint8 buffer and runs

    preprocess -> YOLACT -> detect -> scene fusion -> device planner

for all N streams: the preprocess and the forward as one batch, the
detection cleanup per sample with one K1 launch for the batch
(``models.yolact.detect_batch``), the fusion (K4) and the planner (K2, the
relaxation and the walk) once a stream, since those kernels take one map a
launch.  With ``TrackerConfig.enabled`` the ``(N, max_tracks, 10)`` banks
go through the tracker kernel in one launch a tick.  Nothing is read back
inside a tick; the only readback is the ``(N, max_steps + 1, 2)`` plan
buffer, which a fanout thread decodes into one ``PathStore`` a stream,
served over the wire by ``GetPthN``/``NewPthN`` (``serve/server.py``).

Obstacle memory stays single-stream, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from tod_tpu_torch.core.config import PipelineConfig, validate
from tod_tpu_torch.core.device import resolve_device
from tod_tpu_torch.geometry.fusion import ball_centroids, occupancy_map
from tod_tpu_torch.kernels.limits import refuse_kernel_limits
from tod_tpu_torch.kernels.track import track_banks
from tod_tpu_torch.models.yolact import detect_batch
from tod_tpu_torch.ops.preprocess import normalize, resize_triangle, unpack_frames
from tod_tpu_torch.planner.api import materialize_path
from tod_tpu_torch.planner.dijkstra import start_node_yx
from tod_tpu_torch.planner.relax import plan_on_device
from tod_tpu_torch.runtime.engine import _readback, _record_event, _wait, serving_model
from tod_tpu_torch.runtime.profiler import FPSMeter, StageTimer
from tod_tpu_torch.serve.server import PathStore
from tod_tpu_torch.track.tracker import init_tracks

# Supervised-run gather floor: how long past the stall timeout the tick loop
# keeps waiting for a recovered source to produce (monitor kick, factory
# reopen and first frame, with margin for a busy host).
_RESTART_GRACE_S = 5.0
_SYNC_EVERY = 16  # ticks between waits on the device (the tick timer's batch)
_TICK_HOLD_S = 0.02  # after the first fresh stream, how long a tick waits for the rest
_GATHER_TIMEOUT_S = 2.0  # run() ends when no stream turns fresh for this long


class MultiStreamEngine:
    """Holds the model on its device and serves N streams a tick.

    One ``PipelineConfig`` covers every stream (the camera rig's shared
    geometry, model and planner).  ``params`` is the port's state dict (the
    pinned weights when None); ``device`` defaults to ``cuda``.
    """

    def __init__(self, cfg: PipelineConfig | None = None, n_streams: int = 2,
                 params: Mapping[str, torch.Tensor] | None = None, device=None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.cfg = cfg or PipelineConfig()
        problems = validate(self.cfg)
        if problems:
            raise ValueError("invalid PipelineConfig: " + "; ".join(problems))
        self.n_streams = n_streams
        self.device = resolve_device(device)
        refuse_kernel_limits(self.cfg, "detect", self.device)
        self.model, self.dtype, self.anchors = serving_model(self.cfg, params, self.device)
        cam = self.cfg.camera
        self.cam_hw = (cam.height, cam.width)
        self.start_yx = start_node_yx(self.cam_hw, offset=self.cfg.planner.start_offset)
        self.tracked = bool(self.cfg.tracker.enabled)
        self.timer = StageTimer()
        self.fps = FPSMeter()
        self._supervised_feeds: Sequence = ()

    def _scenes(self, packed: torch.Tensor):
        """``(N, H*W*5)`` uint8 -> ``(heights (N, H, W) f32, balls (N,
        max_balls, 4) f32, detections)``: the batched scene's planner inputs
        (the connection and position maps, which nothing reads, are not
        computed)."""
        rgb, depth = unpack_frames(packed.to(self.device, non_blocking=True), self.cam_hw)
        mcfg, cam, geom = self.cfg.model, self.cfg.camera, self.cfg.geometry
        x = normalize(resize_triangle(rgb, mcfg.input_size), self.dtype)
        dets = detect_batch(self.model(x), mcfg, self.anchors, out_hw=self.cam_hw)
        heights = torch.stack([occupancy_map(d, c, cam, geom)
                               for d, c in zip(depth, dets.class_map)])
        balls = torch.stack([ball_centroids(d, c, i, cam, geom)
                             for d, c, i in zip(depth, dets.class_map, dets.id_map)])
        return heights, balls, dets

    def _plan_all(self, heights: torch.Tensor, balls: torch.Tensor) -> torch.Tensor:
        """The device planner once a stream -> ``(N, max_steps + 1, 2)``."""
        pcfg = self.cfg.planner
        return torch.stack([
            plan_on_device(h, b, self.start_yx, max_seeds=pcfg.max_seed_balls,
                           min_pixels=pcfg.min_ball_pixels, max_steps=pcfg.max_path_steps,
                           max_iters=pcfg.tpu_max_iters, signed=pcfg.signed_turns)[0]
            for h, b in zip(heights, balls)
        ])

    @torch.inference_mode()
    def _serve_plan_batch(self, packed: torch.Tensor) -> torch.Tensor:
        """The N-stream tick: frames in, ``(N, max_steps + 1, 2)`` plan
        buffers out, on the device."""
        heights, balls, _ = self._scenes(packed)
        return self._plan_all(heights, balls)

    @torch.inference_mode()
    def _serve_plan_batch_track(self, packed: torch.Tensor, tracks: torch.Tensor):
        """The tracked tick -> ``(plans, banks)``: one tracker launch updates
        the ``(N, max_tracks, 10)`` banks in place, and each stream plans
        from its confirmed tracks."""
        heights, balls, _ = self._scenes(packed)
        seeds = track_banks(tracks, balls, self.cfg.tracker, self.cfg.geometry.max_balls)
        return self._plan_all(heights, seeds), tracks

    def _init_track_bank(self) -> torch.Tensor:
        """All-inactive ``(N, max_tracks, 10)`` banks on the device."""
        return init_tracks(self.cfg.tracker, n=self.n_streams, device=self.device)

    def warmup(self) -> float:
        """One tick of all-zero frames (cuDNN plans, kernel builds and
        loads); returns seconds."""
        h, w = self.cam_hw
        packed = torch.zeros((self.n_streams, h * w * 5), dtype=torch.uint8)
        t0 = time.perf_counter()
        if self.tracked:
            # a throwaway bank: _drive starts the run's own
            self._serve_plan_batch_track(packed, self._init_track_bank())
        else:
            self._serve_plan_batch(packed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def process(self, packed_np: np.ndarray) -> torch.Tensor:
        """One tick from host frames packed ``(N, H*W*5)`` uint8 -> the
        ``(N, max_steps + 1, 2)`` plan buffers on the device."""
        if packed_np.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got {packed_np.shape[0]}")
        return self._serve_plan_batch(torch.from_numpy(np.ascontiguousarray(packed_np)))

    def run(self, sources: Sequence, n_ticks: int | None = None,
            path_stores: Optional[Sequence[PathStore]] = None, warmup: bool = True,
            max_inflight: int | None = 4) -> dict:
        """Drive N streams; returns the JAX package's metrics.

        Each source feeds a latest-frame slot on its own thread.  A tick
        waits until every stream has a frame, holds up to ``_TICK_HOLD_S``
        after the first fresh one for the rest (:func:`_gather`), and runs
        the batched step; a fanout thread decodes the freshest plan buffer
        into the per-stream stores.  ``max_inflight`` bounds the ticks queued
        on the device.  The run ends when every source is exhausted, when no
        stream turns fresh for ``_GATHER_TIMEOUT_S``, or after ``n_ticks``.
        """
        if path_stores is not None and len(path_stores) != len(sources):
            raise ValueError("need one PathStore per source")
        if len(sources) != self.n_streams:
            raise ValueError(
                f"engine built for {self.n_streams} streams, got {len(sources)} sources")
        return self._drive(lambda: [_StreamFeed(s) for s in sources], n_ticks=n_ticks,
                           path_stores=path_stores, warmup=warmup, max_inflight=max_inflight)

    def run_supervised(self, source_factories: Sequence, n_ticks: int | None = None,
                       path_stores: Optional[Sequence[PathStore]] = None,
                       stall_timeout_s: float = 5.0, max_restarts: int = 3, warmup: bool = True,
                       max_inflight: int | None = 4) -> dict:
        """``run()`` with each stream's source supervised: a source that dies
        (raises) or stops yielding for ``stall_timeout_s`` is closed and
        reopened from its factory, up to ``max_restarts`` times a stream,
        while the other streams keep serving; clean exhaustion ends that
        stream.  Metrics gain ``restarts`` (summed over streams).  The tick
        loop's ``gather_timeout_s`` is floored at the stall timeout, one
        monitor tick and ``_RESTART_GRACE_S`` (and never below
        ``_GATHER_TIMEOUT_S``), so a rig-wide stall waits for supervision to
        reopen the sources instead of ending the run."""
        if path_stores is not None and len(path_stores) != len(source_factories):
            raise ValueError("need one PathStore per source factory")
        if len(source_factories) != self.n_streams:
            raise ValueError(f"engine built for {self.n_streams} streams, "
                             f"got {len(source_factories)} factories")
        gather_timeout_s = max(_GATHER_TIMEOUT_S, stall_timeout_s
                               + min(stall_timeout_s / 4, 0.25) + _RESTART_GRACE_S)
        self._supervised_feeds = ()  # a fresh run starts at 0 restarts

        def _make_feeds():
            feeds = [_SupervisedFeed(f, stall_timeout_s, max_restarts) for f in source_factories]
            self._supervised_feeds = feeds  # live restart counts (GetStat)
            return feeds

        m = self._drive(_make_feeds, n_ticks=n_ticks, path_stores=path_stores, warmup=warmup,
                        max_inflight=max_inflight, gather_timeout_s=gather_timeout_s)
        m["restarts"] = self.restarts
        return m

    @property
    def restarts(self) -> int:
        """Per-stream source restarts so far, summed (live during
        ``run_supervised``, read by GetStat)."""
        return sum(f.restarts for f in self._supervised_feeds)

    def _drive(self, feeds_factory, n_ticks: int | None = None,
               path_stores: Optional[Sequence[PathStore]] = None, warmup: bool = True,
               max_inflight: int | None = 4,
               gather_timeout_s: float = _GATHER_TIMEOUT_S) -> dict:
        # warm up before the feeds start: they drop old frames, and a finite
        # source could run out while the first tick builds its kernels
        compile_s = self.warmup() if warmup else 0.0
        feeds = feeds_factory()
        fanout = _PlanFanout(self, path_stores)
        on_card = self.device.type == "cuda"
        inflight: deque = deque()
        n_done = fresh_total = batch_n = 0
        out = done = None
        tracks = self._init_track_bank() if self.tracked else None
        t_start = t_batch = time.perf_counter()
        packed_len = self.cam_hw[0] * self.cam_hw[1] * 5
        try:
            while n_ticks is None or n_done < n_ticks:
                batch, fresh = _gather(feeds, timeout=gather_timeout_s, packed_len=packed_len)
                if batch is None:
                    break  # every stream exhausted, or none produced in time
                t_dispatch = time.perf_counter()
                packed = torch.from_numpy(batch)
                if on_card:
                    packed = packed.pin_memory()
                if self.tracked:
                    out, tracks = self._serve_plan_batch_track(packed, tracks)
                else:
                    out = self._serve_plan_batch(packed)
                done = _record_event() if on_card else None
                if max_inflight is not None:
                    inflight.append(done)
                    if len(inflight) > max_inflight:
                        _wait(inflight.popleft())
                fanout.submit(_readback(out), t_dispatch)
                n_done += 1
                fresh_total += fresh
                batch_n += 1
                if batch_n >= _SYNC_EVERY:
                    _wait(done)
                    t_batch = self._record_ticks(t_batch, batch_n)
                    batch_n = 0
        finally:
            if out is not None and batch_n:
                _wait(done)
                self._record_ticks(t_batch, batch_n)
            wall = time.perf_counter() - t_start
            for f in feeds:
                f.close()
            fanout.finish()
        return {
            "n_ticks": n_done,
            "n_streams": self.n_streams,
            "fresh_frames": fresh_total,
            "wall_s": wall,
            "ticks_per_s": n_done / wall if wall > 0 else 0.0,
            "frames_per_s": n_done * self.n_streams / wall if wall > 0 else 0.0,
            "fresh_frames_per_s": fresh_total / wall if wall > 0 else 0.0,
            "plans_done": fanout.n_planned,
            "compile_s": compile_s,
            "stages": self.timer.summary(),
        }

    def _record_ticks(self, t_batch: float, batch_n: int) -> float:
        now = time.perf_counter()
        for _ in range(batch_n):
            self.timer.record("tick", (now - t_batch) / batch_n)
            self.fps.tick()
        return now


def _gather(feeds, timeout: float, hold_s: float = _TICK_HOLD_S, packed_len: int = 0):
    """One batch from the latest-frame slots: ``((N, H*W*5) uint8, fresh
    count)``.

    Once the first stream turns fresh, wait up to ``hold_s`` for the rest,
    then tick with whatever is fresh; late or dead streams hold their last
    frame.  A stream that died before its first frame becomes an all-zero
    frame of ``packed_len`` bytes (black, zero depth: an empty plan) instead
    of wedging the others.  ``(None, 0)`` once every feed is exhausted with
    nothing unconsumed, or when nothing fresh arrives within ``timeout``.
    """
    deadline = time.monotonic() + timeout
    first_fresh_t: float | None = None

    def _absent(f):  # died before its first frame: nothing will ever come
        return f.done and not f.has_frame

    def _snap(f):
        if _absent(f):
            return np.zeros((packed_len,), np.uint8), 0
        return f.take()

    while True:
        live = [f for f in feeds if not _absent(f)]
        if not live:
            return None, 0
        if all(f.has_frame for f in live):
            n_fresh = sum(1 for f in live if f.has_fresh)
            if n_fresh and n_fresh < len(live) and first_fresh_t is None:
                first_fresh_t = time.monotonic()
            if n_fresh and (
                n_fresh == len(live)
                or all(f.done for f in live)  # no more frames coming
                or time.monotonic() - (first_fresh_t or 0.0) >= hold_s
            ):
                snaps = [_snap(f) for f in feeds]
                return np.stack([b for b, _ in snaps]), sum(fr for _, fr in snaps)
            if n_fresh == 0 and all(f.done for f in live):
                return None, 0  # exhausted; the final frames were planned
        if time.monotonic() > deadline:
            return None, 0
        time.sleep(0.001)


class _StreamFeed:
    """A source's latest-frame slot (drop-old): a reader thread packs each
    frame into the flat ``[rgb bytes][depth LE bytes]`` buffer and
    overwrites the slot."""

    def __init__(self, source):
        self._source = source
        self._lock = threading.Lock()
        self._buf: np.ndarray | None = None
        self._seq = 0  # bumps on every new frame
        self._taken = 0  # the last seq handed out
        self._last_t = time.monotonic()  # the last frame's arrival (stall detection)
        self.done = False
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tod-stream-feed")
        self._thread.start()

    def _loop(self) -> None:
        try:
            self._pump(self._source)
        finally:
            self.done = True

    def _pump(self, source) -> None:
        """Drain one source into the slot until it ends."""
        for frame in source.frames():
            if self._stop:
                break
            h, w = frame.depth.shape
            packed = np.empty((h * w * 5,), np.uint8)
            packed[: h * w * 3] = np.ascontiguousarray(frame.rgb, np.uint8).reshape(-1)
            depth = np.ascontiguousarray(frame.depth, "<u2")
            packed[h * w * 3 :] = depth.view(np.uint8).reshape(-1)
            with self._lock:
                self._buf = packed
                self._seq += 1
            self._last_t = time.monotonic()

    @property
    def has_frame(self) -> bool:
        """Has this stream produced a frame yet (does not consume)?"""
        with self._lock:
            return self._buf is not None

    @property
    def has_fresh(self) -> bool:
        """Is there a frame newer than the last ``take()`` (does not
        consume)?"""
        with self._lock:
            return self._seq > self._taken

    def take(self) -> tuple[np.ndarray | None, int]:
        """``(buffer, fresh)``, consuming freshness: ``fresh`` is 1 when the
        buffer is newer than the last take, 0 for a held frame."""
        with self._lock:
            fresh = int(self._seq > self._taken)
            self._taken = self._seq
            return self._buf, fresh

    def close(self) -> None:
        self._stop = True
        try:
            self._source.close()
        except Exception:
            pass
        self._thread.join(timeout=5)


class _SupervisedFeed(_StreamFeed):
    """A :class:`_StreamFeed` that owns its source's lifecycle: a source that
    dies (its ``frames()`` raises) or wedges (yields nothing for
    ``stall_timeout_s``; ``close()`` kicks it loose) is reopened from
    ``factory``, up to ``max_restarts`` times, while the slot keeps its
    last frame.  Clean exhaustion ends the stream without a restart, as in
    ``Engine.run_supervised``."""

    def __init__(self, factory, stall_timeout_s: float = 5.0, max_restarts: int = 3):
        self._factory = factory
        self._swap = threading.Lock()  # guards _source across restart and close
        self._stall_s = stall_timeout_s
        self._max_restarts = max_restarts
        self._kicked = False  # the monitor fired on the current source
        self.restarts = 0
        super().__init__(factory())
        self._mon = threading.Thread(target=self._monitor, daemon=True, name="tod-feed-monitor")
        self._mon.start()

    def _loop(self) -> None:
        try:
            while True:
                self._kicked = False
                raised = False
                try:
                    self._pump(self._source)
                except Exception:
                    raised = True  # a dying source is what supervision absorbs
                if self._stop or self.restarts >= self._max_restarts:
                    return
                if not (raised or self._kicked):
                    return  # clean exhaustion: not a failure
                self.restarts += 1
                with self._swap:
                    try:
                        self._source.close()
                    except Exception:
                        pass
                    self._source = self._factory()
                self._last_t = time.monotonic()  # a fresh stall window
        finally:
            self.done = True

    def _monitor(self) -> None:
        """Kick a wedged source: ``close()`` unblocks most blocking frame
        iterators, the pump returns and ``_loop`` reopens the source."""
        tick = min(self._stall_s / 4, 0.25)
        while not self._stop and not self.done:
            time.sleep(tick)
            if (not self._stop and not self.done
                    and time.monotonic() - self._last_t > self._stall_s):
                self._kicked = True
                with self._swap:
                    try:
                        self._source.close()
                    except Exception:
                        pass
                self._last_t = time.monotonic()  # one kick a stall window

    def close(self) -> None:
        self._stop = True
        with self._swap:
            try:
                self._source.close()
            except Exception:
                pass
        self._thread.join(timeout=5)
        self._mon.join(timeout=5)


class _PlanFanout:
    """Depth-1 plan decoder (drop-old): waits for the freshest ``(N, S + 1,
    2)`` readback to reach the host and fans the per-stream paths out to the
    stores; records ``plan`` (the wait and decode) and ``latency``
    (dispatch to published)."""

    def __init__(self, engine: MultiStreamEngine, stores: Optional[Sequence[PathStore]]):
        self.engine = engine
        self.stores = stores
        self.n_planned = 0
        self._slot = None
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tod-plan-fanout")
        self._thread.start()

    def submit(self, readback, t_dispatch: float) -> None:
        with self._cv:
            self._slot = (readback, t_dispatch)
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._slot is None and not self._stop:
                    self._cv.wait()
                if self._slot is None and self._stop:
                    return
                ((host, done), t0), self._slot = self._slot, None
            with self.engine.timer.stage("plan"):
                _wait(done)
                bufs = host.numpy()  # one readback for all N streams
                paths = [materialize_path(bufs[i]) for i in range(bufs.shape[0])]
            self.engine.timer.record("latency", time.perf_counter() - t0)
            self.n_planned += len(paths)
            if self.stores is not None:
                for store, path in zip(self.stores, paths):
                    store.set(path)

    def finish(self) -> None:
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
