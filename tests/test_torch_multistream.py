"""The port's multistream serving (``runtime/multistream.py``) on the CPU:
``MultiStreamEngine`` at N = 2 against the JAX package's on the pinned
weights (plans, and the tracked banks from a shared start), each stream
against the single-stream ``Engine``, the batched unpack and detection
cleanup, and the serving loop's pieces on a narrow seeded model: the run
loop, the fanout, a stream dead at birth, supervised restarts, the gather
policy and the stream feed."""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import (
    CAM,
    MODEL,
    PLANNER,
    assert_plans_close,
    flat_weights,  # noqa: F401 (module fixture)
    nest,
)
from tod_tpu.core import config as jcfg
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.frame_source import PacedSource, SyntheticSource, synth_frame_numpy
from tod_tpu_torch.runtime.multistream import (
    _RESTART_GRACE_S,
    MultiStreamEngine,
    _gather,
    _PlanFanout,
    _StreamFeed,
)
from tod_tpu_torch.serve.server import PathStore

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

# the serving loop's tests: a narrow seeded model on a small camera
TINY_CAM = tcfg.CameraConfig(width=64, height=48)
TINY = tcfg.PipelineConfig(
    camera=TINY_CAM,
    model=tcfg.ModelConfig(input_size=(48, 64), dtype="float32", fpn_channels=16,
                           proto_channels=16, head_channels=16, width_mult=0.25,
                           num_prototypes=8),
    planner=tcfg.PlannerConfig(backend="tpu", start_offset=32),
)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes at once, and torch's default of a thread a core then
    oversubscribes the machine (this file took ten times as long under six
    workers as alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def packed(seed: int, t: int = 3, h: int = 120, w: int = 160) -> np.ndarray:
    f = synth_frame_numpy(seed, t, h, w)
    return pack_frame(f.rgb, f.depth)


@pytest.fixture(scope="module")
def tiny_state():
    from tod_tpu_torch.bench.configs import model_state

    return model_state(TINY.model, seed=0)


def tiny(n: int, tiny_state, **tracker) -> MultiStreamEngine:
    cfg = TINY.replace(tracker=tcfg.TrackerConfig(**tracker)) if tracker else TINY
    return MultiStreamEngine(cfg, n_streams=n, params=tiny_state, device="cpu")


@pytest.fixture(scope="module")
def pair(flat_weights):  # noqa: F811
    """(JAX MultiStreamEngine, the port's) at N = 2, tracked, on the pinned
    weights in the pipeline tests' configuration (160x120 camera, model at
    256x320, f32), and the port's single-stream tracked Engine."""
    from tod_tpu.runtime.multistream import MultiStreamEngine as JaxMultiStream
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    jms = JaxMultiStream(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(backend="tpu", **PLANNER),
                            tracker=jcfg.TrackerConfig(enabled=True)),
        n_streams=2, params=nest(flat_weights),
    )
    cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
                              planner=tcfg.PlannerConfig(backend="tpu", **PLANNER),
                              tracker=tcfg.TrackerConfig(enabled=True))
    state = carry_across(flat_weights)
    return (jms, MultiStreamEngine(cfg, n_streams=2, params=state, device="cpu"),
            Engine(cfg, state, device="cpu"))


def start_banks() -> np.ndarray:
    """Two banks: stream 0 with a confirmed track between its frame's two
    balls (birdseye cells near (104, 96)), stream 1 with a coasting one."""
    banks = np.zeros((2, 8, 10), np.float32)
    banks[0, 0] = [103.0, 96.0, 0.5, -0.25, 3.0, 0.5, 2.0, 4.0, 0.0, 1.0]
    banks[1, 2] = [90.0, 60.0, 0.0, 1.0, 6.0, 0.0, 4.0, 3.0, 2.0, 1.0]
    return banks


class TestAgainstJax:
    def test_plans_match_jax(self, pair):
        jms, ms, _ = pair
        batch = np.stack([packed(0), packed(5)])
        want = np.asarray(jms._serve_plan_batch(jms.params, jnp.asarray(batch)))
        got = ms._serve_plan_batch(torch.from_numpy(batch)).numpy()
        assert got.shape == want.shape == (2, ms.cfg.planner.max_path_steps + 1, 2)
        for i in range(2):
            assert_plans_close(got[i], want[i])
        assert (want[:, 0, 0] > 0).all()

    def test_tracked_banks_and_plans_match_jax(self, pair):
        """Two tracked ticks from the same start banks: the banks (discrete
        fields exact, floats rtol 1e-5: ball means of integral cells) and the
        plans."""
        from tod_tpu_torch.core.weights import carry_state

        jms, ms, _ = pair
        jb = jnp.asarray(start_banks())
        banks, _ = carry_state(start_banks())
        for t in (3, 4):
            batch = np.stack([packed(0, t), packed(5, t)])
            want, jb = jms._serve_plan_batch_track(jms.params, jnp.asarray(batch), jb)
            got, same = ms._serve_plan_batch_track(torch.from_numpy(batch), banks)
            assert same is banks  # one tracker step of both banks, in place
            want = np.asarray(want)
            for i in range(2):
                assert_plans_close(got[i].numpy(), want[i])
            np.testing.assert_array_equal(banks.numpy()[..., 7:], np.asarray(jb)[..., 7:])
            np.testing.assert_allclose(banks.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)
        assert banks[..., 9].sum() >= 3 and (want[:, 0, 0] > 0).all()

    def test_each_stream_is_the_single_stream_engine(self, pair):
        """Each stream's scene, plan and tracked bank equal the single-stream
        Engine's on the same frame and bank, exactly."""
        _, ms, eng = pair
        batch = np.stack([packed(0), packed(5)])
        heights, balls, dets = ms._scenes(torch.from_numpy(batch))
        plans = ms._serve_plan_batch(torch.from_numpy(batch))
        banks = torch.from_numpy(start_banks())
        tracked, _ = ms._serve_plan_batch_track(torch.from_numpy(batch), banks)
        for i in range(2):
            frame = torch.from_numpy(batch[i])
            h, b = eng.serve_step_scene(frame)
            assert torch.equal(heights[i], h) and torch.equal(balls[i], b)
            assert torch.equal(plans[i], eng.serve_step_plan(frame))
            bank = torch.from_numpy(start_banks()[i])
            plan, _ = eng.serve_step_track_plan(frame, bank)
            assert torch.equal(tracked[i], plan) and torch.equal(banks[i], bank)
        assert dets.class_map.shape == (2, CAM["height"], CAM["width"])


def test_batched_unpack_matches_the_single_one():
    from tod_tpu_torch.ops.preprocess import resize_triangle, unpack_frame, unpack_frames

    frames = np.stack([packed(s, h=48, w=64) for s in (1, 2, 3)])
    rgb, depth = unpack_frames(torch.from_numpy(frames), (48, 64))
    assert rgb.shape == (3, 48, 64, 3) and depth.dtype == torch.int32
    for i in range(3):
        r1, d1 = unpack_frame(torch.from_numpy(frames[i]), (48, 64))
        assert torch.equal(rgb[i], r1) and torch.equal(depth[i], d1)
        assert torch.equal(resize_triangle(rgb, (32, 40))[i], resize_triangle(r1, (32, 40)))
    with pytest.raises(ValueError, match="packed frames"):
        unpack_frames(torch.from_numpy(frames[0]), (48, 64))


def test_detect_batch_is_detect_per_sample_with_one_k1_call(tiny_state, monkeypatch):
    from tod_tpu_torch.models import yolact

    eng = tiny(2, tiny_state)
    x = torch.randn(2, 48, 64, 3, generator=torch.Generator().manual_seed(0))
    calls = []
    real = yolact.assemble_crop_masks
    monkeypatch.setattr(yolact, "assemble_crop_masks",
                        lambda p, *a: calls.append(p.shape[0]) or real(p, *a))
    with torch.inference_mode():
        out = eng.model(x)
        batch = yolact.detect_batch(out, TINY.model, eng.anchors, out_hw=(48, 64))
        assert calls == [2]
        for i in range(2):
            one = yolact.YolactOutputs(*(getattr(out, k)[i : i + 1] for k in
                                         ("loc", "conf", "coeff", "prototypes", "sem_logits")))
            single = yolact.detect(one, TINY.model, eng.anchors, out_hw=(48, 64))
            for field in ("boxes", "scores", "classes", "masks", "valid", "class_map", "id_map"):
                assert torch.equal(getattr(batch, field)[i], getattr(single, field)), field
    assert calls == [2, 1, 1]


class TestServingLoop:
    def test_run_serves_every_stream(self, tiny_state):
        ms = tiny(3, tiny_state)
        sources = [SyntheticSource(TINY_CAM, seed=s, n_frames=6) for s in (3, 11, 27)]
        stores = [PathStore() for _ in sources]
        t0 = time.time()
        m = ms.run(sources, n_ticks=6, path_stores=stores, max_inflight=2)
        assert m["n_ticks"] >= 1 and m["n_streams"] == 3
        assert m["plans_done"] >= 3 and m["fresh_frames"] >= 3
        assert all(s.get().created >= t0 for s in stores)
        assert {"tick", "plan", "latency"} <= set(m["stages"])

    def test_tracked_run_carries_the_banks(self, tiny_state):
        ms = tiny(2, tiny_state, enabled=True)
        assert ms.tracked
        m = ms.run([PacedSource(SyntheticSource(TINY_CAM, seed=s, n_frames=4), fps=100.0)
                    for s in (1, 2)], n_ticks=4, max_inflight=None)
        assert m["n_ticks"] >= 2 and m["plans_done"] == 2 * m["n_ticks"]

    def test_fanout_routes_per_stream(self, tiny_state):
        ms = tiny(3, tiny_state)
        stores = [PathStore() for _ in range(3)]
        fanout = _PlanFanout(ms, stores)
        bufs = torch.zeros((3, 5, 2))
        for i in range(3):
            bufs[i, 0, 0] = i + 1
            bufs[i, 1 : 2 + i, 0] = 10.0 * (i + 1)
        fanout.submit((bufs, None), time.perf_counter())
        fanout.finish()
        assert fanout.n_planned == 3
        for i in range(3):
            dirs = stores[i].get().directions
            assert len(dirs) == i + 1 and dirs[0][0] == pytest.approx(10.0 * (i + 1))

    def test_dead_at_birth_stream_gets_a_black_frame(self, tiny_state):
        class Dead:
            def frames(self):
                return iter(())

            def close(self):
                pass

        ms = tiny(2, tiny_state)
        stores = [PathStore(), PathStore()]
        t0 = time.time()
        m = ms.run([SyntheticSource(TINY_CAM, seed=3, n_frames=4), Dead()], n_ticks=4,
                   path_stores=stores, max_inflight=2)
        assert m["n_ticks"] >= 1 and m["fresh_frames"] >= 1
        assert stores[0].get().created >= t0 and stores[1].get().created >= t0
        assert stores[1].get().directions == []

    def test_counts_are_checked(self, tiny_state):
        ms = tiny(2, tiny_state)
        with pytest.raises(ValueError, match="2 streams"):
            ms.run([SyntheticSource(TINY_CAM, n_frames=1)], n_ticks=1)
        with pytest.raises(ValueError, match="expected 2 streams"):
            ms.process(np.zeros((3, 48 * 64 * 5), np.uint8))
        with pytest.raises(ValueError, match="n_streams"):
            MultiStreamEngine(TINY, n_streams=0, params=tiny_state, device="cpu")
        with pytest.raises(ValueError, match="one PathStore"):
            ms.run_supervised([lambda: SyntheticSource(TINY_CAM)] * 2, n_ticks=1,
                              path_stores=[PathStore()])
        plans = ms.process(np.stack([packed(1, h=48, w=64), packed(2, h=48, w=64)]))
        assert plans.shape == (2, TINY.planner.max_path_steps + 1, 2)


class Wedging:
    """Yields one frame, then blocks inside the read until closed."""

    def __init__(self, frame):
        self._frame = frame
        self._ev = threading.Event()

    def frames(self):
        yield self._frame
        self._ev.wait()

    def close(self):
        self._ev.set()


class TestSupervision:
    def test_wedged_stream_restarts_while_the_other_serves(self, tiny_state):
        frame_b = synth_frame_numpy(11, 0, 48, 64)
        calls = {"n": 0}

        def factory_b():
            calls["n"] += 1
            return Wedging(frame_b) if calls["n"] == 1 else \
                SyntheticSource(TINY_CAM, seed=11, n_frames=500)

        ms = tiny(2, tiny_state)
        stores = [PathStore(), PathStore()]
        m = ms.run_supervised(
            # stream A never ends: the run lasts its 20 ticks however slow the host
            [lambda: PacedSource(SyntheticSource(TINY_CAM, seed=3, n_frames=None), fps=40.0),
             factory_b],
            # a stall window the paced stream A never reaches on a loaded host
            n_ticks=20, path_stores=stores, stall_timeout_s=1.0, max_restarts=2,
        )
        assert m["restarts"] >= 1 and calls["n"] >= 2 and m["n_ticks"] >= 10
        assert ms.restarts == m["restarts"]

    def test_dying_source_reopens_and_exhaustion_does_not(self, tiny_state):
        calls = {"n": 0}

        def factory():
            calls["n"] += 1
            first = calls["n"] == 1

            class Dying:
                def frames(self):
                    src = PacedSource(SyntheticSource(TINY_CAM, seed=3, n_frames=500), fps=50.0)
                    for i, f in enumerate(src.frames()):
                        if first and i == 1:
                            raise OSError("camera gone")
                        yield f

                def close(self):
                    pass

            return Dying()

        ms = tiny(1, tiny_state)
        m = ms.run_supervised([factory], n_ticks=6, stall_timeout_s=5.0, max_restarts=3)
        assert m["restarts"] >= 1 and calls["n"] >= 2 and m["n_ticks"] >= 2
        m = ms.run_supervised([lambda: SyntheticSource(TINY_CAM, seed=3, n_frames=3)],
                              n_ticks=10, stall_timeout_s=0.5)
        assert m["restarts"] == 0 and m["n_ticks"] >= 1

    def test_gather_floor_and_restart_reset(self, tiny_state):
        ms = tiny(1, tiny_state)
        seen = {}

        class Fake:
            restarts = 7

        ms._supervised_feeds = (Fake(),)
        assert ms.restarts == 7

        def spy(_factory, **kw):
            assert ms.restarts == 0  # a new run starts at 0 before its feeds exist
            seen.update(kw)
            return {"n_ticks": 0}

        ms._drive = spy
        factory = [lambda: SyntheticSource(TINY_CAM, n_frames=1)]
        for stall in (0.5, 4.0, 30.0):
            floor = stall + min(stall / 4, 0.25) + _RESTART_GRACE_S
            assert ms.run_supervised(factory, stall_timeout_s=stall)["restarts"] == 0
            assert seen["gather_timeout_s"] == pytest.approx(floor)
            assert seen["max_inflight"] == 4 and seen["warmup"] is True


class FakeFeed:
    """A feed with a fixed state: a frame (or none), fresh or held, done."""

    def __init__(self, value: int | None, fresh: bool, done: bool = False):
        self._buf = None if value is None else np.full((4,), value, np.uint8)
        self._fresh = fresh
        self.done = done

    @property
    def has_frame(self):
        return self._buf is not None

    @property
    def has_fresh(self):
        return self._fresh

    def take(self):
        fresh, self._fresh = int(self._fresh), False
        return self._buf, fresh


class TestGather:
    def test_ticks_when_every_stream_is_fresh(self):
        batch, fresh = _gather([FakeFeed(1, True), FakeFeed(2, True)], timeout=1.0, packed_len=4)
        assert fresh == 2 and batch[:, 0].tolist() == [1, 2]

    def test_holds_for_late_streams_then_ticks_with_the_held_frame(self):
        t0 = time.monotonic()
        batch, fresh = _gather([FakeFeed(1, True), FakeFeed(2, False)], timeout=5.0,
                               hold_s=0.05, packed_len=4)
        assert fresh == 1 and batch[:, 0].tolist() == [1, 2]
        assert 0.04 <= time.monotonic() - t0 < 4.0

    def test_dead_stream_is_black_and_exhaustion_ends(self):
        batch, fresh = _gather([FakeFeed(7, True), FakeFeed(None, False, done=True)],
                               timeout=1.0, packed_len=4)
        assert fresh == 1 and batch[1].tolist() == [0, 0, 0, 0]
        assert _gather([FakeFeed(7, False, done=True)], timeout=1.0) == (None, 0)
        assert _gather([FakeFeed(None, False, done=True)], timeout=1.0) == (None, 0)
        t0 = time.monotonic()
        assert _gather([FakeFeed(7, False)], timeout=0.05) == (None, 0)  # nothing fresh
        assert time.monotonic() - t0 < 1.0


def test_stream_feed_drops_old_frames():
    class ListSource:
        def __init__(self, frames):
            self._frames = frames

        def frames(self):
            yield from self._frames

        def close(self):
            pass

    frames = [synth_frame_numpy(s, 0, 48, 64) for s in (1, 2, 3)]
    feed = _StreamFeed(ListSource(frames))
    deadline = time.time() + 5
    while not feed.done and time.time() < deadline:
        time.sleep(0.005)
    assert feed.done and feed.has_frame and feed.has_fresh
    buf, fresh = feed.take()
    assert fresh == 1
    np.testing.assert_array_equal(buf, pack_frame(frames[-1].rgb, frames[-1].depth))
    assert not feed.has_fresh and feed.take()[1] == 0
    feed.close()
