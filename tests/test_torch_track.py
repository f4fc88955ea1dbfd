"""The port's ball tracker against the JAX package on the CPU: the plain
``track_update`` and ``tracks_to_balls`` against JAX's jitted
``track_update`` and its NumPy oracle over random steps, the tie-break, the
gates, rebirth into a freed slot, the kernel wrapper's checks, the tracker
rules of ``validate``, the tracked serve steps (with and without the
obstacle memory) and ``run`` against the JAX engine's on the pinned
weights, and the robot layer of the occupancy map.  The tracker kernel
itself runs on a card only (``chip_smoke.py`` phases 3 and 15)."""

from __future__ import annotations

import dataclasses

import jax
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
from tod_tpu.track import track_update as jax_track_update
from tod_tpu.track import track_update_oracle
from tod_tpu.track import tracks_to_balls as jax_tracks_to_balls
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.kernels import track as track_kernel
from tod_tpu_torch.track import init_tracks, shift_tracks, track_update, tracks_to_balls
from tod_tpu_torch.track.tracker import ACTIVE, HITS, MISSES

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

# the engines run the pipeline tests' configuration (a 160x120 camera, the
# model at its trained 256x320 input, f32), where the two packages' class
# maps agree pixel for pixel
TRACK = dict(enabled=True, obstacle_memory=0.8)
DISCRETE = [HITS, MISSES, ACTIVE]


def configs(**kw):
    return jcfg.TrackerConfig(enabled=True, **kw), tcfg.TrackerConfig(enabled=True, **kw)


JCFG, TCFG = configs()


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


def step_balls(rng, m: int, clustered: bool) -> np.ndarray:
    """One frame's ball slots: a few balls, clustered round a point (gates
    contended) or scattered, counts on both sides of min_pixels."""
    out = np.zeros((m, 4), np.float32)
    base = rng.uniform(0, 80, 2)
    for j in rng.choice(m, rng.integers(0, min(12, m + 1)), replace=False):
        xy = base + rng.normal(0, 15, 2) if clustered else rng.uniform(0, 320, 2)
        out[j, :3] = (*xy, rng.choice([2.0, 3.0, 3.5, rng.uniform(0, 40)]))
    return out


def assert_banks(got: np.ndarray, want: np.ndarray, rtol=0.0, atol=0.0) -> None:
    """Discrete fields exact; the filter state within the tolerance given."""
    np.testing.assert_array_equal(got[..., DISCRETE], want[..., DISCRETE])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("clustered", [False, True])
def test_matches_jax_over_random_steps(clustered):
    """250 steps of 3 banks at once against JAX's jitted ``track_update``
    per bank: the port follows compiled XLA's fused multiply-adds, so on
    this host the banks agree bit for bit; the stated tolerance is an ulp's
    worth (rtol 1e-6, atol 1e-5), for a host where XLA contracts
    differently.  The seeds agree as the banks do."""
    rng = np.random.default_rng(int(clustered))
    want = np.zeros((3, 8, 10), np.float32)
    got = init_tracks(TCFG, n=3)
    events = 0
    for i in range(250):
        balls = np.stack([step_balls(rng, 100, clustered) for _ in range(3)])
        before = want.copy()
        want = np.stack([np.asarray(jitted_update(want[b], balls[b], JCFG)) for b in range(3)])
        got = track_update(got, torch.from_numpy(balls), TCFG)
        assert_banks(got.numpy(), want, rtol=1e-6, atol=1e-5)
        events += int((want[..., ACTIVE] != before[..., ACTIVE]).sum())
        got = torch.from_numpy(want.copy())  # each step from the same bank
    seeds = tracks_to_balls(got, TCFG, 100).numpy()
    for b in range(3):
        np.testing.assert_array_equal(seeds[b], np.asarray(jax_tracks_to_balls(want[b], JCFG, 100)))
    assert events > 50  # births and deaths happened


def test_matches_the_numpy_oracle():
    """200 steps against the JAX package's sequential NumPy oracle, at its
    own tolerance (rtol 1e-4, atol 1e-3), discrete fields exact."""
    rng = np.random.default_rng(7)
    t_np = np.zeros((8, 10), np.float32)
    t = torch.zeros(8, 10)
    for _ in range(200):
        balls = step_balls(rng, 8, clustered=True)
        t_np = track_update_oracle(t_np, balls, JCFG)
        t = track_update(t, torch.from_numpy(balls), TCFG)
        assert_banks(t.numpy(), t_np, rtol=1e-4, atol=1e-3)


jitted_update = jax.jit(jax_track_update, static_argnums=2)


def one_step(tracks: np.ndarray, balls: np.ndarray, cfg=(JCFG, TCFG)):
    """The port's new bank from ``tracks`` and ``balls``, held bit for bit
    against JAX's jitted ``track_update`` (compiled, as it serves: eager
    JAX rounds the two fused multiply-adds in two steps)."""
    want = np.asarray(jitted_update(jnp.asarray(tracks), jnp.asarray(balls), cfg[0]))
    got = track_update(torch.from_numpy(tracks), torch.from_numpy(balls), cfg[1]).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def active_row(x, y, hits=3.0, misses=0.0):
    return [x, y, 0.0, 0.0, 1.0, 0.0, 1.0, hits, misses, 1.0]


def slots(*rows, m=6):
    out = np.zeros((m, 4), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class TestAssociation:
    def test_equal_costs_pick_the_first_track_then_the_first_ball(self):
        """Two tracks at the same distance from one ball: the first track
        takes it.  One track at the same distance from two balls: the first
        ball.  (jnp.argmin's first minimum over the flat (K, M) costs.)"""
        bank = np.zeros((4, 10), np.float32)
        bank[1] = active_row(10.0, 10.0)
        bank[2] = active_row(14.0, 10.0)
        got = one_step(bank, slots((12.0, 10.0, 9.0)))
        assert got[1, HITS] == 4 and got[2, MISSES] == 1  # track 1, not 2
        bank = np.zeros((4, 10), np.float32)
        bank[0] = active_row(20.0, 20.0)
        got = one_step(bank, slots((23.0, 20.0, 9.0), (17.0, 20.0, 9.0)))
        assert got[0, 0] > 20.0  # moved toward ball 0 at x = 23
        assert got[1, ACTIVE] == 1 and got[1, 0] == 17.0  # ball 1 is born

    def test_the_gate_is_inclusive_and_min_pixels_strict(self):
        """A ball at exactly the gate (30 cells, d2 = 900) associates, one
        just past it is born instead; a count of exactly min_pixels (3.0) is
        no measurement."""
        bank = np.zeros((3, 10), np.float32)
        bank[0] = active_row(0.0, 40.0)
        got = one_step(bank, slots((30.0, 40.0, 9.0)))
        assert got[0, HITS] == 4 and got[1, ACTIVE] == 0
        got = one_step(bank, slots((30.0001, 40.0, 9.0)))
        assert got[0, MISSES] == 1 and got[1, ACTIVE] == 1
        got = one_step(bank, slots((1.0, 40.0, 3.0)))
        assert got[0, MISSES] == 1 and got[1:, ACTIVE].sum() == 0
        got = one_step(bank, slots((1.0, 40.0, 3.0001)))
        assert got[0, HITS] == 4

    def test_a_slot_freed_this_step_takes_a_birth(self):
        """Track 0 misses its max_misses-th update and dies; in the same
        step a new ball is born into slot 0, the first free slot."""
        bank = np.zeros((3, 10), np.float32)
        bank[0] = active_row(5.0, 5.0, misses=8.0)
        bank[1] = active_row(100.0, 100.0)
        got = one_step(bank, slots((100.5, 100.0, 9.0), (60.0, 60.0, 9.0)))
        assert got[0, ACTIVE] == 1 and got[0, 0] == 60.0 and got[0, HITS] == 1
        assert got[1, HITS] == 4 and got[2, ACTIVE] == 0

    @pytest.mark.parametrize("max_misses,min_hits", [(0, 1), (3, 4)])
    def test_other_lifecycle_settings(self, max_misses, min_hits):
        jc, tc = configs(max_misses=max_misses, min_hits=min_hits, gate=12.5, accel_var=0.3)
        rng = np.random.default_rng(max_misses)
        bank = np.zeros((8, 10), np.float32)
        for _ in range(40):
            balls = step_balls(rng, 16, clustered=True)
            bank = one_step(bank, balls, (jc, tc))
            np.testing.assert_array_equal(
                tracks_to_balls(torch.from_numpy(bank), tc, 16).numpy(),
                np.asarray(jax_tracks_to_balls(bank, jc, 16)))


class TestWrapper:
    def test_updates_in_place_and_returns_the_seeds(self):
        rng = np.random.default_rng(3)
        balls = torch.from_numpy(np.stack([step_balls(rng, 100, True) for _ in range(2)]))
        banks = init_tracks(TCFG, n=2)
        want = track_update(banks, balls, TCFG)
        seeds = track_kernel.track_banks(banks, balls, TCFG, 100)
        assert torch.equal(banks, want)
        assert torch.equal(seeds, tracks_to_balls(want, TCFG, 100))
        one = init_tracks(TCFG)
        assert torch.equal(track_kernel.track_banks(one, balls[0], TCFG, 100), seeds[0])
        assert torch.equal(one, want[0])

    def test_checks_before_any_launch(self):
        banks, balls = init_tracks(TCFG, n=2), torch.zeros(2, 100, 4)
        with pytest.raises(ValueError, match=r"max_balls \(4\) < max_tracks \(8\)"):
            track_kernel.track_banks(banks, balls, TCFG, 4)
        with pytest.raises(ValueError, match=r"max_balls \(4\) < max_tracks \(8\)"):
            tracks_to_balls(banks[0], TCFG, 4)
        with pytest.raises(ValueError, match="contiguous float32"):
            track_kernel.track_banks(banks, balls.double(), TCFG, 100)
        with pytest.raises(ValueError, match="expected banks"):
            track_kernel.track_banks(banks, balls[:1], TCFG, 100)
        with pytest.raises(ValueError, match="unsupported device"):
            track_kernel.track_banks(banks.to("meta"), balls.to("meta"), TCFG, 100)

    def test_shift_and_init_match_jax(self):
        from tod_tpu.track import init_tracks as jax_init
        from tod_tpu.track import shift_tracks as jax_shift

        bank = np.random.default_rng(5).normal(0, 30, (8, 10)).astype(np.float32)
        np.testing.assert_array_equal(shift_tracks(torch.from_numpy(bank), 2.5, -1.25).numpy(),
                                      np.asarray(jax_shift(jnp.asarray(bank), 2.5, -1.25)))
        np.testing.assert_array_equal(init_tracks(TCFG).numpy(), np.asarray(jax_init(JCFG)))


@pytest.mark.parametrize("tracker,geometry", [
    (dict(enabled=True), {}),
    (dict(enabled=True, max_tracks=8), dict(max_balls=4)),
    (dict(enabled=True, min_hits=0), {}),
    (dict(enabled=True, max_misses=-1), {}),
    (dict(enabled=True, obstacle_memory=1.0), {}),
    (dict(obstacle_memory=0.5), {}),
    (dict(obstacle_memory=-0.1), {}),
])
def test_validate_tracker_rules_match_jax(tracker, geometry):
    want = jcfg.validate(jcfg.PipelineConfig(tracker=jcfg.TrackerConfig(**tracker),
                                             geometry=jcfg.GeometryConfig(**geometry)))
    got = tcfg.validate(tcfg.PipelineConfig(tracker=tcfg.TrackerConfig(**tracker),
                                            geometry=tcfg.GeometryConfig(**geometry)))
    assert got == list(want)
    assert bool(got) == (tracker != dict(enabled=True) or geometry != {})


def test_tracker_config_matches_jax():
    assert dataclasses.asdict(tcfg.TrackerConfig()) == dataclasses.asdict(jcfg.TrackerConfig())


@pytest.fixture(scope="module")
def tracked_engines(flat_weights):  # noqa: F811
    """(JAX engine, port engine), tracked with the obstacle memory on the
    pinned weights, the device planner."""
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(backend="tpu", **PLANNER),
                            tracker=jcfg.TrackerConfig(**TRACK)),
        nest(flat_weights), use_pallas=False,
    )
    port = Engine(
        tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
                            planner=tcfg.PlannerConfig(backend="tpu", **PLANNER),
                            tracker=tcfg.TrackerConfig(**TRACK)),
        carry_across(flat_weights), device="cpu",
    )
    return jax_engine, port


def packed_frames(n: int, start: int = 0) -> list[np.ndarray]:
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    return [pack_frame(f.rgb, f.depth) for f in
            (synth_frame_numpy(0, t, CAM["height"], CAM["width"]) for t in range(start, start + n))]


def start_state():
    """A non-trivial start: a confirmed track between the synthetic frames'
    two balls (birdseye cells near (104, 97) and (104, 95)), one confirmed
    with no ball near (coasting), one about to die (freeing its slot), and a
    remembered robot bump."""
    bank = np.zeros((8, 10), np.float32)
    bank[0] = [103.0, 96.0, 0.5, -0.25, 3.0, 0.5, 2.0, 4.0, 0.0, 1.0]
    bank[3] = [130.0, 80.0, -0.5, 0.0, 5.0, 0.0, 25.0, 2.0, 1.0, 1.0]
    bank[5] = [20.0, 10.0, -1.0, 0.0, 9.0, 1.0, 3.0, 6.0, 7.0, 1.0]
    mem = np.zeros((CAM["height"], CAM["width"]), np.float32)
    mem[60:70, 40:60] = 80.0
    return bank, mem


class TestTrackedServeSteps:
    def test_track_plan_mem_matches_jax(self, tracked_engines):
        """Four tracked+memory frames from the same bank and memory: the
        plan within the device planner's tolerances, the bank (discrete
        fields exact, floats rtol 1e-5: ball means of integral cells) and the
        memory exactly."""
        from tod_tpu_torch.core.weights import carry_state

        jax_engine, port = tracked_engines
        bank, mem = start_state()
        jt, jm = jnp.asarray(bank), jnp.asarray(mem)
        tracks, memory = carry_state(bank, mem)
        for packed in packed_frames(4):
            want, jt, jm = jax_engine._serve_step_track_plan_mem(jax_engine.params,
                                                                 jnp.asarray(packed), jt, jm)
            plan, same_tracks, same_mem = port.serve_step_track_plan_mem(
                torch.from_numpy(packed), tracks, memory)
            assert same_tracks is tracks and same_mem is memory  # updated in place
            assert_plans_close(plan.numpy(), np.asarray(want))
            assert_banks(tracks.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-4)
            np.testing.assert_array_equal(memory.numpy(), np.asarray(jm))
        assert int(np.asarray(want)[0, 0]) > 0 and tracks[:, ACTIVE].sum() >= 3
        assert memory.max() > 0

    def test_track_plan_matches_jax(self, tracked_engines):
        """The tracked step without the memory, from a fresh bank over three
        frames: births, then confirmed seeds."""
        jax_engine, port = tracked_engines
        jt = jnp.zeros((8, 10), jnp.float32)
        tracks = port._init_tracks()
        for packed in packed_frames(3, start=5):
            want, jt = jax_engine._serve_step_track_plan(jax_engine.params, jnp.asarray(packed), jt)
            plan, _ = port.serve_step_track_plan(torch.from_numpy(packed), tracks)
            assert_plans_close(plan.numpy(), np.asarray(want))
            assert_banks(tracks.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-4)
        assert int(np.asarray(want)[0, 0]) > 0 and tracks[:, HITS].max() >= 2

    def test_steps_reach_the_kernel_wrapper_only(self, tracked_engines, monkeypatch):
        """Each tracked step calls the tracker kernel's wrapper once (which
        launches the kernel on a CUDA tensor) and nothing else of the
        tracker: the engine never runs the plain ``track_update`` itself."""
        from tod_tpu_torch.runtime import engine as engine_mod
        from tod_tpu_torch.track import tracker

        _, port = tracked_engines
        calls = []
        real = engine_mod.track_banks

        def spy(*args, **kwargs):
            calls.append(args[0].shape)
            return real(*args, **kwargs)

        monkeypatch.setattr(engine_mod, "track_banks", spy)
        assert not hasattr(engine_mod, "track_update")
        monkeypatch.setattr(tracker, "track_update", lambda *a: pytest.fail("plain call"))
        packed = torch.from_numpy(packed_frames(1)[0])
        real_update = track_kernel.track_update
        monkeypatch.setattr(track_kernel, "track_update",
                            lambda *a: calls.append("plain on the CPU") or real_update(*a))
        port.serve_step_track_plan(packed, port._init_tracks())
        port.serve_step_track_plan_mem(packed, port._init_tracks(), port._init_obstacle_mem())
        assert calls == [(8, 10), "plain on the CPU"] * 2


def test_run_with_the_tracker_matches_jax(tracked_engines):
    """Three frames, every one planned: the published path is the JAX
    engine's, each run starts a fresh bank and memory, and the bank the run
    leaves equals JAX's."""
    from tod_tpu.runtime.frame_source import SyntheticSource as JaxSource
    from tod_tpu.serve.server import PathStore as JaxPathStore
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.serve.server import PathStore

    jax_engine, port = tracked_engines
    run_kw = dict(n_frames=3, plan_every=1, max_inflight=2, warmup=False)
    jstore, store = JaxPathStore(), PathStore()
    jax_engine.run(JaxSource(jcfg.CameraConfig(**CAM), n_frames=3), path_store=jstore, **run_kw)
    for _ in range(2):
        m = port.run(SyntheticSource(tcfg.CameraConfig(**CAM), n_frames=3), path_store=store,
                     **run_kw)
        assert m["n_frames"] == 3 and m["plans_done"] >= 1
        assert_banks(port._tracks_d.numpy(), np.asarray(jax_engine._tracks_d), rtol=1e-5,
                     atol=1e-4)
        np.testing.assert_array_equal(port._mem_d.numpy(), np.asarray(jax_engine._mem_d))
    jdirs = np.asarray(jstore.get().directions, np.float32)
    dirs = np.asarray(store.get().directions, np.float32)
    assert len(jdirs) > 0 and dirs.shape == jdirs.shape
    np.testing.assert_allclose(dirs, jdirs, rtol=1e-3, atol=1e-3)


class TestErrors:
    def test_tracker_requires_the_device_planner(self, flat_weights):  # noqa: F811
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.runtime.engine import Engine

        cfg = tcfg.PipelineConfig(planner=tcfg.PlannerConfig(backend="numpy"),
                                  tracker=tcfg.TrackerConfig(enabled=True))
        with pytest.raises(ValueError, match="device planner"):
            Engine(cfg, carry_across(flat_weights), device="cpu")

    def test_run_without_plan_every_and_steps_without_their_mode(self, tracked_engines,
                                                                  flat_weights):  # noqa: F811
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.runtime.engine import Engine
        from tod_tpu_torch.runtime.frame_source import SyntheticSource

        _, port = tracked_engines
        with pytest.raises(ValueError, match="plan_every"):
            port.run(SyntheticSource(port.cfg.camera, n_frames=2), warmup=False)
        plain = Engine(port.cfg.replace(tracker=tcfg.TrackerConfig(enabled=True)),
                       carry_across(flat_weights), device="cpu")
        packed = torch.from_numpy(packed_frames(1)[0])
        with pytest.raises(ValueError, match="obstacle_memory"):
            plain.serve_step_track_plan_mem(packed, plain._init_tracks(),
                                            plain._init_obstacle_mem())
        untracked = Engine(port.cfg.replace(tracker=tcfg.TrackerConfig()),
                           carry_across(flat_weights), device="cpu")
        with pytest.raises(ValueError, match="tracker.enabled"):
            untracked.serve_step_track_plan(packed, untracked._init_tracks())

    def test_carry_state_shapes(self):
        from tod_tpu_torch.core.weights import carry_state

        bank, mem = start_state()
        t, m = carry_state(bank, mem)
        assert t.dtype == m.dtype == torch.float32 and t.shape == (8, 10)
        t[0, 0] = -1.0
        assert bank[0, 0] == 103.0  # a copy
        assert carry_state(np.zeros((2, 8, 10)))[0].shape == (2, 8, 10)
        assert carry_state() == (None, None)
        with pytest.raises(ValueError, match="track bank"):
            carry_state(np.zeros((8, 9)))
        with pytest.raises(ValueError, match="obstacle memory"):
            carry_state(memory=np.zeros((2, 3, 4)))


def robot_scene(seed: int):
    rng = np.random.default_rng(seed)
    depth = rng.integers(200, 3500, (48, 64)).astype(np.uint16)
    cls = np.zeros((48, 64), np.uint8)
    cls[10:14, 8:14] = 1
    cls[30:33, 40:50] = 2
    cls[20:25, 20:24] = 3
    return depth, cls


@pytest.mark.parametrize("seed", [5, 6])
def test_robot_layer_matches_jax_and_the_occupancy_map(seed):
    """``robot_occupancy`` equals the JAX package's; ``occupancy_layers``
    gives ``(occupancy_map, robot_occupancy)`` exactly; and the map is the
    maximum of its terrain layer (robots relabelled as balls, which write
    none) and the robot layer, exactly."""
    from tod_tpu.geometry.fusion import robot_occupancy as jax_robots
    from tod_tpu_torch.geometry.fusion import occupancy_layers, occupancy_map, robot_occupancy

    depth, cls = robot_scene(seed)
    cam, geom = tcfg.CameraConfig(height=48, width=64), tcfg.GeometryConfig()
    d, c = torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(cls)
    robots = robot_occupancy(d, c, cam, geom)
    want = jax.jit(jax_robots, static_argnums=(2, 3))(
        jnp.asarray(depth), jnp.asarray(cls), jcfg.CameraConfig(height=48, width=64),
        jcfg.GeometryConfig())
    np.testing.assert_array_equal(robots.numpy(), np.asarray(want))
    height, layer = occupancy_layers(d, c, cam, geom)
    assert torch.equal(layer, robots) and torch.equal(height, occupancy_map(d, c, cam, geom))
    terrain = occupancy_map(d, torch.where((c == 1) | (c == 2), 3, c).to(torch.uint8), cam, geom)
    assert torch.equal(height, torch.maximum(terrain, robots))
    assert (robots > 0).sum() > 100 and (terrain > 0).sum() > 100
