"""The port's host-planner mode on the CPU against the JAX package: the
NumPy Dijkstra and its helpers, the packing of the host readback, the native
planner (built with g++ from the port's own copy), ``plan_from_height`` and
``plan`` over every backend, the engine's host step, and ``--planner auto``
resolving as the JAX package resolves it (D2 in ROADMAP.md)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core import config as jcfg
from tod_tpu.core.types import Scene as JaxScene
from tod_tpu.planner import api as japi
from tod_tpu.planner import dijkstra as jdij
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.core.types import Scene
from tod_tpu_torch.planner import api, dijkstra

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

# A few small maps and one camera-sized one, so that the NumPy Dijkstra stays fast.
MAPS = [(0, 48, 64), (1, 48, 64), (2, 48, 64), (3, 120, 160)]


def host_scene(seed: int, h: int, w: int):
    """A rolling height map with a ridge, and ball slots: two strong balls,
    one too small to seed, one off the grid, the rest empty."""
    rng = np.random.default_rng(seed)
    hm = np.cumsum(rng.normal(0, 0.3, (h, w)), axis=0).astype(np.float32)
    hm -= hm.min()
    hm[h // 2, w // 4 : 3 * w // 4] += 40.0
    balls = np.zeros((16, 4), np.float32)
    balls[0] = [rng.uniform(2, w - 2), rng.uniform(2, h // 3), 40.0, 0.0]
    balls[1] = [rng.uniform(2, w - 2), rng.uniform(h // 3, h - 2), 25.0, 0.0]
    balls[2] = [w / 2, h / 2, 2.0, 0.0]
    balls[3] = [w + 5.0, 3.0, 30.0, 0.0]
    return hm, balls


def planner_cfgs(backend: str, **kw):
    start = dict(start_offset=24, **kw)
    return (tcfg.PlannerConfig(backend=backend, **start),
            jcfg.PlannerConfig(backend=backend, **start))


def assert_paths_close(got, want) -> None:
    """The device planner's tolerances (tests/test_torch_pipeline.py): total
    magnitude to rel 1e-4, each hop to 1e-3, each rotation to 1e-4."""
    g, w = np.asarray(got.directions, np.float64), np.asarray(want.directions, np.float64)
    assert g.shape == w.shape and len(w) > 5
    assert g[:, 0].sum() == pytest.approx(w[:, 0].sum(), rel=1e-4)
    np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(g[:, 1], w[:, 1], atol=1e-4, rtol=0)


class TestDijkstra:
    @pytest.mark.parametrize("seed,h,w", MAPS)
    def test_seeds_from_balls_match_jax(self, seed, h, w):
        _, balls = host_scene(seed, h, w)
        for k, min_pixels in ((3, 3.0), (1, 0.0), (8, 30.0)):
            got = dijkstra.seeds_from_balls(balls, k, (h, w), min_pixels=min_pixels)
            assert got == jdij.seeds_from_balls(balls, k, (h, w), min_pixels=min_pixels)

    @pytest.mark.parametrize("seed,h,w", MAPS[:3])
    def test_dijkstra_grid_and_directions_match_jax(self, seed, h, w):
        hm, balls = host_scene(seed, h, w)
        conns = japi._connections_from_height(hm)
        np.testing.assert_array_equal(api._connections_from_height(hm), conns)
        seeds = jdij.seeds_from_balls(balls, 3, (h, w), min_pixels=3.0)
        dist, parent = dijkstra.dijkstra_grid(hm, conns, seeds)
        jd, jp = jdij.dijkstra_grid(hm, conns, seeds)
        np.testing.assert_array_equal(dist, jd)
        np.testing.assert_array_equal(parent, jp)
        pos = japi._pos_from_height(hm)
        np.testing.assert_array_equal(api._pos_from_height(hm), pos)
        start = dijkstra.start_node_yx((h, w), 24)
        assert start == jdij.start_node_yx((h, w), 24)
        for signed in (False, True):
            for steps in (None, 7):
                got = dijkstra.extract_directions(dist, parent, pos, start, steps, signed)
                assert got == jdij.extract_directions(jd, jp, pos, start, steps, signed)
                assert len(got) > 5

    def test_start_node_is_clamped_onto_the_grid(self):
        for offset in (-3, 0, 1, 240, 999):
            assert dijkstra.start_node_yx((48, 64), offset) == jdij.start_node_yx((48, 64), offset)


class TestPacking:
    def test_unpack_height_balls_matches_jax(self):
        from tod_tpu.ops.packing import unpack_height_balls as jax_unpack
        from tod_tpu_torch.ops.packing import unpack_height_balls

        hm, balls = host_scene(4, 48, 64)
        buf = np.concatenate([hm.astype(np.float16).view(np.uint8).reshape(-1),
                              balls.view(np.uint8).reshape(-1)])
        for b in (buf, torch.from_numpy(buf)):
            height, got_balls = unpack_height_balls(b, 48, 64)
            jh, jb = jax_unpack(buf, 48, 64)
            assert height.dtype == np.float16 and got_balls.dtype == np.float32
            np.testing.assert_array_equal(height, jh)
            np.testing.assert_array_equal(got_balls, jb)
            np.testing.assert_array_equal(got_balls, balls)

    def test_words_match_jax(self):
        from tod_tpu.ops import packing as jpack
        from tod_tpu_torch.ops import packing

        rng = np.random.default_rng(5)
        rgb = rng.integers(0, 256, (6, 7, 3)).astype(np.uint8)
        cls = rng.integers(0, 4, (6, 7)).astype(np.uint8)
        ids = rng.integers(-1, 20, (6, 7)).astype(np.int32)
        words = packing.pack_rgb_u32(torch.from_numpy(rgb))
        np.testing.assert_array_equal(words.numpy(),
                                      np.asarray(jpack.pack_rgb_u32(jnp.asarray(rgb))))
        np.testing.assert_array_equal(packing.unpack_rgb_u32(words).numpy(), rgb)
        cw = packing.pack_class_id(torch.from_numpy(cls), torch.from_numpy(ids))
        np.testing.assert_array_equal(
            cw.numpy(), np.asarray(jpack.pack_class_id(jnp.asarray(cls), jnp.asarray(ids))))
        u16 = packing.class_id_to_u16(torch.from_numpy(cls), torch.from_numpy(ids))
        np.testing.assert_array_equal(
            u16.numpy(), np.asarray(jpack.class_id_to_u16(jnp.asarray(cls), jnp.asarray(ids))))
        for back in (packing.unpack_class_id(cw), packing.u16_to_class_id(u16)):
            np.testing.assert_array_equal(back[0].numpy(), cls)
            np.testing.assert_array_equal(back[1].numpy(), ids)
            assert back[1].dtype == torch.int32


class TestPlanners:
    @pytest.mark.parametrize("seed,h,w", MAPS)
    @pytest.mark.parametrize("backend,kw", [("numpy", {}), ("native", {}),
                                            ("native", {"bidirectional": False}),
                                            ("native", {"signed_turns": True}), ("tpu", {})])
    def test_plan_from_height_matches_jax(self, backend, kw, seed, h, w):
        hm, balls = host_scene(seed, h, w)
        height = hm.astype(np.float16)  # what the host-planner step reads back
        ours, theirs = planner_cfgs(backend, **kw)
        got = api.plan_from_height(height, balls, ours)
        want = japi.plan_from_height(height, balls, theirs)
        if backend == "tpu":
            assert_paths_close(got, want)
        else:  # the same NumPy and the same C++ on the same f16 heights
            assert got.directions == want.directions and len(want.directions) > 5

    @pytest.mark.parametrize("backend", ["numpy", "native", "tpu"])
    def test_plan_matches_jax(self, backend):
        hm, balls = host_scene(6, 48, 64)
        conns = japi._connections_from_height(hm)
        pos = japi._pos_from_height(hm)
        ours, theirs = planner_cfgs(backend)
        scene = Scene(height=torch.from_numpy(hm), pos=torch.from_numpy(pos),
                      balls=torch.from_numpy(balls), connections=torch.from_numpy(conns))
        got = api.plan(scene, ours)
        want = japi.plan(JaxScene(height=hm, pos=pos, balls=balls, connections=conns), theirs)
        if backend == "tpu":
            assert_paths_close(got, want)
        else:
            assert got.directions == want.directions and len(want.directions) > 5

    def test_native_dijkstra_matches_jax_native(self):
        from tod_tpu.planner.native import dijkstra_native as jax_native
        from tod_tpu_torch.planner.native import dijkstra_native

        hm, balls = host_scene(7, 48, 64)
        conns = japi._connections_from_height(hm)
        seeds = jdij.seeds_from_balls(balls, 3, hm.shape, min_pixels=3.0)
        dist, parent = dijkstra_native(hm, conns, seeds)
        jd, jp = jax_native(hm, conns, seeds)
        np.testing.assert_array_equal(dist, jd)
        np.testing.assert_array_equal(parent, jp)
        # the NumPy version adds each float32 edge in float32, the C++ in double
        np.testing.assert_allclose(dist, dijkstra.dijkstra_grid(hm, conns, seeds)[0], rtol=1e-6)

    def test_no_seeds_is_an_empty_path(self):
        hm, balls = host_scene(8, 48, 64)
        balls[:, 2] = 0.0
        for backend in ("numpy", "native", "tpu"):
            assert api.plan_from_height(hm, balls, planner_cfgs(backend)[0]).directions == []

    def test_auto_resolves_as_jax_and_native_raises_without_its_library(self, monkeypatch):
        from tod_tpu.native import loader as jax_loader
        from tod_tpu_torch.native import loader

        assert api.host_backend("auto") == ("native" if jax_loader.available() else "numpy")
        assert api.host_backend("numpy") == "numpy"
        with pytest.raises(ValueError, match="unknown planner backend"):
            api.host_backend("gpu")
        hm, balls = host_scene(9, 48, 64)
        monkeypatch.setattr(loader, "_lib", lambda: None)
        assert api.host_backend("auto") == "numpy"
        want = api.plan_from_height(hm, balls, planner_cfgs("numpy")[0])
        got = api.plan_from_height(hm, balls, planner_cfgs("auto")[0])
        assert got.directions == want.directions
        with pytest.raises(RuntimeError, match="native planner"):
            api.plan_from_height(hm, balls, planner_cfgs("native")[0])

    def test_validate_rejects_an_unknown_backend(self):
        cfg = tcfg.PipelineConfig(planner=tcfg.PlannerConfig(backend="gpu"))
        assert any("planner.backend" in p for p in tcfg.validate(cfg))
        assert not tcfg.validate(tcfg.PipelineConfig())
        with pytest.raises(ValueError, match="planner.backend"):
            from tod_tpu_torch.runtime.engine import Engine

            Engine(cfg, params={}, device="cpu")

    def test_materialize_path_decodes_a_plan(self):
        plan = np.zeros((9, 2), np.float32)
        plan[0] = (3, 1)
        plan[1:4] = [(1.5, 0.0), (2.0, 0.5), (1.0, 3.0)]
        path = api.materialize_path(torch.from_numpy(plan))
        assert path.truncated and path.directions == [(1.5, 0.0), (2.0, 0.5), (1.0, 3.0)]
        assert japi.materialize_path(plan).directions == path.directions


CAM = dict(width=64, height=48)
MODEL = dict(input_size=(256, 320), dtype="float32")


@pytest.fixture(scope="module")
def flat_weights():
    from tod_tpu_torch.core.weights import read_tree

    return read_tree()


@pytest.fixture(scope="module")
def default_engines(flat_weights):
    """The JAX engine and the port's on the CPU, both with the default
    PlannerConfig(): ``auto``."""
    from tests.test_torch_pipeline import nest
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL)),
        nest(flat_weights), use_pallas=False,
    )
    port = Engine(
        tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL)),
        carry_across(flat_weights), device="cpu",
    )
    return jax_engine, port


class TestHostMode:
    def test_serve_step_packed_has_the_jax_layout(self, default_engines):
        """The host step's buffer is the port's own scene in the JAX
        package's bytes (f16 height, f32 balls), which the JAX package's
        decoder reads; the scene itself is held against JAX's in
        tests/test_torch_pipeline.py."""
        from tod_tpu_torch.ops.preprocess import pack_frame
        from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

        jax_engine, port = default_engines
        f = synth_frame_numpy(0, 2, CAM["height"], CAM["width"])
        packed = pack_frame(f.rgb, f.depth)
        want = np.asarray(jax_engine._serve_step_packed(jax_engine.params, jnp.asarray(packed)))
        got = port.serve_step_packed(torch.from_numpy(packed))
        assert got.dtype == torch.uint8 and got.shape == want.shape
        height, balls = port.serve_step_scene(torch.from_numpy(packed))
        h16, b32 = height.to(torch.float16).numpy(), balls.numpy()
        for decoded in (port._unpack_plan_buffer(got.numpy()),
                        jax_engine._unpack_plan_buffer(got.numpy())):
            np.testing.assert_array_equal(decoded[0], h16)
            np.testing.assert_array_equal(decoded[1], b32)
        np.testing.assert_array_equal(port.serve_step(f.rgb, f.depth).numpy(), got.numpy())
        scene, dets = port.process(f)
        h, w = port.cam_hw
        assert scene.connections.shape == (h, w, 8) and scene.pos.shape == (h, w, 3)
        np.testing.assert_array_equal(scene.height.numpy(), height.numpy())
        assert dets.class_map.shape == (h, w)

    def test_auto_plans_on_the_host_on_the_cpu_as_jax_does(self, default_engines):
        """D2: with the default config both engines are in the host-planner
        mode on the CPU, and ``run`` publishes the JAX engine's path."""
        from tod_tpu.runtime.frame_source import SyntheticSource as JaxSyntheticSource
        from tod_tpu.serve.server import PathStore as JaxPathStore
        from tod_tpu_torch.runtime.frame_source import SyntheticSource
        from tod_tpu_torch.serve.server import PathStore

        jax_engine, port = default_engines
        assert not jax_engine._plan_on_device_mode and not port._plan_on_device_mode
        run_kw = dict(n_frames=4, plan_every=2, max_inflight=2, sync_every=16)
        jstore, store = JaxPathStore(), PathStore()
        want = jax_engine.run(JaxSyntheticSource(jcfg.CameraConfig(**CAM), n_frames=4),
                              path_store=jstore, warmup=False, **run_kw)
        got = port.run(SyntheticSource(tcfg.CameraConfig(**CAM), n_frames=4),
                       path_store=store, **run_kw)
        assert set(port.warmup_breakdown) == {"serve_step_packed", "host_planner"}
        assert got["n_frames"] == want["n_frames"] == 4 and got["plans_done"] >= 1
        assert got["last_path_len"] == want["last_path_len"] > 5
        assert store.get().directions == [tuple(map(float, d)) for d in jstore.get().directions]
        assert port.last_sweeps is None  # nothing was relaxed on a device
