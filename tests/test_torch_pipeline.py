"""The port's serving path against the JAX package on the CPU, stage by
stage and whole: preprocess, anchors, Fast-NMS, detection cleanup, scene
fusion, the device planner, ``serve_step_plan``, the path server, and the
port's independence from JAX."""

from __future__ import annotations

import pathlib
import socket
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core import config as jcfg
from tod_tpu.core.types import Path as JaxPath
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.core.types import Path

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# A camera small enough for the CPU, with the model at its trained 256x320
# input (the frame is upsampled) so the synthetic balls are detected, and the
# robot's start column in the middle of the 160-wide map.
CAM = dict(width=160, height=120)
MODEL = dict(input_size=(256, 320), dtype="float32")
PLANNER = dict(start_offset=80)


def nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        d = out
        *parts, last = key.split("/")
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def frame(t: int, h: int = 120, w: int = 160):
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    return synth_frame_numpy(0, t, h, w)


@pytest.fixture(scope="module")
def flat_weights():
    from tod_tpu_torch.core.weights import read_tree

    return read_tree()


@pytest.fixture(scope="module")
def engines(flat_weights):
    """(JAX engine, port engine) on the same pinned weights."""
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    jax_engine = JaxEngine(
        jcfg.PipelineConfig(
            camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
            planner=jcfg.PlannerConfig(**PLANNER),
        ),
        nest(flat_weights), use_pallas=False,
    )
    port = Engine(
        tcfg.PipelineConfig(
            camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
            planner=tcfg.PlannerConfig(**PLANNER),
        ),
        carry_across(flat_weights), device="cpu",
    )
    return jax_engine, port


@pytest.fixture(scope="module")
def head_outputs(engines):
    """The JAX model's head outputs for two synthetic frames (numpy)."""
    from tod_tpu.ops.preprocess import preprocess_frame

    jax_engine, _ = engines
    outs = []
    for t in (0, 9):
        x = preprocess_frame(jnp.asarray(frame(t).rgb), MODEL["input_size"], jnp.float32)
        out = jax_engine.model.apply(jax_engine.params, x, train=False)
        # copies: torch must not share memory with JAX's buffers
        outs.append({k: np.array(getattr(out, k)) for k in
                     ("loc", "conf", "coeff", "prototypes", "sem_logits")})
    return outs


class TestPreprocess:
    def test_unpack_matches_bitcast(self):
        from tod_tpu_torch.ops.preprocess import pack_frame, unpack_frame

        f = frame(3)
        packed = pack_frame(f.rgb, f.depth)
        assert packed.dtype == np.uint8 and packed.size == 120 * 160 * 5
        rgb, depth = unpack_frame(torch.from_numpy(packed), (120, 160))
        n_rgb = 120 * 160 * 3
        want_depth = jax.lax.bitcast_convert_type(
            jnp.asarray(packed[n_rgb:]).reshape(120, 160, 2), jnp.uint16
        )
        np.testing.assert_array_equal(rgb.numpy(), f.rgb)
        np.testing.assert_array_equal(depth.numpy(), np.asarray(want_depth))
        np.testing.assert_array_equal(depth.numpy(), f.depth)

    @pytest.mark.parametrize("src_hw,out_hw", [((480, 640), (256, 320)), ((120, 160), (256, 320))])
    def test_resize_triangle_matches_jax(self, src_hw, out_hw):
        from tod_tpu.ops.preprocess import resize_triangle as jax_resize
        from tod_tpu_torch.ops.preprocess import resize_triangle

        img = np.random.default_rng(0).integers(0, 256, (*src_hw, 3)).astype(np.uint8)
        got = resize_triangle(torch.from_numpy(img), out_hw).numpy()
        want = np.asarray(jax_resize(jnp.asarray(img), out_hw))
        # separable tent weights summed in another order, on [0, 255] data
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    def test_normalize_and_nearest_upscale_match_jax(self):
        from tod_tpu.ops.preprocess import normalize as jax_normalize
        from tod_tpu.ops.preprocess import upscale_to_frame as jax_upscale
        from tod_tpu_torch.ops.preprocess import normalize, upscale_to_frame

        x = np.random.default_rng(1).uniform(0, 255, (8, 9, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            normalize(torch.from_numpy(x), torch.float32).numpy(),
            np.asarray(jax_normalize(jnp.asarray(x), jnp.float32)),
        )
        cls = np.random.default_rng(2).integers(0, 4, (30, 40)).astype(np.uint8)
        np.testing.assert_array_equal(
            upscale_to_frame(torch.from_numpy(cls), (120, 160)).numpy(),
            np.asarray(jax_upscale(jnp.asarray(cls), (120, 160))),
        )


class TestAnchorsAndNms:
    @pytest.mark.parametrize("input_size", [(256, 320), (72, 88)])
    def test_anchors_equal(self, input_size):
        from tod_tpu.ops.anchors import generate_anchors as jax_anchors
        from tod_tpu_torch.ops.anchors import generate_anchors

        np.testing.assert_array_equal(
            generate_anchors(tcfg.ModelConfig(input_size=input_size)),
            jax_anchors(jcfg.ModelConfig(input_size=input_size)),
        )

    def test_fast_nms_matches_on_valid_slots(self):
        from tod_tpu.ops.nms import fast_nms as jax_nms
        from tod_tpu_torch.ops.nms import fast_nms

        rng = np.random.default_rng(3)
        c = rng.uniform(0, 1, (500, 2))
        s = rng.uniform(0.02, 0.2, (500, 2))
        boxes = np.concatenate([c - s / 2, c + s / 2], axis=-1).astype(np.float32)
        scores = rng.dirichlet(np.ones(4) * 0.3, 500).astype(np.float32)
        got = fast_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 64, 32, 0.3)
        want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 64, 32, 0.3)
        valid = np.asarray(want[4])
        assert valid.sum() > 5
        np.testing.assert_array_equal(got[4].numpy(), valid)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g.numpy()[valid], np.asarray(w)[valid])


class TestDetect:
    @pytest.mark.parametrize("idx", [0, 1])
    def test_detect_matches_jax(self, engines, head_outputs, idx):
        """Same head outputs into both cleanups.  Compared on the valid slots
        only: the final top-k meets many 0.0 scores, whose order is free."""
        from tod_tpu.models.yolact import YolactOutputs as JaxOutputs
        from tod_tpu.models.yolact import detect as jax_detect
        from tod_tpu_torch.models.yolact import YolactOutputs, detect

        jax_engine, port = engines
        out = head_outputs[idx]
        hw = (CAM["height"], CAM["width"])
        want = jax_detect(JaxOutputs(**{k: jnp.asarray(v) for k, v in out.items()}),
                          jax_engine.cfg.model, jax_engine.anchors, out_hw=hw, use_pallas=True)
        got = detect(YolactOutputs(**{k: torch.from_numpy(v) for k, v in out.items()}),
                     port.cfg.model, port.anchors, out_hw=hw)
        valid = np.asarray(want.valid)
        assert valid.sum() >= 3  # balls and robots are found
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(want.classes)[valid])
        # boxes: SSD decode, where compiled JAX fuses multiply-adds
        np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                                   atol=1e-6, rtol=0)
        # masks: the Pallas kernel in interpret mode vs the plain version
        np.testing.assert_allclose(got.masks.numpy()[valid], np.asarray(want.masks)[valid],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got.class_map.numpy(), np.asarray(want.class_map))
        np.testing.assert_array_equal(got.id_map.numpy(), np.asarray(want.id_map))


class TestFusion:
    @pytest.mark.parametrize("t", [0, 9])
    def test_fuse_scene_matches_jax(self, engines, t):
        """Heights are integral: exact.  The class/id maps come from the JAX
        detection of a synthetic frame (balls, robots, terrain)."""
        from tod_tpu.geometry.fusion import fuse_scene as jax_fuse
        from tod_tpu_torch.geometry.fusion import fuse_scene

        jax_engine, _ = engines
        f = frame(t)
        _, dets = jax_engine._step(jax_engine.params, jnp.asarray(f.rgb), jnp.asarray(f.depth))
        cls, ids = np.array(dets.class_map), np.array(dets.id_map)
        assert {1, 2, 3} <= set(np.unique(cls))
        cam, geom = tcfg.CameraConfig(**CAM), tcfg.GeometryConfig()
        want = jax_fuse(jnp.asarray(f.depth), jnp.asarray(cls), jnp.asarray(ids),
                        jcfg.CameraConfig(**CAM), jcfg.GeometryConfig())
        got = fuse_scene(torch.from_numpy(f.depth.astype(np.int32)), torch.from_numpy(cls),
                         torch.from_numpy(ids), cam, geom)
        np.testing.assert_array_equal(got.height.numpy(), np.asarray(want.height))
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        np.testing.assert_array_equal(got.connections.numpy(), np.asarray(want.connections))
        # ball means of integral coordinates; sums are exact below 2^24
        np.testing.assert_allclose(got.balls.numpy(), np.asarray(want.balls), rtol=1e-6)

    @pytest.mark.parametrize("L", [3, 10])
    def test_dilate_peaks_matches_jax(self, L):
        from tod_tpu.geometry.fusion import _dilate_peaks as jax_dilate
        from tod_tpu_torch.kernels.bump import plain_dilate_peaks

        rng = np.random.default_rng(L)
        h, w = 40, 56
        ext = np.zeros((h + 2 * L, w + 2 * L), np.float32)
        m = rng.random(ext.shape) < 0.05
        ext[m] = rng.integers(1, h, m.sum())  # terrain peaks are image rows
        want = np.asarray(jax.jit(jax_dilate, static_argnums=(1, 2, 3))(jnp.asarray(ext), L, 0.1, (h, w)))
        got = plain_dilate_peaks(torch.from_numpy(ext), L, 0.1, (h, w)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_robot_occupancy_matches_jax(self):
        from tod_tpu.geometry.fusion import robot_occupancy as jax_robots
        from tod_tpu_torch.geometry.fusion import robot_occupancy

        rng = np.random.default_rng(5)
        depth = rng.integers(200, 3500, (48, 64)).astype(np.uint16)
        cls = np.zeros((48, 64), np.uint8)
        cls[10:14, 8:14] = 1
        cls[30:33, 40:50] = 2
        want = jax.jit(jax_robots, static_argnums=(2, 3))(
            jnp.asarray(depth), jnp.asarray(cls), jcfg.CameraConfig(height=48, width=64),
            jcfg.GeometryConfig(),
        )
        got = robot_occupancy(torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(cls),
                              tcfg.CameraConfig(height=48, width=64), tcfg.GeometryConfig())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def planner_scene():
    """The height map and balls of tests/test_planner.py's device-plan case."""
    rng = np.random.default_rng(3)
    hm = np.cumsum(rng.normal(0, 0.3, (48, 64)), axis=0).astype(np.float32)
    hm -= hm.min()
    balls = np.zeros((16, 4), np.float32)
    balls[0] = [50.0, 8.0, 40.0, 0.0]
    balls[1] = [10.0, 30.0, 25.0, 0.0]
    return hm, balls


def assert_plans_close(got: np.ndarray, want: np.ndarray) -> None:
    """The device planner's tolerances in tests/test_planner.py: total
    magnitude to rel 1e-4, each hop to 1e-3, each rotation to 1e-4."""
    n = int(want[0, 0])
    assert int(got[0, 0]) == n and got[0, 1] == want[0, 1]
    assert got[1 + n :].any() == want[1 + n :].any() == False  # noqa: E712
    assert got[1 : 1 + n, 0].sum() == pytest.approx(want[1 : 1 + n, 0].sum(), rel=1e-4)
    np.testing.assert_allclose(got[1 : 1 + n, 0], want[1 : 1 + n, 0], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[1 : 1 + n, 1], want[1 : 1 + n, 1], atol=1e-4, rtol=0)


class TestPlanner:
    @pytest.mark.parametrize("signed", [False, True])
    def test_plan_on_device_matches_jax(self, signed):
        from tod_tpu.planner.tpu_relax import plan_on_device as jax_plan
        from tod_tpu_torch.planner.relax import plan_on_device, start_node_yx

        hm, balls = planner_scene()
        start = start_node_yx(hm.shape, 240)
        want = np.asarray(jax_plan(jnp.asarray(hm), jnp.asarray(balls), start,
                                   max_steps=256, signed=signed))
        got, sweeps = plan_on_device(torch.from_numpy(hm), torch.from_numpy(balls), start,
                                     max_steps=256, signed=signed)
        assert int(want[0, 0]) > 5 and 0 < sweeps < 2048
        assert_plans_close(got.numpy(), want)

    def test_truncated_plan_matches_jax(self):
        from tod_tpu.planner.tpu_relax import plan_on_device as jax_plan
        from tod_tpu_torch.planner.relax import plan_on_device, start_node_yx

        hm, balls = planner_scene()
        start = start_node_yx(hm.shape, 240)
        want = np.asarray(jax_plan(jnp.asarray(hm), jnp.asarray(balls), start, max_steps=6))
        got, _ = plan_on_device(torch.from_numpy(hm), torch.from_numpy(balls), start, max_steps=6)
        assert want[0, 1] == 1.0  # the walk ran out of steps mid-path
        assert_plans_close(got.numpy(), want)

    def test_no_balls_is_empty(self):
        from tod_tpu_torch.planner.relax import plan_on_device

        plan, _ = plan_on_device(torch.zeros(32, 32), torch.zeros(8, 4), (31, 16))
        assert not plan.any()

    def test_bellman_ford_distances_and_sweep_count(self):
        """Distances as the JAX loop's; ``sweeps`` is the sweep count of that
        loop: one sweep fewer leaves some distance unsettled."""
        from tod_tpu.planner.tpu_relax import bellman_ford_grid as jax_bf
        from tod_tpu_torch.kernels.connections import connection_weights
        from tod_tpu_torch.planner.relax import bellman_ford_grid

        hm, _ = planner_scene()
        seeds = np.zeros(hm.shape, bool)
        seeds[8, 50] = seeds[30, 10] = True
        _, conns = connection_weights(torch.from_numpy(hm))
        dist, nxt, sweeps = bellman_ford_grid(torch.from_numpy(hm), conns, torch.from_numpy(seeds))
        jd, jn = jax_bf(jnp.asarray(hm), jnp.array(conns.numpy()), jnp.asarray(seeds))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
        short, _, ran = bellman_ford_grid(torch.from_numpy(hm), conns, torch.from_numpy(seeds),
                                          max_iters=sweeps - 2)
        assert ran == sweeps - 2 and not torch.equal(short, dist)
        again, _, ran = bellman_ford_grid(torch.from_numpy(hm), conns, torch.from_numpy(seeds),
                                          max_iters=sweeps - 1)
        assert ran == sweeps - 1 and torch.equal(again, dist)


class TestServeStepPlan:
    @pytest.mark.parametrize("t", [0, 7])
    def test_matches_jax_serve_step_plan(self, engines, t):
        from tod_tpu_torch.ops.preprocess import pack_frame

        jax_engine, port = engines
        f = frame(t)
        packed = pack_frame(f.rgb, f.depth)
        want = np.asarray(jax_engine._serve_step_plan_fn(jax_engine.params, jnp.asarray(packed)))
        got = port.serve_step_plan(torch.from_numpy(packed))
        assert got.shape == (port.cfg.planner.max_path_steps + 1, 2)
        assert int(want[0, 0]) > 5 and port.last_sweeps > 0
        assert_plans_close(got.numpy(), want)
        # the port's Path decodes the buffer as the JAX package's does
        jp = JaxPath.deserialize(Path.from_plan(got.numpy()).serialize())
        assert len(jp.directions) == int(want[0, 0])

    def test_plan_artifact_matches_jax_serve_step_plan(self, engines, tmp_path):
        """The port engine's ``plan`` step frozen (``tod_tpu_torch.deploy``),
        saved and loaded, against the JAX engine's plans, as the eager step
        is held above."""
        from tod_tpu_torch import deploy
        from tod_tpu_torch.ops.preprocess import pack_frame

        jax_engine, port = engines
        exported, meta = deploy.export_engine(port, "plan")
        deploy.save_artifact(exported, meta, str(tmp_path / "plan.todx"))
        art = deploy.ServingArtifact.load(str(tmp_path / "plan.todx"), device="cpu")
        for t in (0, 7):
            f = frame(t)
            packed = pack_frame(f.rgb, f.depth)
            want = np.asarray(jax_engine._serve_step_plan_fn(jax_engine.params,
                                                             jnp.asarray(packed)))
            assert int(want[0, 0]) > 5
            assert_plans_close(art.call(torch.from_numpy(packed)).numpy(), want)

    def test_serve_step_scene_matches_jax(self, engines):
        from tod_tpu_torch.ops.preprocess import pack_frame

        jax_engine, port = engines
        f = frame(4)
        packed = pack_frame(f.rgb, f.depth)
        jh, jb = jax_engine._serve_step_scene(jax_engine.params, jnp.asarray(packed))
        height, balls = port.serve_step_scene(torch.from_numpy(packed))
        np.testing.assert_array_equal(height.numpy(), np.asarray(jh))
        np.testing.assert_allclose(balls.numpy(), np.asarray(jb), rtol=1e-6)

    def test_engine_refuses_cuda_without_a_card(self):
        from tod_tpu_torch.core.device import resolve_device

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        assert resolve_device("cpu").type == "cpu"


class TestServer:
    def test_getpath_and_newpath_round_trip(self):
        from tod_tpu_torch.core.config import ServerConfig
        from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

        store = PathStore()
        store.set(Path(created=1234.0, directions=[(1.5, 0.25), (2.0, -1.0)]))
        thread, server = run_in_thread(store, ServerConfig(port=0))
        try:
            with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
                s.sendall(b"GetPath")
                data = b""
                while len(data) < 24:
                    data += s.recv(64)
                s.sendall(b"NewPath")
                assert s.recv(2) == b"OK"
        finally:
            stop_thread_server(server)
            thread.join(timeout=10)
        assert not thread.is_alive()
        got = JaxPath.deserialize(data)
        assert got.created == 1234.0 and got.directions == [(1.5, 0.25), (2.0, -1.0)]
        assert store.get().directions == []


ISOLATED = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "msgpack", "optax", "orbax", "PIL", "tod_tpu"):
    sys.modules[name] = None
import torch
import tod_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(tod_tpu_torch.__path__, "tod_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import tod_tpu_torch.app, tod_tpu_torch.kernels.bump, tod_tpu_torch.ops.quantize
import tod_tpu_torch.deploy, tod_tpu_torch.runtime.artifact_engine
from tod_tpu_torch.core import config
from tod_tpu_torch.core.weights import load_pinned
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.engine import Engine
from tod_tpu_torch.runtime.frame_source import synth_frame_numpy
cfg = config.PipelineConfig(
    camera=config.CameraConfig(width=160, height=120),
    model=config.ModelConfig(dtype="float32"),
    planner=config.PlannerConfig(start_offset=80),
)
eng = Engine(cfg, load_pinned(), device="cpu")
f = synth_frame_numpy(0, 0, 120, 160)
plan = eng.serve_step_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)))
rc = tod_tpu_torch.app.main(["--frames", "2", "--width", "64", "--height", "48",
                             "--no-server"], device="cpu")
sem = Engine(cfg, load_pinned(), device="cpu", mode="semantic")
sem_plan = sem.serve_step_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)))
_, dets = sem.process(f)
import os, tempfile
from tod_tpu_torch.utils.image_io import save_rgb
png = os.path.join(tempfile.mkdtemp(), "scene.png")
save_rgb(png, synth_frame_numpy(0, 5, 224, 224).rgb)
rc_png = tod_tpu_torch.app.main(["--source", "png", "--image", png, "--mode", "semantic",
                                 "--frames", "2", "--width", "64", "--height", "48",
                                 "--no-server"], device="cpu")
from tod_tpu_torch.train import SyntheticDetectionData, Trainer
tiny = config.ModelConfig(input_size=(48, 64), fpn_channels=16, proto_channels=16,
                          head_channels=16, width_mult=0.35, num_prototypes=8)
tcfg = config.TrainConfig(batch_size=2, warmup_steps=1, total_steps=4)
tr = Trainer(tiny, tcfg, device="cpu")
last = tr.train(SyntheticDetectionData((48, 64), batch_size=2, seed=0), steps=2,
                log_fn=lambda *_: None)
ckpt = tempfile.mkdtemp()
tr.save_state(os.path.join(ckpt, "state.pt"))
tr.save(os.path.join(ckpt, "trained.npz"))
back = Trainer(tiny, tcfg, device="cpu")
back.load_state(os.path.join(ckpt, "state.pt"))
same = all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                             back.model.state_dict().values()))
back.load(os.path.join(ckpt, "trained.npz"))
trained = int(back.step == 2 and same and last["loss"] > 0)
import tod_tpu_torch.parallel
from tod_tpu_torch.sim import Ball, SimWorld, run_closed_loop
ticked = run_closed_loop(SimWorld(balls=[Ball(-700.0, 2400.0)]),
                         config.CameraConfig(width=160, height=120), ticks=1,
                         device="cpu")["log"][0].n_dirs
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "tod_tpu", "PIL")
                and sys.modules[m] is not None)
bench = sorted(m for m in mods if m.startswith("tod_tpu_torch.bench"))
print(len(mods), int(plan[0, 0]), int(sem_plan[0, 0]), int(dets.id_map.max()), rc, rc_png,
      trained, ticked, ",".join(bench), loaded)
"""


def test_port_runs_without_jax():
    """The card's machine has no jax, flax, msgpack, optax, orbax or PIL:
    import every port module (the bench's and the trainer's among them) with
    those blocked, load the pinned weights, serve one frame in each mode
    (the semantic one with its balls) and run the app for two frames, then
    in semantic mode on a PNG that the port's own writer made; then train
    TINY for 2 steps, save its full state and serving tree and resume them
    in a fresh trainer; then import ``parallel`` and ``sim`` and run one
    oracle closed-loop tick, which plans a path to the ball."""
    out = subprocess.run(
        [sys.executable, "-c", ISOLATED], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    n_mods, n_valid, n_sem, max_id, rc, rc_png, trained, ticked, bench, loaded = (
        out.stdout.split(maxsplit=9))
    assert int(n_mods) >= 72 and int(n_valid) > 5 and int(n_sem) > 5 and int(max_id) >= 0
    assert int(rc_png) == 0 and int(trained) == 1 and int(ticked) > 0
    assert bench.split(",") == [f"tod_tpu_torch.bench{m}" for m in (
        "", ".__main__", ".boot", ".configs", ".headline", ".mfu", ".profiling")]
    assert int(rc) == 0
    assert loaded.strip() == "[]"
