"""The port's closed-loop simulation (``tod_tpu_torch.sim``) against the JAX
package's ``sim`` on the CPU: the world, the renderer and the follower bit
for bit, every oracle case of ``tests/test_sim.py`` under its own
assertions with its first ticks against the JAX loop's, the model-perception
case on the carried ``checkpoints/yolact_synth``, the sim evaluation scenes,
and ``train.evaluate --sim`` / ``--report-domains``.

The closed loops plan with the native host planner (``PlannerConfig(
backend="native")``, the C++ Dijkstra built with g++ at first use): the
NumPy planner of ``tests/test_sim.py`` takes 1.4 s a tick at 320x240 on one
thread, the native one 11 ms.  The JAX loop runs on its own native planner,
the same C++ code, and the first 5 ticks' logs (pose, distance, command,
path length) agree exactly: the renderer is the same numpy, the oracle
fusion is exact (integral heights), and the tracker's bank agrees to the
last bit (``test_torch_track.py``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from tod_tpu_torch.core.config import CameraConfig, PlannerConfig, TrackerConfig
from tod_tpu_torch.sim import Ball, DirectionFollower, Obstacle, SimWorld, render
from tod_tpu_torch.sim.loop import run_closed_loop

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAM = CameraConfig(width=320, height=240)
PCFG = PlannerConfig(signed_turns=True, start_offset=CAM.width // 2, backend="native")
SMALL = CameraConfig(width=160, height=120)
SMALL_PCFG = dataclasses.replace(PCFG, start_offset=SMALL.width // 2)


def jax_world(world: SimWorld):
    from tod_tpu.sim import world as jw

    return jw.SimWorld(
        balls=[jw.Ball(**dataclasses.asdict(b)) for b in world.balls],
        obstacles=[jw.Obstacle(**dataclasses.asdict(o)) for o in world.obstacles],
        agent_xz=(world.x, world.z), heading=world.heading,
        cam_height_mm=world.cam_height_mm,
    )


def jax_cfg(cfg):
    """The JAX package's config dataclass of the same name and fields."""
    from tod_tpu.core import config as jcfg

    return getattr(jcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_render_is_bit_for_bit(self, seed):
        from tod_tpu.sim.camera import render as jax_render

        world = SimWorld(balls=[Ball(-600.0, 2400.0), Ball(500.0, 1800.0)],
                         obstacles=[Obstacle(0.0, 1500.0), Obstacle(-900.0, 3000.0, team="blue")],
                         heading=0.2)
        got = render(world, CAM, seed=seed, annotate=True)
        want = jax_render(jax_world(world), jax_cfg(CAM), seed=seed, annotate=True)
        np.testing.assert_array_equal(got[0].rgb, want[0].rgb)
        np.testing.assert_array_equal(got[0].depth, want[0].depth)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])

    def test_world_step_and_camera_frame_are_bit_for_bit(self):
        world = SimWorld(balls=[Ball(900.0, 2600.0, vx=-120.0)], obstacles=[Obstacle(1.0, 2.0)])
        jw = jax_world(world)
        for turn, adv in ((0.3, 400.0), (-0.7, 120.0), (0.0, 0.0), (1.1, 333.3)):
            world.step(turn, adv)
            jw.step(turn, adv)
            assert (world.x, world.z, world.heading) == (jw.x, jw.z, jw.heading)
            assert world.to_camera(300.0, 900.0) == jw.to_camera(300.0, 900.0)
            assert world.ball_distance() == jw.ball_distance()
            assert world.obstacle_clearance() == jw.obstacle_clearance()
        assert world.trail == jw.trail

    def test_follower_commands_are_bit_for_bit(self):
        from tod_tpu.core.types import Path as JaxPath
        from tod_tpu.sim.controller import DirectionFollower as JaxFollower
        from tod_tpu_torch.core.types import Path

        f = DirectionFollower(CAM, PCFG, blind_ticks=2)
        jf = JaxFollower(jax_cfg(CAM), jax_cfg(PCFG), blind_ticks=2)
        paths = [[(5.0, 0.1), (5.0, 0.0), (7.0, -0.4)], [], [(3.0, 1.2)] * 20, [], [], [],
                 [(40.0, -0.3)]]
        for dirs in paths:
            assert f.command(Path(created=0.0, directions=dirs)) == jf.command(
                JaxPath(created=0.0, directions=dirs))


# --- the oracle closed loops (tests/test_sim.py's cases) ---------------------

def _reaches_offset_ball():
    return dict(world=SimWorld(balls=[Ball(-700.0, 2400.0)]), cam=CAM, pcfg=PCFG, ticks=20)


def _avoids_obstacle():
    return dict(world=SimWorld(balls=[Ball(0.0, 3000.0)], obstacles=[Obstacle(-500.0, 1600.0)]),
                cam=CAM, pcfg=PCFG, ticks=50)


def _rolling_ball():
    return dict(world=SimWorld(balls=[Ball(900.0, 2600.0, vx=-120.0)]), cam=CAM, pcfg=PCFG,
                ticks=35)


def _multi_ball():
    return dict(world=SimWorld(balls=[Ball(500.0, 2000.0), Ball(-900.0, 3600.0)]), cam=CAM,
                pcfg=PCFG, ticks=20)


def _occluded():
    return dict(world=SimWorld(balls=[Ball(0.0, 3000.0)], obstacles=[Obstacle(-50.0, 1500.0)]),
                cam=CAM, pcfg=PCFG, ticks=12)


def _tracked(tracker):
    return dict(world=SimWorld(balls=[Ball(-900.0, 3000.0, vx=130.0)]), cam=SMALL,
                pcfg=SMALL_PCFG, ticks=40, tracker=tracker, measurement_blackout=(2, 8))


CASES = {
    "offset_ball": _reaches_offset_ball,
    "obstacle": _avoids_obstacle,
    "rolling_ball": _rolling_ball,
    "multi_ball": _multi_ball,
    "occluded": _occluded,
    "tracked": lambda: _tracked(TrackerConfig(enabled=True, max_misses=12)),
    "untracked": lambda: _tracked(None),
}


def run_case(name: str, ticks: int | None = None, jax: bool = False) -> dict:
    kw = CASES[name]()
    world, cam = kw.pop("world"), kw.pop("cam")
    if ticks is not None:
        kw["ticks"] = ticks
    if not jax:
        return run_closed_loop(world, cam, device="cpu", **kw)
    from tod_tpu.sim.loop import run_closed_loop as jax_loop

    kw["pcfg"] = jax_cfg(kw["pcfg"])
    if kw.get("tracker") is not None:
        kw["tracker"] = jax_cfg(kw["tracker"])
    return jax_loop(jax_world(world), jax_cfg(cam), **kw)


@pytest.fixture(scope="module")
def runs():
    cache: dict = {}

    def get(name: str) -> dict:
        if name not in cache:
            cache[name] = run_case(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_first_ticks_match_jax(name):
    got = run_case(name, ticks=5)["log"]
    want = run_case(name, ticks=5, jax=True)["log"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


class TestClosedLoop:
    def test_reaches_offset_ball_oracle_perception(self, runs):
        m = runs("offset_ball")
        assert m["reached"], m
        assert m["ticks_used"] <= 15, m
        assert m["final_ball_mm"] <= 300.0

    def test_avoids_obstacle_and_reaches(self, runs):
        m = runs("obstacle")
        assert m["reached"], m
        assert m["min_obstacle_clearance_mm"] > 0.0, m

    def test_intercepts_rolling_ball(self, runs):
        m = runs("rolling_ball")
        assert m["reached"], m
        assert m["final_ball_mm"] <= 300.0

    def test_multi_ball_reaches_a_ball(self, runs):
        m = runs("multi_ball")
        assert m["reached"], m
        assert m["final_ball_mm"] <= 300.0

    def test_tracker_coasts_through_detector_blackout(self, runs):
        tracked, untracked = runs("tracked"), runs("untracked")
        assert tracked["reached"], tracked
        assert untracked["reached"]
        assert tracked["ticks_used"] < untracked["ticks_used"], (
            tracked["ticks_used"], untracked["ticks_used"])
        t_dirs = [r.n_dirs for r in tracked["log"]]
        u_dirs = [r.n_dirs for r in untracked["log"]]
        assert t_dirs[2] > 0 and t_dirs[3] > 0, t_dirs
        assert u_dirs[2] == 0, u_dirs

    def test_occluded_ball_is_not_hallucinated(self, runs):
        m = runs("occluded")
        assert not m["reached"]
        assert m["log"][-1].x == 0.0 and m["log"][-1].z == 0.0  # searched in place
        assert m["min_obstacle_clearance_mm"] > 1000.0

    def test_trail_dump_artifact(self, tmp_path):
        from tod_tpu_torch.sim.loop import dump_run
        from tod_tpu_torch.utils.image_io import load_image

        world = SimWorld(balls=[Ball(-700.0, 2400.0)], obstacles=[Obstacle(500.0, 1200.0)])
        run_closed_loop(world, CAM, pcfg=PCFG, ticks=4, device="cpu")
        img = load_image(dump_run(world, str(tmp_path)))
        assert img.ndim == 3 and img.shape[0] > 32 and img.shape[1] > 32
        for color in ((230, 200, 30), (220, 60, 60), (40, 150, 60)):
            assert (img == np.array(color, np.uint8)).all(-1).any(), color

    def test_obstacle_memory_holds_a_missed_robot(self):
        """The oracle loop's obstacle memory (``robot_occupancy`` on the
        device, decayed and shifted on the host) against the JAX loop's
        over a blackout of the robot class."""
        kw = dict(pcfg=SMALL_PCFG, ticks=5, obstacle_blackout=(2, 4), obstacle_memory=0.8)
        world = SimWorld(balls=[Ball(0.0, 3000.0)], obstacles=[Obstacle(-400.0, 1600.0)])
        from tod_tpu.sim.loop import run_closed_loop as jax_loop

        want = jax_loop(jax_world(world), jax_cfg(SMALL), **{**kw, "pcfg": jax_cfg(SMALL_PCFG)})
        got = run_closed_loop(world, SMALL, device="cpu", **kw)
        assert [dataclasses.asdict(r) for r in got["log"]] == [
            dataclasses.asdict(r) for r in want["log"]]

    def test_cli_reaches_the_default_ball(self, capsys):
        from tod_tpu_torch.sim.loop import main

        assert main(["--ticks", "20", "--width", "160", "--height", "120"], device="cpu") == 0
        assert "REACHED" in capsys.readouterr().out


def test_reaches_ball_through_full_model_perception():
    """Rendered frames -> the port's Engine (YOLACT, detect, fusion) on the
    carried ``checkpoints/yolact_synth`` -> plan -> follower: the robot
    reaches the ball."""
    ckpt = ROOT / "checkpoints" / "yolact_synth"
    if not ckpt.exists():
        pytest.skip("checkpoints/yolact_synth is not present")
    import jax

    from tod_tpu.train.checkpoint import load_checkpoint
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.models.yolact import Yolact
    from tod_tpu_torch.runtime.engine import Engine

    tree = {"/".join(str(k.key) for k in p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_leaves_with_path(load_checkpoint(str(ckpt), fast=False))}
    mcfg = ModelConfig(input_size=(240, 320))
    engine = Engine(PipelineConfig(camera=CAM, model=mcfg, planner=PCFG),
                    carry_across(tree, Yolact(mcfg)), mode="detect", device="cpu")
    m = run_closed_loop(SimWorld(balls=[Ball(-700.0, 2400.0)]), CAM, pcfg=PCFG, engine=engine,
                        perception="model", ticks=15)
    assert m["reached"], m
    assert m["final_ball_mm"] <= 300.0


def test_model_perception_needs_an_engine():
    with pytest.raises(ValueError, match="needs an Engine"):
        run_closed_loop(SimWorld(), CAM, perception="model")


# --- the sim evaluation ----------------------------------------------------

def test_sim_eval_scenes_equal_jax():
    from tod_tpu.train.evaluate import sim_eval_scenes as jax_scenes
    from tod_tpu_torch.train.evaluate import sim_eval_scenes

    got = list(sim_eval_scenes((96, 128), 4, seed=2))
    want = list(jax_scenes((96, 128), 4, seed=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert any(s[3].any() for s in got)  # objects were labelled


def test_tiny_engines_score_sim_scenes():
    """``evaluate_engines`` on TINY engines over the sim scenes: the
    report's keys, and the scenes' objects counted as ground truth."""
    from tod_tpu_torch.bench.configs import model_state
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.train import evaluate

    mcfg = ModelConfig(input_size=(48, 64), fpn_channels=16, proto_channels=16,
                       head_channels=16, width_mult=0.35, num_prototypes=8, dtype="float32")
    eng, eng_sem = evaluate.make_eval_engines((48, 64), mcfg, params=model_state(mcfg),
                                              device="cpu")
    out = evaluate.evaluate_engines(eng, eng_sem, hw=(48, 64),
                                    scenes=evaluate.sim_eval_scenes((48, 64), 3, seed=1))
    assert out["n_scenes"] == 3
    assert set(out["ap50_per_class"]) == set(out["sem_iou"]) == {1, 2, 3}
    assert out["sem_iou"][3] is not None  # the scenes' balls are ground truth


@pytest.mark.parametrize("flag", ["--sim", "--report-domains"])
def test_evaluate_cli_scores_sim_scenes(flag, capsys):
    from tod_tpu_torch.core.weights import PINNED
    from tod_tpu_torch.train.evaluate import main

    rc = main(["--ckpt", str(PINNED), "--scenes", "2", "--hw", "48x64", flag], device="cpu")
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if flag == "--sim":
        assert out["data"] == "sim" and out["n_scenes"] == 2
    else:
        assert out["sim_cross_domain"]["n_scenes"] == 2
        assert out["procedural_held_out"]["n_scenes"] == 2
        assert "map50" in out["sim_cross_domain"]


def test_real_fixtures_are_scored_only_with_their_images(tmp_path):
    from tod_tpu_torch.train.evaluate import fixture_images_present

    (tmp_path / "annotations.json").write_text(json.dumps({"images": [{"file": "a.png"}]}))
    assert not fixture_images_present(tmp_path)
    (tmp_path / "a.png").write_bytes(b"")
    assert fixture_images_present(tmp_path)
    assert not fixture_images_present(tmp_path / "missing")
