"""``ArtifactEngine``, ``app --todx`` and the semantic and int8 artifacts on
the CPU, at the pipeline tests' 160x120 camera (the model at 256x320 f32)
on the pinned weights: the semantic and ``--int8`` ``plan`` artifacts equal
their eager engines bit for bit in a process that cannot import the model
code; the track bank served by ``ArtifactEngine.run`` over 8 frames at
``plan_every = 4`` equals the eager tracked engine's exactly; a
``track_plan`` artifact serves with ``plan_paths=False``; the app serves an
artifact and refuses the flags the artifact fixes; and the card's kernel
limits refuse a configuration up front (ROADMAP.md D, D5) while the CPU
serves it."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_deploy import CAM, LOADER, ROOT, hold_against_eager, pipeline
from tod_tpu_torch import deploy
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.runtime.artifact_engine import ArtifactEngine, pipeline_config_from_meta
from tod_tpu_torch.runtime.engine import Engine
from tod_tpu_torch.runtime.frame_source import SyntheticSource

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

FRAMES = (4,)
# name -> (engine, artifact mode)
ARTIFACTS = {
    "semantic_plan": ("semantic", "plan"),
    "int8_plan": ("int8", "plan"),
    "track_plan": ("tracked", "track_plan"),
}


@pytest.fixture(scope="module")
def engines():
    from tod_tpu_torch.core.weights import load_pinned

    state = load_pinned()
    return {
        "semantic": Engine(pipeline(), state, device="cpu", mode="semantic"),
        "int8": Engine(pipeline(quantized=True), state, device="cpu"),
        "tracked": Engine(pipeline(tracker=tcfg.TrackerConfig(enabled=True)), state,
                          device="cpu"),
    }


@pytest.fixture(scope="module")
def artifacts(engines, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for name, (eng, mode) in ARTIFACTS.items():
        exported, meta = deploy.export_engine(engines[eng], mode)
        paths[name] = str(out / f"{name}.todx")
        deploy.save_artifact(exported, meta, paths[name])
    return paths


# LOADER (the semantic and int8 artifacts' outputs, with the model code
# blocked), then the app on the semantic artifact for 4 frames in the same
# process: an interpreter's start and torch's import are a share of the
# file's time
ELSEWHERE = LOADER + r"""
import tod_tpu_torch.app
rc = tod_tpu_torch.app.main(["--todx", sys.argv[4], "--frames", "4", "--plan-every", "2",
                             "--no-server", "--metrics-json"], device="cpu")
print(json.dumps(sorted(m for m in sys.modules if m.startswith("tod_tpu_torch.models")
                        and sys.modules[m] is not None)))
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def elsewhere(artifacts, tmp_path_factory):
    """(outputs by ``name/frame/index``, the stdout lines, the stderr) of
    ``ELSEWHERE``."""
    out = tmp_path_factory.mktemp("elsewhere") / "out.npz"
    paths = {name: artifacts[name] for name in ("semantic_plan", "int8_plan")}
    r = subprocess.run([sys.executable, "-c", ELSEWHERE, json.dumps(paths), json.dumps(FRAMES),
                        str(out), artifacts["semantic_plan"]], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as npz:
        return dict(npz), r.stdout.strip().splitlines(), r.stderr


@pytest.mark.parametrize("name", ["semantic_plan", "int8_plan"])
def test_artifact_equals_its_eager_engine(engines, artifacts, elsewhere, name):
    outputs, lines, _ = elsewhere
    assert json.loads(lines[0]) == []  # no model module was imported
    eng, mode = ARTIFACTS[name]
    hold_against_eager(outputs, name, engines[eng], mode, FRAMES)
    meta = deploy.read_meta(artifacts[name])
    assert ("cc_labels" in meta["kernels"]) == (name == "semantic_plan")
    assert ("qconv" in meta["kernels"]) == (name == "int8_plan")
    assert meta["engine_mode"] == engines[eng].mode


def test_pipeline_config_from_meta(artifacts):
    cfg = pipeline_config_from_meta(deploy.read_meta(artifacts["track_plan"]))
    assert (cfg.camera.width, cfg.camera.height) == (CAM["width"], CAM["height"])
    assert cfg.tracker.enabled and cfg.tracker.max_tracks == 8
    assert cfg.planner.start_offset == 80 and cfg.model.input_size == (256, 320)
    assert pipeline_config_from_meta(deploy.read_meta(artifacts["int8_plan"])).model.quantized


def test_bank_over_8_frames_equals_the_eager_tracked_engine(engines, artifacts):
    """``run`` with ``plan_every = 4``: the tracker steps on frames 0 and 4
    only.  The frozen step mutates the bank it is given, so the artifact's
    off-cadence frames run on a copy; the bank after 8 frames equals the
    eager tracked engine's exactly, and holds tracks."""
    eager = engines["tracked"]
    want = eager.run(SyntheticSource(eager.cfg.camera, n_frames=8), n_frames=8, plan_every=4,
                     warmup=False)
    art = ArtifactEngine(deploy.ServingArtifact.load(artifacts["track_plan"], device="cpu"))
    got = art.run(SyntheticSource(art.cfg.camera, n_frames=8), n_frames=8, plan_every=4,
                  warmup=False)
    assert got["n_frames"] == want["n_frames"] == 8
    assert got["plans_done"] == want["plans_done"] >= 1
    assert torch.equal(art._tracks_d, eager._tracks_d)
    assert (eager._tracks_d[:, 0] > 0).any()
    assert art.last_sweeps is None  # a frozen plan step returns the plan alone


def test_track_plan_artifact_serves_without_planning(artifacts):
    """ADVICE.md: a throughput-only run of a tracked artifact
    (``plan_paths=False``) has no run bank; its frames run on a fresh one."""
    art = ArtifactEngine(deploy.ServingArtifact.load(artifacts["track_plan"], device="cpu"))
    m = art.run(SyntheticSource(art.cfg.camera, n_frames=3), n_frames=3, plan_paths=False)
    assert m["n_frames"] == 3 and m["plans_done"] == 0
    with pytest.raises(ValueError, match="plan_every"):
        art.run(SyntheticSource(art.cfg.camera, n_frames=1), n_frames=1)
    with pytest.raises(RuntimeError, match="full Engine"):
        art.process(None)


def test_app_serves_an_artifact_without_the_model_code(elsewhere):
    _, lines, err = elsewhere
    metrics, models = (json.loads(line) for line in lines[-2:])
    assert metrics["n_frames"] == 4 and metrics["plans_done"] >= 1 and metrics["boot"] == "jit"
    assert models == []
    assert "mode=plan boot=jit" in err


@pytest.mark.parametrize("flags", [["--track"], ["--streams", "2"], ["--pipeline"],
                                   ["--checkpoint", "x.npz"], ["--int8"], ["--debug-dump"]])
def test_app_refuses_what_the_artifact_fixes(flags):
    from tod_tpu_torch.app import main

    with pytest.raises(SystemExit, match="incompatible with --todx"):
        main(["--todx", "a.todx", *flags, "--no-server"], device="cpu")


def test_app_todx_needs_in_stream_planning():
    from tod_tpu_torch.app import main

    with pytest.raises(SystemExit, match="--plan-every >= 1"):
        main(["--todx", "a.todx", "--plan-every", "0", "--no-server"], device="cpu")


class TestKernelLimits:
    """ROADMAP.md D, D5: what the card's kernels cannot take is refused on
    ``cuda`` before anything loads; the CPU serves it."""

    @staticmethod
    def past_limits() -> dict[str, tcfg.PipelineConfig]:
        base = tcfg.PipelineConfig()
        return {
            "MAX_K": base.replace(model=tcfg.ModelConfig(num_prototypes=40)),
            "L <= 113": base.replace(geometry=tcfg.GeometryConfig(terrain_norm_const=114)),
            "MAX_TRACKS": base.replace(tracker=tcfg.TrackerConfig(enabled=True, max_tracks=33)),
            "cost matrix": base.replace(
                tracker=tcfg.TrackerConfig(enabled=True, max_tracks=32),
                geometry=tcfg.GeometryConfig(max_balls=2000)),
            "K2": base.replace(camera=tcfg.CameraConfig(width=20000, height=4)),
        }

    def test_each_limit_is_named(self):
        from tod_tpu_torch.kernels.limits import kernel_limits, max_bump_radius

        assert max_bump_radius() == 113
        assert kernel_limits(tcfg.PipelineConfig()) == []
        assert kernel_limits(tcfg.PipelineConfig(
            geometry=tcfg.GeometryConfig(terrain_norm_const=113))) == []
        for limit, cfg in self.past_limits().items():
            problems = kernel_limits(cfg)
            assert len(problems) == 1 and limit in problems[0], (limit, problems)
            assert "ROADMAP.md D, D5" in problems[0]
        # K1 is not on the semantic path; the cc kernel is
        assert kernel_limits(self.past_limits()["MAX_K"], mode="semantic") == []
        tall = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=4, height=32 * 65536))
        assert "cc kernel" in " ".join(kernel_limits(tall, mode="semantic"))

    def test_engines_refuse_on_the_card_before_anything_loads(self, monkeypatch):
        from tod_tpu_torch.runtime import engine as engine_mod
        from tod_tpu_torch.runtime import multistream

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

        def must_not_load(*_, **__):
            raise AssertionError("the model loaded before the refusal")

        monkeypatch.setattr(engine_mod, "serving_model", must_not_load)
        monkeypatch.setattr(multistream, "serving_model", must_not_load)
        for limit, cfg in self.past_limits().items():
            with pytest.raises(ValueError, match="D5"):
                Engine(cfg, params={}, device="cuda")
            with pytest.raises(ValueError, match="D5"):
                multistream.MultiStreamEngine(cfg, 2, params={}, device="cuda")

    def test_an_artifact_past_a_limit_is_refused_on_the_card(self, tmp_path, monkeypatch):
        path = tmp_path / "past.todx"
        header = json.dumps({"kernel_limits": ["geometry.terrain_norm_const = 114: ... D5"],
                             "payload_bytes": 0}).encode()
        path.write_bytes(deploy.MAGIC + len(header).to_bytes(8, "little") + header)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="cannot serve this artifact"):
            deploy.ServingArtifact.load(str(path), device="cuda")

    def test_the_cpu_serves_past_the_limits(self):
        """A bank of 33 tracks (past ``MAX_TRACKS``) on the CPU's plain
        tracker."""
        from tod_tpu_torch.core.weights import load_pinned
        from tod_tpu_torch.ops.preprocess import pack_frame

        cfg = tcfg.PipelineConfig(
            camera=tcfg.CameraConfig(width=64, height=48),
            model=tcfg.ModelConfig(input_size=(48, 64), dtype="float32"),
            planner=tcfg.PlannerConfig(backend="tpu"),
            tracker=tcfg.TrackerConfig(enabled=True, max_tracks=33))
        eng = Engine(cfg, load_pinned(), device="cpu")
        f = next(SyntheticSource(cfg.camera, n_frames=1).frames())
        plan, bank = eng.serve_step_track_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)),
                                               eng._init_tracks())
        assert plan.shape == (cfg.planner.max_path_steps + 1, 2) and bank.shape == (33, 10)
