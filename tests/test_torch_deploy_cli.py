"""Frozen serving artifacts on the CPU, the host-planner modes and the CLI:
the ``scene`` and ``packed`` artifacts at the pipeline tests' 160x120
camera (the model at 256x320 f32) on the pinned weights, loaded in a
process that cannot import jax, ``tod_tpu`` or the port's model code, equal
their eager engine bit for bit, and the ``scene`` artifact the JAX engine
(the height exactly, the balls at rtol 1e-6); their outputs decode to host
arrays; ``python -m tod_tpu_torch.deploy export|info|serve``."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_deploy import (
    PLANNER,
    hold_against_eager,
    load_elsewhere,
    packed_frame,
    pipeline,
)
from tod_tpu.core import config as jcfg
from tod_tpu_torch import deploy
from tod_tpu_torch.runtime.engine import Engine

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

FRAMES = (0, 4, 7)
MODES = ("scene", "packed")


@pytest.fixture(scope="module")
def engine():
    from tod_tpu_torch.core.weights import load_pinned

    return Engine(pipeline(), load_pinned(), device="cpu")


@pytest.fixture(scope="module")
def artifacts(engine, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for mode in MODES:
        exported, meta = deploy.export_engine(engine, mode)
        paths[mode] = str(out / f"{mode}.todx")
        deploy.save_artifact(exported, meta, paths[mode])
    return paths


@pytest.fixture(scope="module")
def loaded(artifacts, tmp_path_factory):
    return load_elsewhere(artifacts, FRAMES, tmp_path_factory.mktemp("loaded") / "out.npz")


@pytest.mark.parametrize("mode", MODES)
def test_artifact_equals_its_eager_engine(engine, loaded, mode):
    outputs, models = loaded
    assert models == []
    hold_against_eager(outputs, mode, engine, mode, FRAMES)


def test_scene_artifact_matches_the_jax_engine(loaded):
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from test_torch_deploy import CAM, MODEL
    from test_torch_pipeline import nest
    from tod_tpu_torch.core.weights import read_tree

    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(**PLANNER)),
        nest(read_tree()), use_pallas=False,
    )
    outputs, _ = loaded
    for t in FRAMES:
        jh, jb = jax_engine._serve_step_scene(jax_engine.params,
                                              jnp.asarray(packed_frame(t).numpy()))
        np.testing.assert_array_equal(outputs[f"scene/{t}/0"], np.asarray(jh))
        np.testing.assert_allclose(outputs[f"scene/{t}/1"], np.asarray(jb), rtol=1e-6)


def test_scene_outputs_decode_to_host_arrays(loaded, artifacts):
    outputs, _ = loaded
    meta = deploy.read_meta(artifacts["packed"])
    assert meta["kernels"] == ["bump", "mask_assembly"] == deploy.read_meta(
        artifacts["scene"])["kernels"]
    art = deploy.ServingArtifact.load(artifacts["packed"], device="cpu")
    height, balls = art.unpack_scene(torch.from_numpy(outputs["packed/4/0"]))
    assert height.shape == (120, 160) and height.dtype == np.float32
    np.testing.assert_array_equal(height, outputs["scene/4/0"].astype(np.float16))
    np.testing.assert_array_equal(balls, outputs["scene/4/1"])


def test_cli_export_info_serve(tmp_path, capsys):
    """``export``, ``info`` and ``serve`` on the CPU: a ``--track`` export
    at 64x48 with signed turns, its header, and 4 frames served through it;
    ``--aot`` off the card exits before anything loads."""
    out = str(tmp_path / "cli.todx")
    with pytest.raises(SystemExit, match="export on the card"):
        deploy.main(["export", "--out", out, "--aot"], device="cpu")
    assert not os.path.exists(out)
    assert deploy.main(["export", "--out", out, "--track", "--width", "64", "--height", "48",
                        "--signed-turns", "--start-offset", "30", "--platforms", "cpu,cuda",
                        "--portable"], device="cpu") == 0
    exported = json.loads(capsys.readouterr().out)
    assert exported["mode"] == "track_plan" and exported["bytes"] == os.path.getsize(out)
    assert deploy.main(["info", out], device="cpu") == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["planner"]["signed_turns"] and meta["planner"]["start_offset"] == 30
    assert meta["platforms"] == ["cpu", "cuda"] and meta["portable"]
    assert meta["model"]["input_size"] == [48, 64] and meta["tracker"]["max_tracks"] == 8
    assert deploy.main(["serve", out, "--frames", "4", "--plan-every", "2", "--no-server"],
                       device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "boot: jit"
    metrics = json.loads(lines[-1])
    assert metrics["n_frames"] == 4 and metrics["plans_done"] == 2
