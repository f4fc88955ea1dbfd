"""The port's stage-split pipeline (``parallel.TwoStagePipeline``) on the
CPU: against the port's fused ``Engine.serve_step_plan``, against the JAX
package's ``TwoStagePipeline`` on its 2-device virtual mesh, its streaming
loop, one device, and ``app --pipeline``.

The camera and model are ``test_torch_pipeline.py``'s (160x120, the model
at 256x320 f32 on the pinned weights), where the synthetic balls are
detected and the plans are not empty.  Both stages run the same operations
as the fused step, so the stage-split plan equals the fused one exactly;
against JAX the gate is ``tests/test_pipeline_parallel.py``'s (``n_valid``
equal, the total cost within rtol 1e-3)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tod_tpu_torch.core import config as tcfg

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

CAM = dict(width=160, height=120)
MODEL = dict(input_size=(256, 320), dtype="float32")
PLANNER = dict(start_offset=80, backend="tpu")


def port_cfg() -> tcfg.PipelineConfig:
    return tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
                               planner=tcfg.PlannerConfig(**PLANNER))


def frame(t: int):
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    return synth_frame_numpy(0, t, CAM["height"], CAM["width"])


@pytest.fixture(scope="module")
def flat_weights():
    from tod_tpu_torch.core.weights import read_tree

    return read_tree()


@pytest.fixture(scope="module")
def pipe(flat_weights):
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.parallel import TwoStagePipeline

    return TwoStagePipeline(port_cfg(), devices=["cpu", "cpu"], params=carry_across(flat_weights))


@pytest.fixture(scope="module")
def split_plans(pipe):
    return {t: pipe.dispatch(frame(t).rgb, frame(t).depth) for t in (0, 9)}


@pytest.mark.parametrize("t", [0, 9])
def test_stage_split_plan_equals_fused_plan(pipe, split_plans, t):
    from tod_tpu_torch.core.weights import carry_across, read_tree
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine

    eng = Engine(port_cfg(), carry_across(read_tree()), device="cpu")
    f = frame(t)
    fused = eng.serve_step_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)))
    split = split_plans[t]
    assert int(split[0, 0]) > 0  # a ball was found and planned to
    assert torch.equal(split, fused)


@pytest.fixture(scope="module")
def jax_pipe(flat_weights):
    """The JAX package's pipeline on its first two virtual devices."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    from tod_tpu.core import config as jcfg
    from tod_tpu.parallel.pipeline import TwoStagePipeline as JaxPipeline

    from test_torch_pipeline import nest

    return JaxPipeline(jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM),
                                           model=jcfg.ModelConfig(**MODEL),
                                           planner=jcfg.PlannerConfig(start_offset=80)),
                       params=nest(flat_weights))


@pytest.mark.parametrize("t", [0, 9])
def test_stage_split_plan_matches_jax_pipeline(jax_pipe, split_plans, t):
    jpipe = jax_pipe
    assert jpipe.d_fwd != jpipe.d_post
    want = np.asarray(jpipe.dispatch(frame(t).rgb, frame(t).depth))
    got = split_plans[t].numpy()
    assert int(got[0, 0]) == int(want[0, 0]), "n_valid"
    np.testing.assert_allclose(got[1:, 0].sum(), want[1:, 0].sum(), rtol=1e-3,
                               err_msg="total plan cost")


def test_stage_one_holds_the_weights_and_stage_two_the_anchors(pipe):
    assert pipe.d_fwd == pipe.d_post == torch.device("cpu")
    assert next(pipe.model.parameters()).device == pipe.d_fwd
    assert pipe.anchors.device == pipe.d_post


def test_streaming_loop_serves_paths(pipe):
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.serve.server import PathStore

    store = PathStore()
    m = pipe.run(SyntheticSource(tcfg.CameraConfig(**CAM), seed=0, n_frames=3), n_frames=3,
                 path_store=store, warmup=False, max_inflight=1)
    assert m["n_frames"] == 3 and m["fps"] > 0
    assert set(m) == {"n_frames", "wall_s", "fps", "compile_s", "stage1_device",
                      "stage2_device"}
    path = store.get()
    assert path.created > 0 and path.directions


def test_single_device(flat_weights):
    from tod_tpu_torch.bench.configs import model_state
    from tod_tpu_torch.parallel import TwoStagePipeline
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=64, height=48),
                              model=tcfg.ModelConfig(input_size=(48, 64), dtype="float32"),
                              planner=tcfg.PlannerConfig(backend="tpu"))
    one = TwoStagePipeline(cfg, devices=["cpu"], params=model_state(cfg.model))
    assert one.d_fwd == one.d_post == torch.device("cpu")
    f = synth_frame_numpy(3, 0, 48, 64)
    plan = one.dispatch(f.rgb, f.depth)
    assert plan.shape == (cfg.planner.max_path_steps + 1, 2) and torch.isfinite(plan).all()


def test_no_device_is_refused():
    from tod_tpu_torch.parallel import TwoStagePipeline

    with pytest.raises(ValueError, match="at least one device"):
        TwoStagePipeline(port_cfg(), devices=[])


def test_app_pipeline_plans_two_frames(capsys, caplog):
    from tod_tpu_torch.app import main

    caplog.set_level("INFO")
    rc = main(["--pipeline", "--frames", "2", "--width", "64", "--height", "48", "--no-server",
               "--metrics-json"], device="cpu")
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["n_frames"] == 2
    assert metrics["stage1_device"] == metrics["stage2_device"] == "cpu"
    assert "both stages share one device" in caplog.text


def test_app_pipeline_keeps_the_track_refusal():
    from tod_tpu_torch.app import main

    with pytest.raises(SystemExit, match="fused-graph serving"):
        main(["--pipeline", "--track", "--frames", "1", "--no-server"], device="cpu")
