"""The ResNet backbones through the serving engine and the bench, against
the JAX package on the CPU: an ``Engine`` on the trained
``checkpoints/backbones/resnet18`` (converted as ``tests/test_torch_weights.py
--write`` converts it) against the JAX engine's plans, at the pipeline
tests' 160x120 camera with the model at 256x320 f32; a ResNet18 ``--int8``
engine whose every conv is a static int8 site, the 7x7 stem among them;
bench config 15 against the JAX config's keys."""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import assert_plans_close, nest
from tod_tpu.core import config as jcfg
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.engine import Engine
from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAM = dict(width=160, height=120)
MODEL = dict(input_size=(256, 320), dtype="float32", backbone="resnet18")
PLANNER = dict(start_offset=80)


def checkpoint_tree(path: pathlib.Path) -> dict[str, np.ndarray]:
    """The flat tree of an orbax checkpoint, as ``test_torch_weights.py``'s
    converter reads it, without the JAX loader's msgpack sidecar (which the
    repository tracks beside the backbone checkpoints: the test writes
    nothing there)."""
    import jax

    from tod_tpu.train.checkpoint import load_checkpoint

    return {"/".join(str(k.key) for k in p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_leaves_with_path(load_checkpoint(path, fast=False))}


def test_engine_on_the_resnet18_checkpoint_matches_jax():
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.models.yolact import Yolact

    tree = checkpoint_tree(ROOT / "checkpoints" / "backbones" / "resnet18")
    state = carry_across(tree, Yolact(tcfg.ModelConfig(**MODEL)))
    port = Engine(tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM),
                                      model=tcfg.ModelConfig(**MODEL),
                                      planner=tcfg.PlannerConfig(**PLANNER)), state, device="cpu")
    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(**PLANNER)),
        nest(tree), use_pallas=False,
    )
    for t in (0, 7):
        f = synth_frame_numpy(0, t, CAM["height"], CAM["width"])
        packed = pack_frame(f.rgb, f.depth)
        want = np.asarray(jax_engine._serve_step_plan_fn(jax_engine.params, jnp.asarray(packed)))
        assert int(want[0, 0]) > 5
        assert_plans_close(port.serve_step_plan(torch.from_numpy(packed)).numpy(), want)


def test_resnet18_int8_engine_serves_static_sites():
    """``--int8`` with a ResNet18: calibration on the CPU, then every conv
    a static int8 site (a dense ``QConv``: no depthwise in a ResNet), the
    7x7 stride-2 stem among them, and a frame planned."""
    from tod_tpu_torch.bench.configs import model_state
    from tod_tpu_torch.models.qconv import conv_sites

    mcfg = tcfg.ModelConfig(backbone="resnet18", input_size=(48, 64), dtype="float32")
    cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=64, height=48),
                              model=tcfg.ModelConfig(backbone="resnet18", input_size=(48, 64),
                                                     dtype="float32", quantized=True),
                              planner=tcfg.PlannerConfig(backend="tpu", start_offset=30))
    eng = Engine(cfg, model_state(mcfg), device="cpu")
    sites = conv_sites(eng.model)
    assert {m.branch for m in sites.values()} == {"static"}
    stem = sites["ResNet_0.Conv_0"]
    assert (stem.k, stem.stride, stem.bn, stem.packed.shape) == (7, 2, True, (1, 2, 64, 128))
    f = synth_frame_numpy(0, 0, 48, 64)
    plan = eng.serve_step_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)))
    assert plan.shape == (cfg.planner.max_path_steps + 1, 2) and torch.isfinite(plan).all()


def test_config15_has_the_jax_configs_keys():
    """Config 15 on the CPU at the JAX config's sizes (batch 2 of the narrow
    model at 64x64): the JAX line's keys and metric, each backbone's point
    with the JAX point's keys, the quality fields null with the item they
    wait for, and no device metric."""
    from tod_tpu.bench.configs import config15_backbone_family
    from tod_tpu_torch.bench.configs import run_config

    want = config15_backbone_family()
    got = run_config(15, device="cpu")
    assert set(want) <= set(got) and got["metric"] == want["metric"]
    assert [p["backbone"] for p in got["curve"]] == [p["backbone"] for p in want["curve"]]
    for p, q in zip(got["curve"], want["curve"]):
        assert set(q) <= set(p)
        assert p["map50"] is None and p["recall50"] is None and p["mfu"] is None
        assert p["images_per_s"] > 0 and p["step_gflops"] > 0
    assert "M14" in got["quality"] and got["backend"] == "cpu"
    # the ResNets cost more than MobileNetV2, ResNet50 the most
    flops = [p["step_gflops"] for p in got["curve"]]
    assert flops[0] < flops[1] < flops[2]
