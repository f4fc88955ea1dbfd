"""Semantic mode against the JAX package on the CPU: ``semantic_argmax``
(ties included), the plain connected components on every listed mask (and
against ``scipy.ndimage.label``), the tile helpers and the non-integer
nearest upscale, ``Engine(mode="semantic")`` on the pinned weights, and
``Classifier`` in both modes.  The cc kernel's case runs on a card only."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from tests.test_torch_pipeline import (
    CAM,
    MODEL,
    PLANNER,
    assert_plans_close,
    flat_weights,  # noqa: F401 (module fixture)
    frame,
    nest,
)
from tod_tpu.core import config as jcfg
from tod_tpu_torch.core import config as tcfg

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


def serpentine(h: int, w: int) -> np.ndarray:
    """Rows joined alternately at the right and left ends: one component
    whose graph diameter is about H*W/2."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def masks() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    out = {f"random p={p}": rng.random((40, 56)) < p for p in (0.3, 0.5, 0.6)}
    out["serpentine 32x32"] = serpentine(32, 32)
    out["checkerboard"] = (np.indices((24, 30)).sum(0) % 2).astype(bool)  # 360 singletons
    out["empty"] = np.zeros((17, 23), bool)
    out["full"] = np.ones((17, 23), bool)
    out["1x1"] = np.ones((1, 1), bool)
    out["1xW"] = rng.random((1, 50)) < 0.5
    out["Hx1"] = rng.random((50, 1)) < 0.5
    return out


MASKS = masks()


def scipy_ids(mask: np.ndarray, max_labels: int) -> np.ndarray:
    """The independent oracle: scipy's 4-connected labels, which number
    components in row-major order of their first pixel from 1."""
    lab, _ = scipy.ndimage.label(mask)
    return np.where(lab > 0, np.minimum(lab - 1, max_labels - 1), -1).astype(np.int32)


class TestSemanticArgmax:
    def test_matches_jax_with_ties(self):
        from tod_tpu.ops.postprocess import semantic_argmax as jax_argmax
        from tod_tpu_torch.ops.postprocess import semantic_argmax

        rng = np.random.default_rng(1)
        logits = rng.integers(-2, 3, (2, 9, 11, 81)).astype(np.float32)  # many equal channels
        logits[0, 0, 0, :4] = 1.0  # a four-way tie: the first channel wins
        logits[0, 0, 1, :4] = [0.0, 2.0, 2.0, 1.0]
        want = np.asarray(jax_argmax(jnp.asarray(logits)))
        got = semantic_argmax(torch.from_numpy(logits)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert got[0, 0, 0] == 0 and got[0, 0, 1] == 1
        ties = (logits[..., :4] == logits[..., :4].max(-1, keepdims=True)).sum(-1) > 1
        assert ties.mean() > 0.3

    def test_semantic_postprocess_matches_jax(self):
        from tod_tpu.ops.postprocess import semantic_postprocess as jax_post
        from tod_tpu_torch.ops.postprocess import semantic_postprocess

        logits = np.random.default_rng(2).normal(0, 1, (14, 12, 81)).astype(np.float32)
        logits[..., 3] += 0.8  # enough ball cells for several components
        want = jax_post(jnp.asarray(logits), max_labels=5)
        got = semantic_postprocess(torch.from_numpy(logits), max_labels=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[1].max() == 4  # the clamp is reached


class TestConnectedComponents:
    @pytest.mark.parametrize("name", list(MASKS))
    def test_plain_matches_jax_exactly(self, name):
        from tod_tpu.ops.cc_labels import connected_components as jax_cc
        from tod_tpu_torch.ops.cc_labels import connected_components

        mask = MASKS[name]
        want = np.asarray(jax_cc(jnp.asarray(mask), max_labels=100))
        got = connected_components(torch.from_numpy(mask), max_labels=100).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, scipy_ids(mask, 100))

    def test_checkerboard_exceeds_max_labels(self):
        from tod_tpu_torch.ops.cc_labels import connected_components

        mask = MASKS["checkerboard"]
        got = connected_components(torch.from_numpy(mask), max_labels=100).numpy()
        assert (got == 99).sum() == mask.sum() - 99  # every singleton past the 99th clamps

    @pytest.mark.parametrize("p", [0.3, 0.5])
    def test_plain_matches_scipy_at_120x160(self, p):
        from tod_tpu_torch.ops.cc_labels import connected_components

        mask = np.random.default_rng(3).random((120, 160)) < p
        got = connected_components(torch.from_numpy(mask), max_labels=10_000).numpy()
        np.testing.assert_array_equal(got, scipy_ids(mask, 10_000))

    @pytest.mark.parametrize("name", list(MASKS))
    def test_root_labels_are_component_minima(self, name):
        from tod_tpu_torch.kernels.cc_labels import SENTINEL, plain_root_labels

        mask = MASKS[name]
        lab, n = scipy.ndimage.label(mask)
        lin = np.arange(mask.size).reshape(mask.shape)
        minima = np.full(n + 1, SENTINEL, np.int64)
        np.minimum.at(minima, lab[mask], lin[mask])
        want = np.where(mask, minima[lab], SENTINEL)
        np.testing.assert_array_equal(plain_root_labels(torch.from_numpy(mask)).numpy(), want)

    def test_kernel_matches_plain_on_cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
        from tod_tpu_torch.kernels.cc_labels import plain_root_labels, root_labels

        for name, mask in MASKS.items():
            got = root_labels(torch.from_numpy(mask).cuda()).cpu()
            assert torch.equal(got, plain_root_labels(torch.from_numpy(mask))), name


class TestTiles:
    def test_tile_and_stitch_match_jax(self):
        from tod_tpu.ops.preprocess import stitch_tiles as jax_stitch
        from tod_tpu.ops.preprocess import tile_448x224 as jax_tile
        from tod_tpu_torch.ops.preprocess import stitch_tiles, tile_448x224

        rgb = np.random.default_rng(4).integers(0, 256, (120, 160, 3)).astype(np.uint8)
        want = np.asarray(jax_tile(jnp.asarray(rgb)))
        got = tile_448x224(torch.from_numpy(rgb))
        assert got.shape == (2, 224, 224, 3)
        # an upscale: torch's and XLA's linear weights are rounded in f32 each
        # their own way, up to 2e-3 on [0, 255] data (1e-4 for downscales)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)
        np.testing.assert_array_equal(stitch_tiles(got).numpy(),
                                      np.asarray(jax_stitch(jnp.asarray(got.numpy()))))

    @pytest.mark.parametrize("src_hw,out_hw", [((256, 320), (480, 640)), ((256, 320), (120, 160)),
                                               ((28, 56), (480, 640))])
    def test_nearest_upscale_at_non_integer_ratios(self, src_hw, out_hw):
        from tod_tpu.ops.preprocess import upscale_to_frame as jax_upscale
        from tod_tpu_torch.ops.preprocess import upscale_to_frame

        ids = np.random.default_rng(5).integers(-1, 100, src_hw).astype(np.int32)
        np.testing.assert_array_equal(
            upscale_to_frame(torch.from_numpy(ids), out_hw).numpy(),
            np.asarray(jax_upscale(jnp.asarray(ids), out_hw)),
        )


@pytest.fixture(scope="module")
def semantic_engines(flat_weights):  # noqa: F811
    """(JAX engine, port engine) in semantic mode on the pinned weights, in
    the pipeline tests' configuration: a 160x120 camera, the model at
    256x320, f32."""
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(**PLANNER)),
        nest(flat_weights), mode="semantic", use_pallas=False,
    )
    port = Engine(
        tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
                            planner=tcfg.PlannerConfig(**PLANNER)),
        carry_across(flat_weights), device="cpu", mode="semantic",
    )
    return jax_engine, port


class TestSemanticEngine:
    @pytest.mark.parametrize("t", [0, 7])
    def test_process_matches_jax(self, semantic_engines, t):
        jax_engine, port = semantic_engines
        f = frame(t)
        jscene, jdets = jax_engine.process(f)
        scene, dets = port.process(f)
        cls = dets.class_map.numpy()
        np.testing.assert_array_equal(cls, np.asarray(jdets.class_map))
        np.testing.assert_array_equal(dets.id_map.numpy(), np.asarray(jdets.id_map))
        assert (cls == 3).sum() > 100 and dets.id_map.max() >= 0  # real balls reach fusion
        assert not dets.valid.any() and dets.masks.shape == tuple(jdets.masks.shape)
        # TestFusion's tolerances: heights exact, ball means to rel 1e-6
        np.testing.assert_array_equal(scene.height.numpy(), np.asarray(jscene.height))
        np.testing.assert_allclose(scene.balls.numpy(), np.asarray(jscene.balls), rtol=1e-6)

    @pytest.mark.parametrize("t", [0, 7])
    def test_serve_step_plan_matches_jax(self, semantic_engines, t):
        from tod_tpu_torch.ops.preprocess import pack_frame

        jax_engine, port = semantic_engines
        f = frame(t)
        packed = pack_frame(f.rgb, f.depth)
        want = np.asarray(jax_engine._serve_step_plan_fn(jax_engine.params, jnp.asarray(packed)))
        got = port.serve_step_plan(torch.from_numpy(packed)).numpy()
        assert int(want[0, 0]) > 5
        assert_plans_close(got, want)

    def test_serve_step_scene_and_packed_match_jax(self, semantic_engines):
        from tod_tpu_torch.ops.preprocess import pack_frame

        jax_engine, port = semantic_engines
        f = frame(4)
        packed = pack_frame(f.rgb, f.depth)
        jh, jb = jax_engine._serve_step_scene(jax_engine.params, jnp.asarray(packed))
        height, balls = port.serve_step_scene(torch.from_numpy(packed))
        np.testing.assert_array_equal(height.numpy(), np.asarray(jh))
        np.testing.assert_allclose(balls.numpy(), np.asarray(jb), rtol=1e-6)
        buf = port.serve_step_packed(torch.from_numpy(packed))
        h16, b32 = port._unpack_plan_buffer(buf)
        np.testing.assert_array_equal(h16, np.asarray(jh).astype(np.float16))

    @pytest.mark.parametrize("backend", ["tpu", "numpy"])
    def test_run_streams_in_semantic_mode(self, flat_weights, backend):  # noqa: F811
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.runtime.engine import Engine
        from tod_tpu_torch.runtime.frame_source import SyntheticSource
        from tod_tpu_torch.serve.server import PathStore

        cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=64, height=48),
                                  model=tcfg.ModelConfig(**MODEL),
                                  planner=tcfg.PlannerConfig(backend=backend))
        eng = Engine(cfg, carry_across(flat_weights), device="cpu", mode="semantic")
        store = PathStore()
        m = eng.run_supervised(lambda: SyntheticSource(cfg.camera, n_frames=3), n_frames=3,
                               path_store=store, plan_every=1, max_inflight=2, warmup=False)
        assert m["n_frames"] == 3 and m["plans_done"] >= 1 and m["restarts"] == 0

    def test_unknown_mode_raises(self, flat_weights):  # noqa: F811
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.runtime.engine import Engine

        with pytest.raises(ValueError, match="unknown mode"):
            Engine(tcfg.PipelineConfig(), carry_across(flat_weights), device="cpu", mode="tracked")

    def test_validate_checks_meaningful_classes(self):
        from tod_tpu.core.config import validate as jax_validate
        from tod_tpu_torch.core.config import validate

        bad = dict(num_classes=3, meaningful_classes=4)
        want = jax_validate(jcfg.PipelineConfig(model=jcfg.ModelConfig(**bad)))
        got = validate(tcfg.PipelineConfig(model=tcfg.ModelConfig(**bad)))
        assert "meaningful_classes exceeds num_classes" in got
        assert "meaningful_classes exceeds num_classes" in want
        assert tcfg.ModelConfig().meaningful_classes == jcfg.ModelConfig().meaningful_classes


# tests/test_classify_parity.py's narrow model, in f32
NARROW = dict(input_size=(224, 224), fpn_channels=16, proto_channels=16, head_channels=16,
              width_mult=0.35, num_prototypes=8, dtype="float32")


@pytest.fixture(scope="module")
def narrow_params():
    """A JAX init of the narrow model: the flat tree for the port, and the
    BatchNorm-folded tree for the JAX classifier (the fold the port's
    carry-across makes)."""
    from tod_tpu.models.prepare import fold_batchnorm
    from tod_tpu.runtime.classify import Classifier as JaxClassifier

    cfg = jcfg.PipelineConfig(model=jcfg.ModelConfig(**NARROW))
    params = JaxClassifier(cfg, seed=3).params
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    return flat, fold_batchnorm(params)


class TestClassifier:
    @pytest.mark.parametrize("tile_parity", [False, True])
    def test_matches_jax(self, narrow_params, tile_parity):
        from tod_tpu.ops.packing import pack_rgb_u32
        from tod_tpu.runtime.classify import Classifier as JaxClassifier
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.ops.packing import unpack_class_id
        from tod_tpu_torch.runtime.classify import Classifier

        flat, folded = narrow_params
        cam = dict(width=160, height=120)
        jclf = JaxClassifier(jcfg.PipelineConfig(camera=jcfg.CameraConfig(**cam),
                                                 model=jcfg.ModelConfig(**NARROW)),
                             params=folded, tile_parity=tile_parity)
        clf = Classifier(tcfg.PipelineConfig(camera=tcfg.CameraConfig(**cam),
                                             model=tcfg.ModelConfig(**NARROW)),
                         params=carry_across(flat), tile_parity=tile_parity, device="cpu")
        for t in (0, 7):
            words = np.asarray(pack_rgb_u32(jnp.asarray(frame(t).rgb)))
            want = jclf.classify(words)
            got = clf.classify(words)
            assert got.shape == want.shape == (120, 160) and got.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
            flat_got = clf.classify(words.reshape(-1))
            np.testing.assert_array_equal(flat_got, want.reshape(-1))
        cls, ids = unpack_class_id(torch.from_numpy(got))
        assert int(cls.max()) <= 3 and bool(((ids >= 0) <= (cls == 3)).all())

    def test_seeded_init_is_deterministic(self):
        from tod_tpu_torch.runtime.classify import Classifier

        cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=64, height=48),
                                  model=tcfg.ModelConfig(**NARROW))
        words = np.random.default_rng(6).integers(0, 2**32, (48, 64), dtype=np.uint64)
        words = (words.astype(np.uint32) & 0xFFFFFF00).astype(np.uint32)
        a = Classifier(cfg, seed=1, device="cpu")
        b = Classifier(cfg, seed=1, device="cpu")
        np.testing.assert_array_equal(a.classify(words), b.classify(words))
        c = Classifier(dataclasses.replace(cfg), seed=2, device="cpu", tile_parity=True)
        assert c.classify(words).shape == (48, 64)
