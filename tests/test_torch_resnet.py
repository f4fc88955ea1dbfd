"""The ResNet backbones (``tod_tpu_torch/models/resnet.py``, M13) against
the JAX package on the CPU: the YOLACT forward with ResNet 18, 34 and 50
from one JAX init carried across, in float32; the SAME max-pool; the int8
stem's 7x7 site against the JAX ``Conv8``; the model registry's names; the
BatchNorms that stay f32 in a bf16 engine."""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tod_tpu.core.config import ModelConfig as JaxModelConfig
from tod_tpu.models.prepare import fold_batchnorm
from tod_tpu.models.qconv import Conv8
from tod_tpu.models.yolact import Yolact as JaxYolact
from tod_tpu_torch.core.config import ModelConfig
from tod_tpu_torch.core.weights import carry_across
from tod_tpu_torch.models.yolact import Yolact

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

HW = (64, 64)


def flax_init(backbone: str, x: np.ndarray):
    """(flat tree, the JAX forward's outputs on ``x`` with the stem's
    BatchNorm folded) of a YOLACT with ``backbone`` at ``HW``, f32."""
    model = JaxYolact(JaxModelConfig(input_size=HW, dtype="float32", backbone=backbone))
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = {"/".join(k): np.asarray(a) for k, a in flatten_dict(dict(variables)).items()}
    return flat, model.apply(fold_batchnorm(variables), jnp.asarray(x), train=False)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50"])
def test_forward_matches_flax(backbone):
    x = np.random.default_rng(0).uniform(-1, 1, (1, *HW, 3)).astype(np.float32)
    flat, want = flax_init(backbone, x)
    model = Yolact(ModelConfig(input_size=HW, dtype="float32", backbone=backbone))
    model.load_state_dict(carry_across(flat, model))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    for field in ("loc", "conf", "coeff", "prototypes", "sem_logits"):
        a = getattr(got, field).numpy()
        b = np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        # test_torch_model.py's tolerances: f32 convolutions summed in
        # another order through the network
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4, err_msg=field)


@pytest.mark.parametrize("hw", [(9, 11), (16, 16), (7, 6)])
def test_max_pool_same_matches_flax(hw):
    from tod_tpu_torch.models.resnet import max_pool_same

    x = np.random.default_rng(1).standard_normal((2, *hw, 5)).astype(np.float32) - 3.0
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Stem(fnn.Module):
    """The JAX ResNet stem's int8 conv and its folded BatchNorm."""

    @fnn.compact
    def __call__(self, x):
        x = Conv8(64, (7, 7), strides=2, padding="SAME", use_bias=False, dtype=jnp.float32,
                  name="Conv_0")(x)
        return fnn.BatchNorm(use_running_average=True, dtype=jnp.float32, name="BatchNorm_0")(x)


@pytest.mark.parametrize("hw", [(48, 64), (17, 23)])
def test_int8_stem_site_equals_conv8(hw):
    """The static 7x7 stride-2 site (Cin = 3, K = 147) through ``QConv`` (on
    the CPU ``plain_qconv``) equals the jitted JAX ``Conv8`` and its folded
    BatchNorm exactly in f32."""
    from tod_tpu_torch.models.qconv import QConv

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, *hw, 3)) * 2).astype(np.float32)
    kq = rng.integers(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    w_scale = rng.uniform(1e-4, 1e-2, 64).astype(np.float32)
    act_scale = np.float32(0.031)
    beta = rng.standard_normal(64).astype(np.float32)
    eps = 1e-5
    variables = {
        "params": {"Conv_0": {"kernel_q": kq, "w_scale": w_scale, "act_scale": act_scale},
                   "BatchNorm_0": {"scale": np.ones(64, np.float32), "bias": beta}},
        "batch_stats": {"BatchNorm_0": {"mean": np.zeros(64, np.float32),
                                        "var": np.full(64, 1.0 - eps, np.float32)}},
    }
    want = np.asarray(jax.jit(_Stem().apply)(variables, jnp.asarray(x)))
    site = QConv(3, 64, 7, 2, bn=True)
    site.set_branch("static")
    site.load_state_dict({"kernel_q": torch.from_numpy(kq.transpose(3, 2, 0, 1).copy()),
                          "w_scale": torch.from_numpy(w_scale),
                          "act_scale": torch.tensor(act_scale), "bias": torch.from_numpy(beta)})
    with torch.inference_mode():
        got = site(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_registry_names_match_the_jax_registry():
    """The family names, and which backbone each builds: the default name
    follows ``cfg.backbone`` (the JAX registry's rule since a round in which
    a ResNet config built under it trained MobileNetV2), the family names
    pin theirs."""
    import tod_tpu.models.yolact  # noqa: F401  (registers the JAX models)
    from tod_tpu.core.registry import list_models as jax_models
    from tod_tpu_torch.core.registry import get_model, list_models, register_model

    assert list_models() == jax_models() == ["yolact_mnv2_fpn", "yolact_r18_fpn",
                                             "yolact_r50_fpn"]
    small = dict(input_size=HW, fpn_channels=16, proto_channels=16, head_channels=16,
                 num_prototypes=8)

    def backbone(model):
        bb = getattr(model, model.backbone_name)
        return type(bb).__name__, getattr(bb, "block_name", None)

    assert backbone(get_model("yolact_mnv2_fpn", ModelConfig(**small))) == ("MobileNetV2", None)
    assert backbone(get_model("yolact_mnv2_fpn", ModelConfig(backbone="resnet50", **small))) == (
        "ResNet", "Bottleneck")
    assert backbone(get_model("yolact_r18_fpn", ModelConfig(backbone="resnet50", **small))) == (
        "ResNet", "BasicBlock")
    assert backbone(get_model("yolact_r50_fpn", ModelConfig(**small))) == ("ResNet", "Bottleneck")
    with pytest.raises(KeyError, match="known"):
        get_model("yolact_r101_fpn")
    with pytest.raises(ValueError, match="already registered"):
        register_model("yolact_r18_fpn")(lambda cfg=None: None)


def test_bf16_engine_keeps_the_blocks_batchnorms_f32():
    """``serving_model`` casts the model to bf16, all but a ResNet block's
    BatchNorms, which compute in f32 with their values exactly as loaded."""
    from tod_tpu_torch.bench.configs import model_state
    from tod_tpu_torch.core.config import CameraConfig, PipelineConfig
    from tod_tpu_torch.models.resnet import BatchNorm
    from tod_tpu_torch.runtime.engine import Engine

    mcfg = ModelConfig(backbone="resnet18", input_size=HW)
    state = model_state(mcfg)
    state = {k: (v + torch.rand(v.shape) * 1e-3 if k.endswith(".var") else v)
             for k, v in state.items()}
    eng = Engine(PipelineConfig(camera=CameraConfig(width=64, height=64), model=mcfg), state,
                 device="cpu")
    bns = {n: m for n, m in eng.model.named_modules() if isinstance(m, BatchNorm)}
    assert len(bns) == 2 * 8 + 3  # two a block, and the three downsampling shortcuts
    for name, m in bns.items():
        assert m.var.dtype == m.scale.dtype == torch.float32
        assert torch.equal(m.var, state[f"{name}.var"])
    assert eng.model.ResNet_0.Conv_0.weight.dtype == torch.bfloat16
    assert "ResNet_0.BasicBlock_0.bn1.mean" in state  # unfolded, by its Flax name
