"""``ModelConfig.s2d_stem`` and ``depthwise_shifted`` in the port against
the JAX package on the CPU: the ops (``ops/s2d.py``, ``ops/depthwise.py``)
value and gradient in f32 within 1e-5, and the flagged TINY Yolact in its
serving form, its training form (with gradients) and its int8 form,
against the JAX flagged model on carried weights, with the tolerances
stated at each test."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core import config as jcfg
from tod_tpu.models.prepare import calibrate_amax as jax_calibrate_amax
from tod_tpu.models.prepare import fold_batchnorm, quantize_prepared
from tod_tpu.models.yolact import create_model
from tod_tpu.ops import depthwise as jdw
from tod_tpu.ops import s2d as js2d
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.core.weights import carry_across, train_state_from_tree, train_state_to_tree
from tod_tpu_torch.models.conv import S2DConv, ShiftedConv, TrainS2DConv, TrainShiftedConv
from tod_tpu_torch.models.qconv import QConv, load_prepared
from tod_tpu_torch.models.yolact import Yolact
from tod_tpu_torch.ops import depthwise as tdw
from tod_tpu_torch.ops import s2d as ts2d

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8)
FLAGS = dict(s2d_stem=True, depthwise_shifted=True)
FIELDS = ("loc", "conf", "coeff", "prototypes", "sem_logits")
OP_TOL = 1e-5


def flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for key, v in flat_tree.items():
        d = out
        *parts, last = key.split("/")
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


class TestS2D:
    def test_space_to_depth_order_is_jax_s(self):
        x = np.random.default_rng(0).normal(size=(2, 6, 10, 3)).astype(np.float32)
        got = ts2d.space_to_depth(nchw(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, np.asarray(js2d.space_to_depth(jnp.asarray(x))))
        with pytest.raises(ValueError, match="even"):
            ts2d.space_to_depth(torch.zeros(1, 3, 5, 4))

    def test_stem_kernel_is_jax_s(self):
        k = np.random.default_rng(1).normal(size=(3, 3, 3, 8)).astype(np.float32)
        got = ts2d.stem_kernel_s2d(oihw(k)).numpy()
        want = np.asarray(js2d.stem_kernel_s2d(jnp.asarray(k)))  # (2, 2, 12, 8) HWIO
        np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
        with pytest.raises(ValueError, match="3x3"):
            ts2d.stem_kernel_s2d(torch.zeros(8, 3, 5, 5))

    @pytest.mark.parametrize("hw", [(48, 64), (6, 10), (2, 2)])
    def test_stem_conv_value_and_gradient(self, hw):
        """Against the JAX ``s2d_stem_conv`` and the plain SAME conv, f32
        within 1e-5; the gradients of x and the kernel too."""
        rng = np.random.default_rng(hw[0])
        x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
        k = rng.normal(0, 0.3, size=(3, 3, 3, 16)).astype(np.float32)
        r = rng.normal(size=(2, hw[0] // 2, hw[1] // 2, 16)).astype(np.float32)

        def jloss(xx, kk, fn):
            return jnp.sum(fn(xx, kk) * r)

        def plain(xx, kk):
            return jax.lax.conv_general_dilated(xx, kk, (2, 2), "SAME",
                                                dimension_numbers=("NHWC", "HWIO", "NHWC"))

        xt, kt = nchw(x).requires_grad_(), oihw(k).requires_grad_()
        yt = ts2d.s2d_stem_conv(xt, kt)
        gx, gk = torch.autograd.grad((yt.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum(),
                                     [xt, kt])
        for fn in (js2d.s2d_stem_conv, plain):
            want = fn(jnp.asarray(x), jnp.asarray(k))
            np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), want,
                                       rtol=0, atol=OP_TOL)
            jgx, jgk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k), fn)
            np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), jgx, rtol=0,
                                       atol=OP_TOL)
            np.testing.assert_allclose(gk.permute(2, 3, 1, 0).numpy(), jgk, rtol=0,
                                       atol=OP_TOL * max(1.0, float(np.abs(jgk).max())))


class TestDepthwise:
    def test_policy_and_pads_are_jax_s(self):
        for c in (8, 144, 145, 960):
            for s in (1, 2):
                assert tdw.shifted_wins(c, s) == jdw.shifted_wins(c, s)
        assert tdw.SHIFTED_MAX_CHANNELS == jdw.SHIFTED_MAX_CHANNELS
        for hw in ((5, 8), (9, 4), (1, 1), (64, 80)):
            for k in (1, 3, 5):
                for s in (1, 2):
                    assert tdw.same_pads(hw, k, s) == tuple(map(tuple, jdw.same_pads(hw, k, s)))

    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("hw", [(12, 16), (9, 7)])
    def test_value_and_gradient(self, stride, hw):
        rng = np.random.default_rng(stride * 10 + hw[0])
        c = 24
        x = rng.normal(size=(2, *hw, c)).astype(np.float32)
        k = rng.normal(0, 0.3, size=(3, 3, 1, c)).astype(np.float32)
        want = jdw.depthwise_conv_shifted(jnp.asarray(x), jnp.asarray(k), stride)
        r = rng.normal(size=want.shape).astype(np.float32)
        xt, kt = nchw(x).requires_grad_(), oihw(k).requires_grad_()
        yt = tdw.depthwise_conv_shifted(xt, kt, stride)
        np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=OP_TOL)
        gx, gk = torch.autograd.grad((yt.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum(),
                                     [xt, kt])
        jgx, jgk = jax.grad(lambda a, b: jnp.sum(jdw.depthwise_conv_shifted(a, b, stride) * r),
                            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
        np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), jgx, rtol=0, atol=OP_TOL)
        np.testing.assert_allclose(gk.permute(2, 3, 1, 0).numpy(), jgk, rtol=0,
                                   atol=OP_TOL * max(1.0, float(np.abs(jgk).max())))

    def test_bf16_input_returns_bf16_from_an_f32_sum(self):
        x = torch.randn(1, 8, 5, 6, generator=torch.Generator().manual_seed(0)).bfloat16()
        k = torch.randn(8, 1, 3, 3, generator=torch.Generator().manual_seed(1))
        y = tdw.depthwise_conv_shifted(x, k)
        assert y.dtype == torch.bfloat16
        ref = torch.nn.functional.conv2d(x.float(), k, None, 1, 1, 1, 8)
        torch.testing.assert_close(y.float(), ref.bfloat16().float(), rtol=1e-2, atol=1e-2)


# --- the flagged TINY model ---------------------------------------------------

def jax_init(cfg: jcfg.ModelConfig, seed: int = 0) -> dict:
    """A seeded JAX init, its BatchNorm statistics and affine parameters
    moved off the identity."""
    rng = np.random.default_rng(seed)
    jm, _ = create_model(cfg)
    x0 = jnp.zeros((1, *cfg.input_size, 3), jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(lambda key: jm.init(key, x0, train=False))(
        jax.random.PRNGKey(seed)))
    stats = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
                         v["batch_stats"])
    return jm, {"params": v["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def flagged():
    cfg = jcfg.ModelConfig(**TINY, dtype="float32", **FLAGS)
    jm, v = jax_init(cfg)
    return jm, v


def sites(model) -> dict[str, int]:
    count: dict[str, int] = {}
    for m in model.modules():
        count[type(m).__name__] = count.get(type(m).__name__, 0) + 1
    return count


def depthwise_sites(model) -> list:
    return [m for m in model.modules() if getattr(m, "groups", 1) > 1]


def test_flagged_sites_are_the_jax_model_s():
    """The port routes the flags to the JAX ``ConvBN``'s sites: the stem,
    and the depthwise convs where ``shifted_wins`` holds (stride 1, at most
    144 channels: 8 of TINY's 17); in a quantized model no stem, and the
    depthwise sites' float branch."""
    cfg = tcfg.ModelConfig(**TINY, dtype="float32", **FLAGS)
    for model, s2d_cls, shifted_cls in ((Yolact(cfg), S2DConv, ShiftedConv),
                                        (Yolact(cfg, train=True), TrainS2DConv,
                                         TrainShiftedConv),
                                        (Yolact(tcfg.ModelConfig(**FLAGS)), S2DConv,
                                         ShiftedConv)):
        assert isinstance(model.MobileNetV2_0.ConvBN_0.Conv_0, s2d_cls)
        assert sum(isinstance(m, s2d_cls) for m in model.modules()) == 1
        dws = depthwise_sites(model)
        assert len(dws) == 17
        for m in dws:
            assert isinstance(m, shifted_cls) == jdw.shifted_wins(m.groups, m.stride)
    assert sum(isinstance(m, ShiftedConv) for m in Yolact(cfg).modules()) == 8
    q = Yolact(dataclasses.replace(cfg, quantized=True))
    assert type(q.MobileNetV2_0.ConvBN_0.Conv_0) is QConv
    assert [m.shifted for m in depthwise_sites(q)] == [
        jdw.shifted_wins(m.groups, m.stride) for m in depthwise_sites(q)]
    qat = Yolact(dataclasses.replace(cfg, quantized=True, qat=True), train=True)
    assert not any(isinstance(m, (TrainS2DConv, TrainShiftedConv)) for m in qat.modules())
    assert not any(isinstance(m, (S2DConv, ShiftedConv)) for m in Yolact(
        tcfg.ModelConfig(**TINY)).modules())


# The flagged serving forward, f32, against the JAX flagged forward and the
# port's unflagged one: the shifted sum runs tap by tap where the convs sum
# in their own orders; measured at most 4.4e-7 of the largest value.
SERVE_REL = 2e-6


@pytest.mark.parametrize("input_hw", [(48, 64), (50, 66)])
def test_flagged_serve_forward_matches_jax(flagged, input_hw):
    """(50, 66): odd sizes below the stem, where SAME pads one side."""
    jm, v = flagged
    x = np.random.default_rng(3).uniform(-1, 1, (2, *input_hw, 3)).astype(np.float32)
    want = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(fold_batchnorm(v),
                                                                 jnp.asarray(x))
    cfg = tcfg.ModelConfig(**dict(TINY, input_size=input_hw), dtype="float32", **FLAGS)
    model = Yolact(cfg).eval()
    model.load_state_dict(carry_across(flat(v), model))
    plain = Yolact(dataclasses.replace(cfg, s2d_stem=False, depthwise_shifted=False)).eval()
    plain.load_state_dict(carry_across(flat(v), plain))
    with torch.inference_mode():
        got, ref = model(torch.from_numpy(x)), plain(torch.from_numpy(x))
    for field in FIELDS:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=SERVE_REL * scale, err_msg=field)
        np.testing.assert_allclose(a, getattr(ref, field).numpy(), rtol=0,
                                   atol=SERVE_REL * scale, err_msg=field)


# The flagged training forward and its gradients, f32, on batch statistics:
# the outputs within 1e-4 of the largest value (measured 5.1e-5; the
# unflagged model 5.4e-5); the gradients by group, relative to the group's
# norm: the FPN and the heads within 1e-4 (measured 4.9e-5), the backbone
# within 0.1 (measured 4.7e-2, and 6.7e-2 for the unflagged model: XLA's
# f32 batch statistics over TINY's batch of 2 amplify rounding noise in the
# backbone's BatchNorms, as tests/test_torch_train_step.py sets out).
TRAIN_OUT_REL = 1e-4
TRAIN_GRAD_REL = {"MobileNetV2_0": 0.1, "FPN_0": 1e-4, "PredictionHead_0": 1e-4,
                  "ProtoNet_0": 1e-4, "SemanticHead_0": 1e-4}


def test_flagged_train_forward_and_gradients_match_jax(flagged):
    jm, v = flagged
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, *TINY["input_size"], 3)).astype(np.float32)
    cfg = tcfg.ModelConfig(**TINY, dtype="float32", **FLAGS)
    model = Yolact(cfg, train=True)
    model.load_state_dict(train_state_from_tree(flat(v), model))
    model.train()
    out = model(torch.from_numpy(x))
    rs = {f: rng.normal(size=getattr(out, f).shape).astype(np.float32) for f in FIELDS}

    def jloss(params):
        o, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                        train=True, mutable=["batch_stats"])
        return sum(jnp.sum(getattr(o, f) * rs[f]) for f in FIELDS), o

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    for f in FIELDS:
        b = np.asarray(getattr(jout, f))
        np.testing.assert_allclose(getattr(out, f).detach().numpy(), b, rtol=0,
                                   atol=TRAIN_OUT_REL * max(1.0, float(np.abs(b).max())),
                                   err_msg=f)
    loss = sum((getattr(out, f) * torch.from_numpy(rs[f])).sum() for f in FIELDS)
    names = [n for n, _ in model.named_parameters()]
    grads = train_state_to_tree(dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters())))))
    want = flat({"params": jgrad})
    assert sorted(k for k in grads if k.startswith("params/")) == sorted(want)
    for group, tol in TRAIN_GRAD_REL.items():
        keys = [k for k in want if f"/{group}/" in k]
        g = np.concatenate([grads[k].ravel() for k in keys])
        w = np.concatenate([want[k].ravel() for k in keys])
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w), group


# The flagged int8 forward (the stem stays the int8 conv; the float-served
# depthwise sites take the shifted form, rounded to bf16 before the bias),
# f32, on the JAX package's prepared tree: exact (measured).


def test_flagged_int8_forward_matches_jax():
    cfg = jcfg.ModelConfig(**TINY, dtype="float32", quantized=True, **FLAGS)
    jm, v = jax_init(cfg, seed=1)
    rng = np.random.default_rng(7)
    batches = [rng.normal(0, 1, (2, *TINY["input_size"], 3)).astype(np.float32)
               for _ in range(2)]
    folded = fold_batchnorm(v)
    amax = jax_calibrate_amax(jm, folded, [jnp.asarray(b) for b in batches])
    prepared = quantize_prepared(folded, amax)
    x = rng.normal(0, 1, (2, *TINY["input_size"], 3)).astype(np.float32)
    want = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(prepared, jnp.asarray(x))
    model = Yolact(tcfg.ModelConfig(**TINY, dtype="float32", quantized=True, **FLAGS))
    load_prepared(model, carry_across(flat(prepared)))
    assert sum(m.shifted and m.branch == "float" for m in model.modules()
               if isinstance(m, QConv)) == 8
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
