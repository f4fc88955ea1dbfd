"""The port's int8 inference (M12) against the JAX package on the CPU:
``quantize_symmetric``, each kind of conv site through ``QConv`` against
``Conv8`` (static, dynamic and float serve), the prepared tree against
``prepare_int8_params``, the whole int8 forward, the engine's calibration
and ``serve_step_plan``, ``--int8`` through the app, and the refusal of
QAT.

Where a test claims bit-equality with the JAX package's float-simulated
integer convolution (an f32 sum), it asserts ``sum |xq| * |wq| < 2^24`` on
its inputs, below which that f32 sum is exact.  The JAX functions run
jitted, as the JAX package serves and calibrates: compiled XLA computes
``amax / 127`` as a product with the reciprocal and fuses ``acc * s + bias``
into one multiply-add, and the port follows that graph.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tod_tpu.core import config as jcfg
from tod_tpu.models import create_model
from tod_tpu.models.mobilenetv2 import ConvBN as JaxConvBN
from tod_tpu.models.prepare import calibrate_amax as jax_calibrate_amax
from tod_tpu.models.prepare import fold_batchnorm, quantize_prepared
from tod_tpu.models.qconv import Conv8
from tod_tpu.models.qconv import quantize_symmetric as jax_quantize_symmetric
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.core.weights import carry_across
from tod_tpu_torch.kernels import qconv as qconv_mod
from tod_tpu_torch.models.prepare import calibrate_amax, prepare_int8_params
from tod_tpu_torch.models.prepare import quantize_prepared as port_quantize_prepared
from tod_tpu_torch.models.qconv import (
    QConv,
    _scale,
    conv_sites,
    load_prepared,
    quantize_symmetric,
)
from tod_tpu_torch.models.yolact import Yolact

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

# tests/test_prepare.py's TINY model
TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8)
DTYPES = ("float32", "bfloat16")
BOUND = 2 ** 24
BF16_AMAX = 2 ** -4  # relative; measured worst 3.7% (an amax of 0.0752 against 0.0781)
# the sites whose input has passed a bilinear upsample, which
# jax.image.resize and F.interpolate round differently in f32 (the float
# forward's tolerance, tests/test_torch_model.py)
AFTER_UPSAMPLE = ("FPN_0.smooth3", "FPN_0.smooth4", "PredictionHead_0", "ProtoNet_0",
                  "SemanticHead_0")


def flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def to_port(x_nhwc: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))).to(
        getattr(torch, dtype))


def from_port(y: torch.Tensor) -> np.ndarray:
    return y.float().permute(0, 2, 3, 1).numpy()


def in_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """``x`` rounded to ``dtype`` (as f32), so both packages read the same
    activations."""
    return np.asarray(jnp.asarray(x).astype(getattr(jnp, dtype)).astype(jnp.float32))


def assert_sum_bound(xq: torch.Tensor, kq: torch.Tensor, stride: int, groups: int) -> None:
    """``sum |xq| * |wq|`` of every output below 2^24: the JAX package's f32
    sum of the integer products is then exact."""
    k = kq.shape[-1]
    (pt, pb), (pl, pr) = qconv_mod._pads(xq, k, stride)
    worst = F.conv2d(F.pad(xq.abs().double(), (pl, pr, pt, pb)), kq.abs().double(), None,
                     stride, 0, 1, groups).max().item()
    assert 0 < worst < BOUND, worst


@pytest.mark.parametrize("case", ["per_cout", "per_tensor", "per_sample"])
def test_quantize_symmetric_matches_jitted_jax(case):
    """A kernel per output channel (HWIO against OIHW), a tensor, and a batch
    per sample (NHWC against NCHW): the same int8 values and scales as the
    jitted JAX function."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 1, (3, 3, 24, 40)) * rng.uniform(0.01, 10, 40)).astype(np.float32)
    axis, dim, to_torch = {
        "per_cout": ((0, 1, 2), (1, 2, 3), (3, 2, 0, 1)),
        "per_tensor": (None, None, (3, 2, 0, 1)),
        "per_sample": ((1, 2, 3), (1, 2, 3), (0, 3, 1, 2)),
    }[case]
    wq, ws = jax.jit(lambda a: jax_quantize_symmetric(a, axis=axis))(jnp.asarray(x))
    q, s = quantize_symmetric(torch.from_numpy(np.ascontiguousarray(x.transpose(to_torch))),
                              dim=dim)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq).transpose(to_torch))
    np.testing.assert_array_equal(s.numpy().reshape(-1), np.asarray(ws).reshape(-1))
    assert q.dtype == torch.int8 and s.dtype == torch.float32


# (cin, cout, k, stride, h, w, groups): 1x1; 3x3 stride 1; 3x3 stride 2 on
# even sizes (SAME pads 0 before, 1 after); the cin-3 stem (K = 27); a
# depthwise site (quantize_depthwise)
KINDS = {
    "1x1": (24, 40, 1, 1, 9, 11, 1),
    "3x3": (16, 24, 3, 1, 9, 11, 1),
    "3x3s2": (16, 24, 3, 2, 10, 12, 1),
    "stem": (3, 32, 3, 2, 48, 64, 1),
    "depthwise": (48, 48, 3, 2, 10, 12, 48),
}


def site_inputs(kind: str, seed: int = 0, batch: int = 2):
    cin, cout, k, stride, h, w, groups = KINDS[kind]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (batch, h, w, cin)).astype(np.float32)
    kq = rng.integers(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    ws = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    sx = np.float32(np.abs(x).max() / 100.0)  # some activations clip at +-127
    bias = rng.normal(0, 1, cout).astype(np.float32)
    return x, kq, ws, sx, bias


def port_static(kind: str, kq, ws, sx, bias, bn: bool) -> QConv:
    cin, cout, k, stride, _, _, groups = KINDS[kind]
    q = QConv(cin, cout, k, stride, groups, bn=bn)
    q.set_branch("static")
    q.load_state_dict({"kernel_q": torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 2, 0, 1))),
                       "w_scale": torch.from_numpy(ws), "act_scale": torch.tensor(sx),
                       "bias": torch.from_numpy(bias)})
    return q


def identity_bn(cout: int, beta: np.ndarray) -> tuple[dict, dict]:
    """A folded BatchNorm's leaves: scale 1, mean 0, var 1 - eps."""
    return ({"scale": np.ones(cout, np.float32), "bias": beta},
            {"mean": np.zeros(cout, np.float32), "var": np.full(cout, 1 - 1e-5, np.float32)})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_static_site_matches_conv8(kind, dtype):
    """A prepared site, bit for bit: as a plain ``Conv8`` site (the bias in
    f32 before the cast, one fused multiply-add) and as a ConvBN site (the
    cast, then the folded BatchNorm's bias in f32), in f32 and bf16."""
    cin, cout, k, stride, h, w, groups = KINDS[kind]
    x, kq, ws, sx, bias = site_inputs(kind)
    x = in_dtype(x, dtype)
    xt = to_port(x, dtype)
    xq = qconv_mod.quantize_activations(xt, torch.tensor([sx, sx]), divide=False)
    assert_sum_bound(xq, torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 2, 0, 1))),
                     stride, groups)
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x).astype(jdt)

    plain = Conv8(cout, (k, k), strides=stride, feature_group_count=groups, dtype=jdt,
                  native_int8=False)
    params = {"params": {"kernel_q": kq, "w_scale": ws, "act_scale": sx, "bias": bias}}
    want = np.asarray(jax.jit(plain.apply)(params, xj).astype(jnp.float32))
    with torch.inference_mode():
        got = from_port(port_static(kind, kq, ws, sx, bias, bn=False)(xt))
    np.testing.assert_array_equal(got, want)

    convbn = JaxConvBN(cout, kernel=k, stride=stride, groups=groups, act=False, dtype=jdt,
                       quantized=True)
    bn_params, bn_stats = identity_bn(cout, bias)
    variables = {"params": {"Conv_0": {"kernel_q": kq, "w_scale": ws, "act_scale": sx},
                            "BatchNorm_0": bn_params}, "batch_stats": {"BatchNorm_0": bn_stats}}
    want = np.asarray(jax.jit(convbn.apply)(variables, xj).astype(jnp.float32))
    with torch.inference_mode():
        got = from_port(port_static(kind, kq, ws, sx, bias, bn=True)(xt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["3x3s2", "stem", "depthwise"])
def test_dynamic_site_matches_conv8(kind, dtype):
    """The calibration branch: the weights quantized per call and output
    channel, each sample's activations by its own amax (batch 2, the two
    samples at scales 10x apart), exact in f32 and bf16."""
    cin, cout, k, stride, h, w, groups = KINDS[kind]
    x, kq, ws, _, bias = site_inputs(kind, seed=1)
    x[1] *= 10.0
    x = in_dtype(x, dtype)
    kernel = (kq.astype(np.float32) * ws).astype(np.float32)
    jdt = getattr(jnp, dtype)
    conv = Conv8(cout, (k, k), strides=stride, feature_group_count=groups, dtype=jdt,
                 native_int8=False)
    want = np.asarray(jax.jit(conv.apply)({"params": {"kernel": kernel, "bias": bias}},
                                          jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    q = QConv(cin, cout, k, stride, groups)
    oihw = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
    q.load_state_dict({"weight": torch.from_numpy(oihw), "bias": torch.from_numpy(bias)})
    xt = to_port(x, dtype)
    wq, _ = quantize_symmetric(q.weight.detach(), dim=(1, 2, 3))
    sx = _scale(torch.from_numpy(np.abs(x).reshape(2, -1).max(axis=1)), 127)
    assert_sum_bound(qconv_mod.quantize_activations(xt, sx, divide=True), wq, stride, groups)
    with torch.inference_mode():
        got = from_port(q(xt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_float_serve_depthwise_matches_convbn(dtype):
    """A depthwise site whose kernel the preparation cast to bf16, with its
    folded BatchNorm: the conv over bf16 values summed in f32, the bias in
    f32, one rounding.  Exact in a bf16 model; in an f32 model compiled XLA
    sums the nine products in its own order, so within 2e-6 (the sums are
    O(1): a few f32 ulps)."""
    cin, cout, k, stride, h, w, groups = KINDS["depthwise"]
    rng = np.random.default_rng(2)
    x = in_dtype(rng.normal(0, 2, (2, h, w, cin)).astype(np.float32), dtype)
    kernel = np.asarray(jnp.asarray(rng.normal(0, 0.3, (k, k, 1, cout)).astype(np.float32))
                        .astype(jnp.bfloat16))
    beta = rng.normal(0, 1, cout).astype(np.float32)
    jdt = getattr(jnp, dtype)
    convbn = JaxConvBN(cout, kernel=k, stride=stride, groups=groups, act=True, dtype=jdt,
                       quantized=True)
    bn_params, bn_stats = identity_bn(cout, beta)
    variables = {"params": {"Conv_0": {"kernel": kernel}, "BatchNorm_0": bn_params},
                 "batch_stats": {"BatchNorm_0": bn_stats}}
    want = np.asarray(jax.jit(convbn.apply)(variables, jnp.asarray(x).astype(jdt))
                      .astype(jnp.float32))
    q = QConv(cin, cout, k, stride, groups, bn=True)
    q.set_branch("float")
    q.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        kernel.astype(np.float32).transpose(3, 2, 0, 1))).bfloat16(),
        "bias": torch.from_numpy(beta)})
    with torch.inference_mode():
        got = from_port(q(to_port(x, dtype)).clamp(0.0, 6.0))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_qconv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 8, 5, 5))
    kq = torch.zeros((4, 8, 3, 3), dtype=torch.int8)
    ws, sx = torch.ones(4), torch.ones(())
    bad = [
        dict(x=x.half()),
        dict(kernel_q=torch.zeros((4, 8, 5, 5), dtype=torch.int8)),
        dict(kernel_q=kq.float()),
        dict(groups=2),
        dict(w_scale=torch.ones(3)),
        dict(sx=torch.ones(2)),
        dict(bias=torch.ones(4, dtype=torch.float64)),
        dict(x=torch.zeros((1, 5, 5, 8)).permute(0, 3, 1, 2)),
        dict(x=torch.zeros((1, 8, 5, 5), device="meta")),
    ]
    for change in bad:
        args = dict(x=x, kernel_q=kq, w_scale=ws, sx=sx, bias=torch.zeros(4))
        args.update(change)
        if "x" in change and change["x"].device.type == "meta":
            args.update(kernel_q=kq.to("meta"), w_scale=ws.to("meta"), sx=sx.to("meta"),
                        bias=torch.zeros(4, device="meta"))
        with pytest.raises(ValueError):
            qconv_mod.qconv(**args)
    assert qconv_mod.qconv.launches == 0


@pytest.fixture(scope="module", params=DTYPES)
def tiny(request):
    """The TINY quantized model in ``dtype`` on both sides: a seeded JAX
    init with BatchNorm statistics moved off the identity, two calibration
    batches of two frames, and the JAX package's preparation
    (``prepare_int8_params``'s fold, calibration and quantization)."""
    dtype = request.param
    rng = np.random.default_rng(0)
    jm, _ = create_model(jcfg.ModelConfig(**TINY, dtype=dtype, quantized=True))
    x0 = jnp.zeros((1, *TINY["input_size"], 3), getattr(jnp, dtype))
    v = jax.tree.map(np.asarray, jax.jit(lambda key: jm.init(key, x0, train=False))(
        jax.random.PRNGKey(0)))
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), v["batch_stats"])}
    batches = [in_dtype(rng.normal(0, 1, (2, *TINY["input_size"], 3)).astype(np.float32), dtype)
               for _ in range(2)]
    folded = fold_batchnorm(v)
    amax = flat(jax_calibrate_amax(jm, folded, [jnp.asarray(b).astype(getattr(jnp, dtype))
                                                for b in batches]))
    prepared = quantize_prepared(folded, nest(amax))
    return dict(dtype=dtype, jm=jm, variables=v, batches=batches, amax=amax,
                prepared=prepared)


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for key, v in flat_tree.items():
        d = out
        *parts, last = key.split("/")
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def port_model(dtype: str) -> Yolact:
    return Yolact(tcfg.ModelConfig(**TINY, dtype=dtype, quantized=True))


def test_prepared_tree_matches_jax(tiny):
    """Calibration and quantization against the JAX package's, site by site.
    f32: every amax and every leaf exact.  bf16: the weights' leaves exact;
    the amaxes and activation scales within 2^-4 relative, because compiled
    XLA drops the bf16 roundings inside its fusions (a block's residual sum
    reaches the next quantize unrounded), where the port rounds at every
    cast the JAX model writes, and the difference grows layer by layer."""
    dtype = tiny["dtype"]
    model = port_model(dtype)
    state = carry_across(flat(tiny["variables"]))
    batches = [torch.from_numpy(b).to(getattr(torch, dtype)) for b in tiny["batches"]]
    model.load_state_dict(state)
    amax = calibrate_amax(model, batches)
    want_amax = {k[:-len("/amax")].replace("/", "."): np.float32(a)
                 for k, a in tiny["amax"].items()}
    assert sorted(amax) == sorted(want_amax) and len(amax) == len(conv_sites(model))
    differ = [s for s in conv_sites(model) if amax[s] != want_amax[s]]
    if dtype == "float32":
        assert not differ, f"first differing amax at {differ[0]}: {amax[differ[0]]} != " \
                           f"{want_amax[differ[0]]}"
    else:
        for s in differ:
            assert amax[s] == pytest.approx(want_amax[s], rel=BF16_AMAX), s

    got = prepare_int8_params(port_model(dtype), state, batches)
    want = carry_across(flat(tiny["prepared"]))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key.endswith(".act_scale") and dtype == "bfloat16":
            assert g.item() == pytest.approx(w.item(), rel=BF16_AMAX), key
        else:
            assert torch.equal(g, w), key
    n_q = sum(key.endswith(".kernel_q") for key in got)
    n_dw = sum(v.dtype == torch.bfloat16 for v in got.values())
    assert n_q == 52 and n_dw == 17


def test_int8_forward_matches_jax(tiny):
    """The whole static int8 forward on the JAX package's prepared tree:
    exact in f32; in bf16 within 0.125 absolute on outputs of magnitude up
    to ~10 (a few bf16 ulps), since compiled XLA keeps some bf16 values at
    f32 inside its fusions (see test_prepared_tree_matches_jax)."""
    dtype = tiny["dtype"]
    model = port_model(dtype)
    load_prepared(model, carry_across(flat(tiny["prepared"])))
    x = in_dtype(np.random.default_rng(5).normal(0, 1, (2, *TINY["input_size"], 3))
                 .astype(np.float32), dtype)
    jm = tiny["jm"]
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        tiny["prepared"], jnp.asarray(x).astype(getattr(jnp, dtype)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).to(getattr(torch, dtype)))
    for field in ("loc", "conf", "coeff", "prototypes", "sem_logits"):
        a = getattr(got, field).float().numpy()
        b = np.asarray(getattr(want, field)).astype(np.float32)
        assert a.shape == b.shape, field
        if dtype == "float32":
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.125, err_msg=field)


def test_quantized_depthwise_matches_jax(tiny):
    """``quantize_depthwise``: the depthwise kernels quantized too (each
    then a static site of the int8 kernel's depthwise branch), from the
    same calibrated amaxes: the tree and the f32 forward exact; bf16 as in
    the tests above."""
    dtype = tiny["dtype"]
    amax = {k[:-len("/amax")].replace("/", "."): np.float32(a) for k, a in tiny["amax"].items()}
    folded = fold_batchnorm(tiny["variables"])
    jax_tree = quantize_prepared(folded, nest(tiny["amax"]), quantize_depthwise=True)
    want = carry_across(flat(jax_tree))
    got = port_quantize_prepared(carry_across(flat(tiny["variables"])), amax,
                                 quantize_depthwise=True)
    assert sorted(got) == sorted(want) and sum(k.endswith(".kernel_q") for k in got) == 69
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    model = port_model(dtype)
    load_prepared(model, got)
    x = in_dtype(np.random.default_rng(6).normal(0, 1, (1, *TINY["input_size"], 3))
                 .astype(np.float32), dtype)
    jm = tiny["jm"]
    ref = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        jax_tree, jnp.asarray(x).astype(getattr(jnp, dtype)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x).to(getattr(torch, dtype)))
    for field in ("loc", "sem_logits"):
        a = getattr(out, field).float().numpy()
        b = np.asarray(getattr(ref, field)).astype(np.float32)
        if dtype == "float32":
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.125, err_msg=field)


def test_engine_calibration_matches_jax(tiny):
    """``_calibrate_int8``: 4 synthetic frames (seed 101) preprocessed at the
    model's size through the dynamic branch, then quantized, against the
    JAX engine's.  Every leaf but the activation scales exact; in f32 the
    scales exact but at the sites after a bilinear upsample
    (``AFTER_UPSAMPLE``: there within 1e-6 relative, an f32 ulp or two of
    the amax); in bf16 as in test_prepared_tree_matches_jax."""
    from tod_tpu.runtime.engine import _calibrate_int8 as jax_calibrate_int8
    from tod_tpu_torch.runtime.engine import _calibrate_int8

    dtype = tiny["dtype"]
    cam = dict(width=160, height=120)
    jax_cfg = jcfg.PipelineConfig(camera=jcfg.CameraConfig(**cam),
                                  model=jcfg.ModelConfig(**TINY, dtype=dtype, quantized=True))
    want = carry_across(flat(jax_calibrate_int8(tiny["jm"], jax_cfg,
                                                fold_batchnorm(tiny["variables"]))))
    port_cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(**cam),
                                   model=tcfg.ModelConfig(**TINY, dtype=dtype, quantized=True))
    got = _calibrate_int8(port_cfg, carry_across(flat(tiny["variables"])), torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if not key.endswith(".act_scale"):
            assert torch.equal(got[key], w), key
        elif dtype == "bfloat16":
            assert got[key].item() == pytest.approx(w.item(), rel=BF16_AMAX), key
        elif key.startswith(AFTER_UPSAMPLE):
            assert got[key].item() == pytest.approx(w.item(), rel=1e-6), key
        else:
            assert torch.equal(got[key], w), key


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, quantized, f32, on the pinned weights
    at the pipeline tests' configuration (160x120 camera, model at its
    trained 256x320), the port on the JAX engine's prepared tree."""
    from tod_tpu.runtime.engine import Engine as JaxEngine
    from tod_tpu_torch.core.weights import read_tree
    from tod_tpu_torch.runtime.engine import Engine

    cam, model, planner = (dict(width=160, height=120),
                           dict(input_size=(256, 320), dtype="float32", quantized=True),
                           dict(start_offset=80, backend="tpu"))
    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**cam), model=jcfg.ModelConfig(**model),
                            planner=jcfg.PlannerConfig(**planner)),
        nest(read_tree()), use_pallas=False)
    port = Engine(
        tcfg.PipelineConfig(camera=tcfg.CameraConfig(**cam), model=tcfg.ModelConfig(**model),
                            planner=tcfg.PlannerConfig(**planner)),
        carry_across(flat(jax_engine.params)), device="cpu")
    return jax_engine, port


@pytest.mark.parametrize("t", [0, 7])
def test_engine_serve_step_plan_matches_jax(engines, t):
    """``Engine(quantized)``'s default serve step on a synthetic frame: the
    same plan as the JAX engine's (the pipeline tests' plan tolerances)."""
    from test_torch_pipeline import assert_plans_close, frame
    from tod_tpu_torch.ops.preprocess import pack_frame

    jax_engine, port = engines
    assert all(m.branch in ("static", "float") for m in conv_sites(port.model).values())
    f = frame(t)
    packed = pack_frame(f.rgb, f.depth)
    want = np.asarray(jax_engine._serve_step_plan_fn(jax_engine.params, jnp.asarray(packed)))
    got = port.serve_step_plan(torch.from_numpy(packed))
    assert int(want[0, 0]) > 5
    assert_plans_close(got.numpy(), want)


def counting(monkeypatch) -> list:
    """Count the int8 convolutions run on the CPU (the wrapper counts only
    launches on the card)."""
    calls = []
    real = qconv_mod.plain_qconv

    def spy(*args, **kw):
        calls.append(args[8] if len(args) > 8 else kw.get("divide", False))
        return real(*args, **kw)

    monkeypatch.setattr(qconv_mod, "plain_qconv", spy)
    return calls


@pytest.mark.parametrize("flags", [[], ["--track"], ["--streams", "2"]])
def test_app_serves_int8(flags, monkeypatch, capsys):
    """``--int8`` through the app on the CPU, alone and with ``--track`` and
    ``--streams``: the weights calibrated (the dynamic branch) at load, then
    every dense site static, 68 int8 convolutions a frame (a tick of the
    streams is one batch)."""
    from tod_tpu_torch.app import main

    calls = counting(monkeypatch)
    rc = main(["--int8", "--source", "synthetic", "--frames", "4", "--plan-every", "2",
               "--width", "64", "--height", "48", "--no-server", "--metrics-json", *flags],
              device="cpu")
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    served = metrics["n_ticks"] if "--streams" in flags else metrics["n_frames"]
    assert served >= 1 and metrics["plans_done"] >= 1
    dynamic = sum(calls)
    assert dynamic == 4 * 85  # 4 calibration frames, 85 calls a forward (17 depthwise)
    static = len(calls) - dynamic
    assert static > 0 and static % 68 == 0


def test_qat_is_refused_naming_its_item():
    """QAT is ported (M14): ``ModelConfig(quantized=True, qat=True)``
    validates and builds its serving model (the int8 sites) and its training
    graph (fake-quantized convs); ``qat`` without ``quantized`` is still
    refused."""
    from tod_tpu_torch.models.qconv import QATConv

    cfg = tcfg.PipelineConfig(model=tcfg.ModelConfig(quantized=True, qat=True))
    assert tcfg.validate(cfg) == []
    assert conv_sites(Yolact(cfg.model))
    train = Yolact(cfg.model, train=True)
    assert any(isinstance(m, QATConv) for m in train.modules())
    assert any("requires model.quantized" in p for p in tcfg.validate(
        tcfg.PipelineConfig(model=tcfg.ModelConfig(qat=True))))
