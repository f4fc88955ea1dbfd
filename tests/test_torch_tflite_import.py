"""The port's tflite importer (``models/tflite_import.py``, its own
FlatBuffer reader) against the JAX package's (TensorFlow's interpreter):
``read_conv_weights`` bit for bit on TF-built models, float and
dynamic-range quantized, and on the FlatBuffer ``chip_smoke.py`` writes
with ``struct``; the mapped flat tree and the report bit for bit
``import_tflite(..., model=)``'s on a MobileNetV2 mirror, its folded
BatchNorm biases routed to ``BatchNorm_0``; the result carried into the
port's backbone against the keras model."""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import chip_smoke  # noqa: E402
from test_tflite_import import REF_BLOB, _keras_mnv2_mirror  # noqa: E402
from tod_tpu.core.config import ModelConfig as JaxModelConfig  # noqa: E402
from tod_tpu.models import create_model  # noqa: E402
from tod_tpu.models import tflite_import as jtfl  # noqa: E402
from tod_tpu_torch.core.config import ModelConfig  # noqa: E402
from tod_tpu_torch.core.weights import carry_across  # noqa: E402
from tod_tpu_torch.models import tflite_import as ttfl  # noqa: E402
from tod_tpu_torch.models.yolact import Yolact  # noqa: E402

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

TINY = dict(input_size=(48, 64), width_mult=0.35, fpn_channels=16, proto_channels=16,
            head_channels=16, num_prototypes=8)


def flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_same_convs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.op_index, g.op_name) == (w.op_index, w.op_name)
        assert g.kernel.dtype == w.kernel.dtype and g.kernel.shape == w.kernel.shape
        np.testing.assert_array_equal(g.kernel, w.kernel)
        assert (g.bias is None) == (w.bias is None)
        if g.bias is not None:
            assert g.bias.dtype == w.bias.dtype
            np.testing.assert_array_equal(g.bias, w.bias)


@pytest.fixture(scope="module")
def small_blobs(tmp_path_factory):
    """conv -> depthwise -> conv -> dense, float and dynamic-range int8."""
    rng = np.random.default_rng(0)
    tf.keras.utils.set_random_seed(0)
    L = tf.keras.layers
    model = tf.keras.Sequential([L.Input((16, 16, 3)), L.Conv2D(8, 3, padding="same"),
                                 L.DepthwiseConv2D(3, padding="same"),
                                 L.Conv2D(4, 1, padding="same"), L.Flatten(), L.Dense(5)])
    for layer in model.layers:
        layer.set_weights([rng.normal(size=w.shape).astype(np.float32)
                           for w in layer.get_weights()])
    out = tmp_path_factory.mktemp("tfl")
    paths = []
    for quantized in (False, True):
        conv = tf.lite.TFLiteConverter.from_keras_model(model)
        if quantized:
            conv.optimizations = [tf.lite.Optimize.DEFAULT]
        path = out / f"small{int(quantized)}.tflite"
        path.write_bytes(conv.convert())
        paths.append(str(path))
    return paths


def test_read_conv_weights_equals_jax_bit_for_bit(small_blobs):
    for path in small_blobs:
        got = ttfl.read_conv_weights(path)
        assert [c.op_name for c in got] == ["CONV_2D", "DEPTHWISE_CONV_2D", "CONV_2D",
                                            "FULLY_CONNECTED"]
        assert_same_convs(got, jtfl.read_conv_weights(path))
    quantized = ttfl.read_conv_weights(small_blobs[1])
    assert quantized[3].kernel.dtype == np.float64  # an int8 kernel dequantized


def struct_ops(np_rng):
    return [(3, np_rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
             np_rng.normal(size=8).astype(np.float32)),
            (4, np_rng.normal(size=(1, 3, 3, 8)).astype(np.float32),
             np_rng.normal(size=8).astype(np.float32)),
            (9, (np_rng.integers(-127, 128, (5, 16)).astype(np.int8),
                 np_rng.uniform(0.01, 0.1, 5).astype(np.float32)),
             np_rng.normal(size=5).astype(np.float32))]


def test_struct_written_flatbuffer(tmp_path):
    """``chip_smoke.tflite_flatbuffer`` (objects laid out parent first,
    where TensorFlow's writer lays them out back to front): TensorFlow's
    interpreter and the port read the same weights, the known ones."""
    ops = struct_ops(np.random.default_rng(1))
    path = tmp_path / "struct.tflite"
    path.write_bytes(chip_smoke.tflite_flatbuffer(np, ops))
    got = ttfl.read_conv_weights(path)
    assert_same_convs(got, jtfl.read_conv_weights(str(path)))
    np.testing.assert_array_equal(got[0].kernel, ops[0][1].transpose(1, 2, 3, 0))
    np.testing.assert_array_equal(got[1].kernel, ops[1][1].reshape(3, 3, 8)[:, :, None, :])
    values, scales = ops[2][1]
    np.testing.assert_array_equal(got[2].kernel,
                                  (values.astype(np.float32) * scales[:, None].astype(
                                      np.float64)).T)
    np.testing.assert_array_equal(got[2].bias, ops[2][2])


def test_refusals_by_name(tmp_path):
    ops = struct_ops(np.random.default_rng(2))
    blob = bytearray(chip_smoke.tflite_flatbuffer(np, ops[:1]))
    # the kernel tensor's type byte: STRING (5)
    model = ttfl._Table(bytes(blob), int.from_bytes(blob[:4], "little"))
    kernel = model.tables(ttfl.MODEL_SUBGRAPHS)[0].tables(ttfl.SUBGRAPH_TENSORS)[0]
    blob[kernel.pos + kernel._field(ttfl.TENSOR_TYPE)] = 5
    (tmp_path / "s.tflite").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="STRING"):
        ttfl.read_conv_weights(tmp_path / "s.tflite")


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    model = _keras_mnv2_mirror()
    path = tmp_path_factory.mktemp("tfl") / "mnv2_mirror.tflite"
    path.write_bytes(tf.lite.TFLiteConverter.from_keras_model(model).convert())
    return str(path), model


@pytest.fixture(scope="module")
def jax_tiny():
    jm, _ = create_model(JaxModelConfig(**TINY))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 48, 64, 3), jnp.bfloat16), train=False))(
        jax.random.PRNGKey(0))
    return jm, jax.tree.map(np.asarray, v)


def test_conv_order_is_the_jax_model_s(jax_tiny):
    jm, _ = jax_tiny
    want = jtfl.conv_order_from_model(jm, (48, 64))
    assert ttfl.conv_order_from_model(Yolact(ModelConfig(**TINY))) == want


def test_mapped_tree_and_report_equal_jax_bit_for_bit(mirror, jax_tiny):
    """The flagship graph's key-sorted tree (a jitted init) mapped in the
    model's definition order; every leaf, the folded biases routed into
    ``BatchNorm_0`` and the report's four lists."""
    path, _ = mirror
    jm, v = jax_tiny
    want_params, want_report = jtfl.import_tflite(path, v["params"], model=jm,
                                                  input_hw=(48, 64))
    tree = flat({"params": v["params"], "batch_stats": v["batch_stats"]})
    got, report = ttfl.import_tflite(path, tree, model=Yolact(ModelConfig(**TINY)))
    assert report == want_report
    assert len(report["mapped"]) == 51 and not report["unmapped_ops"]
    want = flat({"params": want_params})
    assert set(got) == set(tree)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    for key in tree:
        if key.startswith("batch_stats/"):
            np.testing.assert_array_equal(got[key], tree[key])
    routed = [k for k in got if k.endswith("BatchNorm_0/bias") and "MobileNetV2_0" in k]
    assert routed and all(np.any(got[k] != tree[k]) for k in routed)


def test_without_model_uses_the_tree_s_order(mirror, jax_tiny):
    """An unsorted tree (a plain init's definition order) maps the same
    without ``model``; ``order`` against another tree is refused."""
    path, _ = mirror
    jm, v = jax_tiny
    order = ttfl.conv_order_from_model(Yolact(ModelConfig(**TINY)))
    tree = flat({"params": v["params"], "batch_stats": v["batch_stats"]})
    by_site = sorted(tree, key=lambda k: (order.index(k.split("/", 1)[1].rsplit("/", 1)[0])
                                          if k.split("/", 1)[1].rsplit("/", 1)[0] in order
                                          else len(order), k))
    ordered = {k: tree[k] for k in by_site}
    a, ra = ttfl.import_tflite(path, ordered)
    b, rb = ttfl.import_tflite(path, tree, model=Yolact(ModelConfig(**TINY)))
    assert ra == rb and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="order/tree mismatch"):
        ttfl.map_convs_to_params([], tree, order=order[:-1])


def test_carried_backbone_matches_keras(mirror, jax_tiny):
    """The imported tree through ``carry_across`` into the port's f32
    model: its backbone against the keras model, within 2e-3 of the
    largest value (the JAX package's tolerance; the converter folds the
    BatchNorms, the port folds the init's identity ones)."""
    path, keras_model = mirror
    _, v = jax_tiny
    model = Yolact(ModelConfig(**TINY, dtype="float32"))
    tree, _ = ttfl.import_tflite(path, flat({"params": v["params"],
                                             "batch_stats": v["batch_stats"]}), model=model)
    model.load_state_dict(carry_across(tree, model))
    xi = np.random.default_rng(11).normal(0, 1, (1, 48, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        ours = model.eval().MobileNetV2_0(torch.from_numpy(xi).permute(0, 3, 1, 2))
    for a, b in zip(ours, keras_model(xi, training=False)):
        a, b = a.permute(0, 2, 3, 1).numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=2e-3 * max(np.abs(b).max(), 1e-3))


@pytest.mark.skipif(not REF_BLOB.exists(), reason="reference blob not in this checkout")
def test_reference_blob_maps_onto_flagship():
    from tod_tpu_torch.core.weights import read_tree

    _, report = ttfl.import_tflite(str(REF_BLOB), read_tree(), model=Yolact(ModelConfig()))
    assert len(report["mapped"]) > 0
