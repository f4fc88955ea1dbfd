"""The port's train step in its other modes against the JAX package's, on
the CPU: TINY in bfloat16 (``ModelConfig``'s default dtype) and TINY with
quantization-aware training (``quantized=True, qat=True``, f32).  The port's
own initialisation is carried into the JAX step (``make_train_step`` with
``make_optimizer``), two steps on the same batches.

Tolerances:
- both: the parameters after step 1 unchanged in both packages (lr 0).
- bfloat16: the total loss within 3e-2 relative at both steps (measured
  1.7e-2 and 4.6e-4), each component within 8e-2 (measured 4.5e-2).
  Compiled XLA keeps some bf16 intermediates unrounded inside its fusions,
  where eager torch rounds each op's result to bf16.
- QAT: at step 2 every component within 1e-5 relative (measured 2.7e-7).
  At step 1 the total within 1e-2 (measured 1.0e-3) and each component
  within 2e-2 (measured 2.6e-3): an activation entering a fake-quantized
  conv a last-bit rounding away from a quantization boundary flips to the
  next level, and TINY's 24-value BatchNorms amplify it (on the JAX
  package's own initialisation the same batch moved the mask loss 9%).
  ``tests/test_torch_train_loss.py`` holds ``fake_quantize`` and the QAT
  conv exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core.config import ModelConfig as JaxModelConfig
from tod_tpu.core.config import TrainConfig as JaxTrainConfig
from tod_tpu.models.yolact import create_model
from tod_tpu.train import SyntheticDetectionData as JaxData
from tod_tpu.train.trainer import TrainState, make_optimizer, make_train_step
from tod_tpu_torch.core.config import ModelConfig, TrainConfig
from tod_tpu_torch.train import Trainer
from tod_tpu_torch.train.trainer import device_batch

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8, nms_top_k=8, max_detections=4)
TTRAIN = dict(batch_size=2, learning_rate=5e-3, warmup_steps=2, total_steps=20)
MODES = {"bf16": {}, "qat": {"quantized": True, "qat": True, "dtype": "float32"}}


def unflatten(tree: dict) -> dict:
    out: dict = {}
    for key, value in tree.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return out


def two_steps(mode: str) -> dict:
    """Two steps of both packages from the port's initialisation."""
    mcfg = dict(TINY, **MODES[mode])
    pt = Trainer(ModelConfig(**mcfg), TrainConfig(**TTRAIN), device="cpu")
    init = pt.tree()
    variables = unflatten(init)
    jcfg = JaxTrainConfig(**TTRAIN)
    model, anchors = create_model(JaxModelConfig(**mcfg))
    tx = make_optimizer(jcfg)
    state = TrainState(variables["params"], variables["batch_stats"],
                       tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step(model, jnp.asarray(anchors), tx, jcfg))
    data = JaxData((48, 64), batch_size=2, seed=0)
    out = {"init": init, "jax": [], "port": [], "port_tree": [], "jax_tree": []}
    for _ in range(2):
        b = data.next_batch()
        state, jm = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        pm = pt.train_step(device_batch(b, torch.device("cpu")))
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
        out["port_tree"].append(pt.tree())
        out["jax_tree"].append({f"params/{k}": v for k, v in _flat(state.params).items()})
    return out


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request):
    return request.param, two_steps(request.param)


def relative(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def test_first_update_leaves_the_parameters_unchanged(run):
    _, out = run
    for key, value in out["init"].items():
        if key.startswith("params/"):
            np.testing.assert_array_equal(out["port_tree"][0][key], value)
            np.testing.assert_array_equal(out["jax_tree"][0][key], value)


def test_losses(run):
    mode, out = run
    (j1, j2), (p1, p2) = out["jax"], out["port"]
    if mode == "bf16":
        for j, p in ((j1, p1), (j2, p2)):
            assert relative(p["loss"], j["loss"]) <= 3e-2
            for key in ("cls", "box", "mask", "sem"):
                assert relative(p[key], j[key]) <= 8e-2, key
    else:
        for key in j2:
            assert relative(p2[key], j2[key]) <= 1e-5, key
        assert relative(p1["loss"], j1["loss"]) <= 1e-2
        for key in ("cls", "box", "mask", "sem"):
            assert relative(p1[key], j1[key]) <= 2e-2, key


def test_the_steps_move_the_parameters(run):
    _, out = run
    moved = [k for k, v in out["init"].items()
             if k.startswith("params/") and not np.array_equal(out["port_tree"][1][k], v)]
    assert len(moved) > 0.9 * sum(k.startswith("params/") for k in out["init"])
