"""The port's train step (M14) against the JAX package's ``Trainer`` on the
CPU: ``tests/test_train.py``'s TINY model in float32, the JAX trainer's own
initialisation carried into ``Trainer`` (``core.weights``), three steps on
the same three batches of the procedural generator.

What agrees how closely, and why not closer:

- The loss components of steps 1 and 2 within 1e-4 relative (measured
  3.1e-5); the parameters after step 1 equal the carried ones bit for bit in
  both (the schedule's lr is 0 at the first update); BatchNorm's running
  statistics after steps 1 and 2 within 1.5e-4 of max(1, |v|) (measured
  8.1e-5).
- The gradient at the carried weights: the FPN, ProtoNet and heads within
  1e-3 relative (measured 1.8e-4); the backbone within 3e-2 (measured
  1.4%).  The backbone's difference is the JAX package's: TINY's deep
  BatchNorms normalize over 24 values a channel, and the f32 rounding of
  their batch statistics is amplified in the backward.  The port's f32
  gradient is within 1e-3 (backbone, measured 2.1e-4) and 2e-4 (the rest,
  measured 5.2e-5) of the same graph run in float64, where the JAX
  package's f32 gradient is 1.4% (backbone) and 2.1e-4 (the rest) away
  from it.
- So Adam's moments after step 1 follow at the gradient's tolerances
  (3e-2 backbone, 1e-2 the rest, whose moments carry the clip's global
  norm, measured 3.4e-3), the parameters' movement after step 2 within 2e-3
  relative outside the backbone (measured 3.9e-4) and 0.1 in it (measured
  4.1%: Adam turns gradients that are rounding noise, those of BatchNorm
  biases feeding another BatchNorm, into full-size steps of either sign),
  every element within twice the summed learning rates, and step 3's loss
  within 1e-2 (measured 1.9e-3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.core.config import ModelConfig as JaxModelConfig
from tod_tpu.core.config import TrainConfig as JaxTrainConfig
from tod_tpu.train import SyntheticDetectionData as JaxData
from tod_tpu.train import Trainer as JaxTrainer
from tod_tpu.train.losses import yolact_loss as jax_loss
from tod_tpu_torch.core.config import ModelConfig, TrainConfig
from tod_tpu_torch.core.weights import train_state_from_tree, train_state_to_tree
from tod_tpu_torch.train import Trainer
from tod_tpu_torch.train.losses import yolact_loss
from tod_tpu_torch.train.trainer import device_batch, learning_rate

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8, nms_top_k=8, max_detections=4, dtype="float32")
TTRAIN = dict(batch_size=2, learning_rate=5e-3, warmup_steps=2, total_steps=20)
CPU = torch.device("cpu")


def flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)
    return out


def group(key: str) -> str:
    return "backbone" if "/MobileNetV2_0/" in key else "rest"


def rel(a: dict, b: dict, keys) -> float:
    """||a - b|| / ||b|| over ``keys``."""
    num = sum(float(((a[k].astype(np.float64) - b[k]) ** 2).sum()) for k in keys)
    den = sum(float((b[k].astype(np.float64) ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def port_grad(model, anchors, batch: dict) -> dict[str, np.ndarray]:
    """The port's gradient of the loss at ``model``'s parameters, as a tree;
    the model's outputs cast to f32 for the loss."""
    imgs = (batch["image"].float() / 127.5 - 1.0).to(torch.bfloat16)
    out = model(imgs.to(next(model.parameters()).dtype))
    out = type(out)(**{f.name: getattr(out, f.name).float() for f in dataclasses.fields(out)})
    total, _ = yolact_loss(out, anchors, batch)
    names = [n for n, _ in model.named_parameters()]
    return train_state_to_tree(dict(zip(names, torch.autograd.grad(total,
                                                                   list(model.parameters())))))


@pytest.fixture(scope="module")
def run():
    jt = JaxTrainer(JaxModelConfig(**TINY), JaxTrainConfig(**TTRAIN))
    init = flat({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    data = JaxData((48, 64), batch_size=2, seed=0)
    batches = [data.next_batch() for _ in range(3)]
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss(params):
        imgs = (jb["image"].astype(jnp.float32) / 127.5 - 1.0).astype(jnp.bfloat16)
        out, _ = jt.model.apply({"params": params, "batch_stats": jt.state.batch_stats}, imgs,
                                train=True, mutable=["batch_stats"])
        return jax_loss(out, jt.anchors, jb)[0]

    grad_jax = flat({"params": jax.jit(jax.grad(loss))(jt.state.params)})
    pt = Trainer(ModelConfig(**TINY), TrainConfig(**TTRAIN), device="cpu")
    pt.model.load_state_dict(train_state_from_tree(init, pt.model))
    grad_port = port_grad(pt.model, pt.anchors, device_batch(batches[0], CPU))
    m64 = Trainer(ModelConfig(**{**TINY, "dtype": "float64"}), TrainConfig(**TTRAIN),
                  device="cpu").model
    m64.load_state_dict(train_state_from_tree(init, m64))
    m64.double()
    grad_f64 = port_grad(m64, pt.anchors, device_batch(batches[0], CPU))
    pt.model.load_state_dict(train_state_from_tree(init, pt.model))  # the forward moved the stats

    steps = []
    for b in batches:
        jt.state, jm = jt._step(jt.state, {k: jnp.asarray(v) for k, v in b.items()})
        pm = pt.train_step(device_batch(b, CPU))
        adam = jt.state.opt_state[1][0]
        steps.append({
            "jax": {k: float(v) for k, v in jm.items()},
            "port": {k: float(v) for k, v in pm.items()},
            "jax_tree": flat({"params": jt.state.params, "batch_stats": jt.state.batch_stats}),
            "port_tree": pt.tree(),
            "jax_mu": flat({"params": adam.mu}), "jax_nu": flat({"params": adam.nu}),
            "port_mu": train_state_to_tree(dict(zip(pt.param_names, pt.opt.mu))),
            "port_nu": train_state_to_tree(dict(zip(pt.param_names, pt.opt.nu))),
        })
    return {"init": init, "steps": steps, "grad_jax": grad_jax, "grad_port": grad_port,
            "grad_f64": grad_f64, "n_opt_leaves": len(jax.tree.leaves(jt.state.opt_state)),
            "port_opt_leaves": pt.opt.n_leaves}


@pytest.mark.parametrize("step", [1, 2])
def test_loss_components(run, step):
    s = run["steps"][step - 1]
    for key, want in s["jax"].items():
        assert abs(s["port"][key] - want) <= 1e-4 * abs(want), key


def test_step3_loss(run):
    s = run["steps"][2]
    assert abs(s["port"]["loss"] - s["jax"]["loss"]) <= 1e-2 * abs(s["jax"]["loss"])


def test_first_update_leaves_the_parameters_unchanged(run):
    s = run["steps"][0]
    for key, value in run["init"].items():
        if key.startswith("params/"):
            np.testing.assert_array_equal(s["port_tree"][key], value)
            np.testing.assert_array_equal(s["jax_tree"][key], value)
    assert run["port_opt_leaves"] == run["n_opt_leaves"]


@pytest.mark.parametrize("step", [1, 2])
def test_batchnorm_running_statistics(run, step):
    s = run["steps"][step - 1]
    for key, want in s["jax_tree"].items():
        if key.startswith("batch_stats/"):
            err = np.abs(s["port_tree"][key] - want) / np.maximum(1.0, np.abs(want))
            assert err.max() <= 1.5e-4, key
            assert not np.array_equal(want, run["init"][key])  # the step moved them


@pytest.mark.parametrize("part,to_jax,to_f64", [("rest", 1e-3, 2e-4), ("backbone", 3e-2, 1e-3)])
def test_gradient_on_carried_weights(run, part, to_jax, to_f64):
    keys = [k for k in run["grad_jax"] if group(k) == part]
    assert rel(run["grad_port"], run["grad_jax"], keys) <= to_jax
    assert rel(run["grad_port"], run["grad_f64"], keys) <= to_f64


@pytest.mark.parametrize("part,tol", [("rest", 1e-2), ("backbone", 3e-2)])
def test_adam_moments_after_step_1(run, part, tol):
    s = run["steps"][0]
    keys = [k for k in s["port_mu"] if group(k) == part]
    assert rel(s["port_mu"], s["jax_mu"], keys) <= tol
    assert rel(s["port_nu"], s["jax_nu"], keys) <= 2 * tol


@pytest.mark.parametrize("part,tol", [("rest", 2e-3), ("backbone", 0.1)])
def test_parameters_after_step_2(run, part, tol):
    s = run["steps"][1]
    keys = [k for k in s["jax_tree"] if k.startswith("params/") and group(k) == part]
    moved = {k: s["jax_tree"][k] - run["init"][k] for k in keys}
    diff = {k: s["port_tree"][k] - run["init"][k] for k in keys}
    assert rel(diff, moved, keys) <= tol
    bound = 2 * sum(learning_rate(TrainConfig(**TTRAIN), c) for c in range(2))
    assert max(float(np.abs(s["port_tree"][k] - s["jax_tree"][k]).max()) for k in keys) <= bound
