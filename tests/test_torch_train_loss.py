"""The port's training pieces (M14) against the JAX package on the CPU, each
on the same numpy inputs: the matcher, every loss component and its
gradient, the train-mode ConvBN and ResNet BatchNorms (outputs, running
statistics, gradients), ``fake_quantize`` and the QAT conv, the device
augmentation given JAX's own draws, and the clipped AdamW against optax.

Tolerances, each stated where it is asserted:
- matcher targets: exact, but the encoded box offsets within 2 ulps
  (2.5e-7 relative; measured 1.1e-7: XLA's ``log`` and torch's round
  differently);
- loss components: within 1e-5 relative (measured: equal, or 1 ulp); their
  gradients with respect to the head outputs within 1e-6 absolute
  (measured 1.2e-7);
- one train-mode ConvBN or ResNet block: outputs and running statistics
  within 1e-5 relative, parameter gradients within 1e-4 relative (measured
  2e-7);
- ``fake_quantize``'s value and gradient: exact, the 0.5 at +-127 included;
- ``apply_augment`` on JAX's draws: every field exact but the image, which
  is within one ulp of 255 (1.6e-5): compiled XLA's float32 power is not
  correctly rounded (the port's is) and it fuses the multiply-adds;
- AdamW on the same gradients: parameters within 1e-7 absolute and moments
  within 2e-7 absolute over 6 steps (f32 rounding of the multiply-adds),
  the first step leaving the parameters unchanged; the schedule exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tod_tpu.core.config import ModelConfig as JaxModelConfig
from tod_tpu.core.config import TrainConfig as JaxTrainConfig
from tod_tpu.models.mobilenetv2 import ConvBN as JaxConvBN
from tod_tpu.models.qconv import Conv8
from tod_tpu.models.qconv import fake_quantize as jax_fake_quantize
from tod_tpu.models.resnet import BasicBlock as JaxBasicBlock
from tod_tpu.models.yolact import YolactOutputs as JaxOutputs
from tod_tpu.ops.anchors import encode_boxes as jax_encode_boxes
from tod_tpu.ops.anchors import generate_anchors
from tod_tpu.train import losses as jl
from tod_tpu.train.augment import device_augment
from tod_tpu.train.matcher import match_anchors as jax_match
from tod_tpu.train.synthetic_data import SyntheticDetectionData as JaxData
from tod_tpu.train.trainer import make_optimizer
from tod_tpu_torch.core.config import TrainConfig
from tod_tpu_torch.core.weights import train_state_from_tree, train_state_to_tree
from tod_tpu_torch.models.conv import Training
from tod_tpu_torch.models.mobilenetv2 import ConvBN, relu6
from tod_tpu_torch.models.qconv import QATConv, fake_quantize
from tod_tpu_torch.models.resnet import BasicBlock
from tod_tpu_torch.models.yolact import YolactOutputs
from tod_tpu_torch.ops.anchors import encode_boxes
from tod_tpu_torch.ops.ieee import clip
from tod_tpu_torch.train import losses as pl
from tod_tpu_torch.train.augment import apply_augment
from tod_tpu_torch.train.matcher import match_anchors
from tod_tpu_torch.train.trainer import AdamW, device_batch, learning_rate

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

# tests/test_train.py's TINY model
TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8, nms_top_k=8, max_detections=4)
ANCHORS = generate_anchors(JaxModelConfig(**TINY))
CPU = torch.device("cpu")


def flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def gt_sets(rng, b: int, m: int = 6):
    """``b`` random gt sets of ``m`` slots: sorted corners, classes 1-3, the
    first ``k`` valid with k from 0 to m."""
    boxes = np.sort(rng.uniform(0, 1, (b, m, 2, 2)), axis=2).reshape(b, m, 4).astype(np.float32)
    classes = rng.integers(1, 4, (b, m)).astype(np.int32)
    valid = np.arange(m)[None, :] < rng.integers(0, m + 1, (b, 1))
    return boxes, classes, valid


class TestMatcher:
    def test_targets_equal_jax_exactly(self):
        rng = np.random.default_rng(0)
        boxes, classes, valid = gt_sets(rng, 12)
        # a duplicated gt: both claim the same best anchor, the later wins
        boxes[0, 1] = boxes[0, 0]
        valid[0, :2] = True
        got = match_anchors(torch.from_numpy(ANCHORS), torch.from_numpy(boxes),
                            torch.from_numpy(classes), torch.from_numpy(valid))
        for i in range(len(boxes)):
            want = jax_match(jnp.asarray(ANCHORS), jnp.asarray(boxes[i]), jnp.asarray(classes[i]),
                             jnp.asarray(valid[i]))
            for key, value in want.items():
                if key == "box_target":
                    np.testing.assert_allclose(got[key][i].numpy(), np.asarray(value),
                                               rtol=2.5e-7, atol=0)
                else:
                    np.testing.assert_array_equal(got[key][i].numpy(), np.asarray(value),
                                                  err_msg=key)

    def test_an_anchor_gt_is_positive_with_zero_offsets(self):
        a = ANCHORS[10]
        gt = np.array([[a[0] - a[2] / 2, a[1] - a[3] / 2, a[0] + a[2] / 2, a[1] + a[3] / 2]],
                      np.float32)
        m = match_anchors(torch.from_numpy(ANCHORS), torch.from_numpy(gt),
                          torch.tensor([3]), torch.tensor([True]))
        assert bool(m["pos_mask"][10]) and int(m["cls_target"][10]) == 3
        np.testing.assert_allclose(m["box_target"][10].numpy(), 0.0, atol=1e-5)

    def test_encode_boxes_equals_jax(self):
        rng = np.random.default_rng(1)
        boxes = gt_sets(rng, 1, len(ANCHORS))[0][0]
        np.testing.assert_allclose(
            encode_boxes(torch.from_numpy(boxes), torch.from_numpy(ANCHORS)).numpy(),
            np.asarray(jax_encode_boxes(jnp.asarray(boxes), jnp.asarray(ANCHORS))),
            rtol=2.5e-7, atol=0)


def head_outputs(rng, b: int, k: int = 8, ties: bool = False) -> dict[str, np.ndarray]:
    a = len(ANCHORS)
    conf = rng.standard_normal((b, a, 4)).astype(np.float32)
    if ties:  # many negatives with one loss: OHEM's threshold falls on a tie
        conf[:, ::3] = conf[:, :1]
    return dict(loc=rng.standard_normal((b, a, 4)).astype(np.float32), conf=conf,
                coeff=rng.standard_normal((b, a, k)).astype(np.float32),
                prototypes=np.abs(rng.standard_normal((b, 12, 16, k))).astype(np.float32),
                sem_logits=rng.standard_normal((b, 6, 8, 81)).astype(np.float32))


@pytest.mark.parametrize("cls_loss", ["ohem", "focal"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
def test_yolact_loss_and_its_gradient_equal_jax(cls_loss, ties):
    """Every component within 1e-5, the gradient with respect to each head
    output within 1e-6.  The gt boxes come from the procedural generator,
    whose regular anchor grid gives many positives of equal IoU (the mask
    loss's top-k ties)."""
    rng = np.random.default_rng(2)
    outs = head_outputs(rng, 2, ties=ties)
    batch = JaxData((48, 64), batch_size=2, seed=int(ties)).next_batch()

    def f(o):
        return jl.yolact_loss(JaxOutputs(**o), jnp.asarray(ANCHORS),
                              {k: jnp.asarray(v) for k, v in batch.items()}, cls_loss=cls_loss)

    (total, comps), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outs.items()})
    tens = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    p_total, p_comps = pl.yolact_loss(YolactOutputs(**tens), torch.from_numpy(ANCHORS),
                                      device_batch(batch, CPU), cls_loss=cls_loss)
    for key in comps:
        want = float(comps[key])
        assert abs(float(p_comps[key]) - want) <= 1e-5 * max(1.0, abs(want)), key
    assert abs(float(p_total) - float(total)) <= 1e-5 * max(1.0, abs(float(total)))
    p_grads = torch.autograd.grad(p_total, list(tens.values()))
    for key, g in zip(tens, p_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[key]), rtol=0, atol=1e-6,
                                   err_msg=key)


def test_ohem_drops_the_negatives_tied_at_its_threshold():
    """Six negatives of equal loss with k = 3: all sit on the threshold
    (strictly-above keeps none of them), as in the JAX loss."""
    conf = np.zeros((1, 8, 4), np.float32)
    conf[0, 0, 1] = 2.0  # the positive
    conf[0, 1, 0] = -1.0  # the one hard negative above the tie
    target = np.array([[1, 0, 0, 0, 0, 0, 0, -1]], np.int32)
    want = jl.classification_loss(jnp.asarray(conf[0]), jnp.asarray(target[0]))
    got = pl.classification_loss(torch.from_numpy(conf), torch.from_numpy(target))
    assert abs(float(got[0]) - float(want)) <= 1e-6


def test_mask_loss_top_k_ties_go_to_the_lower_index():
    q = torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.5, 0.9]])
    pos = torch.tensor([[True, True, True, True, False, True]])
    idx = pl.top_positives(pos, q, 4)
    _, want = jax.lax.top_k(jnp.where(jnp.asarray(pos.numpy()), jnp.asarray(q.numpy()), -1.0), 4)
    assert idx.tolist() == np.asarray(want).tolist() == [[5, 1, 3, 0]]


class TestTrainBatchNorm:
    """One train-mode block of the port against Flax on carried weights:
    the output, the running statistics Flax's ``batch_stats`` update gives
    (momentum 0.97, the biased variance E[x^2] - E[x]^2), and the gradients
    of a random projection of the output."""

    def run(self, jmod, pmod, shape, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        v = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=True)
        # non-trivial running statistics and BN parameters
        v = jax.tree.map(lambda a: a * np.float32(1.3) + np.float32(0.1), v)
        tree = flat({"params": {"m": v["params"]}, "batch_stats": {"m": v["batch_stats"]}})
        pmod.load_state_dict({k[2:]: t for k, t in train_state_from_tree(tree).items()})
        pmod.train()
        y, mut = jmod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        r = rng.standard_normal(y.shape).astype(np.float32)

        def f(params):
            out, _ = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
            return jnp.sum(out * r)

        gj = flat({"params": {"m": jax.grad(f)(v["params"])}})
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        yt = pmod(xt)
        np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
        stats = train_state_to_tree({f"m.{k}": t for k, t in pmod.state_dict().items()})
        for key, want in flat({"batch_stats": {"m": mut["batch_stats"]}}).items():
            np.testing.assert_allclose(stats[key], want, rtol=1e-5, atol=1e-6, err_msg=key)
        loss = (yt.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum()
        names = [n for n, _ in pmod.named_parameters()]
        grads = train_state_to_tree(dict(zip([f"m.{n}" for n in names],
                                             torch.autograd.grad(loss, list(pmod.parameters())))))
        for key, want in gj.items():
            err = np.linalg.norm(grads[key] - want) / np.linalg.norm(want)
            assert err <= 1e-4, (key, err)

    @pytest.mark.parametrize("kernel,groups,stride", [(1, 1, 1), (3, 16, 2), (3, 1, 1)],
                             ids=["1x1", "depthwise_s2", "3x3"])
    def test_convbn(self, kernel, groups, stride):
        cin = 16 if groups > 1 else 8
        self.run(JaxConvBN(16, kernel=kernel, groups=groups, stride=stride, dtype=jnp.float32),
                 ConvBN(cin, 16, kernel=kernel, groups=groups, stride=stride,
                        quantized=Training(torch.float32)), (2, 6, 8, cin))

    def test_resnet_basic_block_with_its_downsample(self):
        self.run(JaxBasicBlock(16, stride=2, dtype=jnp.float32),
                 BasicBlock(8, 16, 2, Training(torch.float32)), (2, 8, 10, 8))

    def test_relu6_gradient_is_zero_at_both_bounds(self):
        x = torch.tensor([-1.0, 0.0, 3.0, 6.0, 7.0], requires_grad=True)
        (g,) = torch.autograd.grad(relu6(x).sum(), x)
        want = jax.grad(lambda a: jax.nn.relu6(a).sum())(jnp.asarray(x.detach().numpy()))
        assert g.tolist() == np.asarray(want).tolist() == [0.0, 0.0, 1.0, 0.0, 0.0]


class TestFakeQuantize:
    def test_the_amax_element_gets_half_the_gradient(self):
        """jax.grad of fake_quantize(x).sum() at
        [0.3, -1.0, 0.5, 1.0] is [1, 0.5, 1, 0.5]."""
        x = torch.tensor([0.3, -1.0, 0.5, 1.0], requires_grad=True)
        (g,) = torch.autograd.grad(fake_quantize(x).sum(), x)
        want = jax.jit(jax.grad(lambda a: jax_fake_quantize(a).sum()))(jnp.asarray([0.3, -1.0,
                                                                                   0.5, 1.0]))
        assert g.tolist() == np.asarray(want).tolist() == [1.0, 0.5, 1.0, 0.5]

    @pytest.mark.parametrize("axis", [None, (0, 1, 2)], ids=["per_tensor", "per_channel"])
    def test_value_and_gradient_equal_jax_exactly(self, axis):
        rng = np.random.default_rng(3)
        w = (rng.standard_normal((3, 3, 8, 16)) * rng.uniform(0.01, 3, 16)).astype(np.float32)
        r = rng.standard_normal(w.shape).astype(np.float32)

        def f(a):
            return jnp.sum(jax_fake_quantize(a, axis=axis) * r)

        val = jax.jit(lambda a: jax_fake_quantize(a, axis=axis))(jnp.asarray(w))
        grad = jax.jit(jax.grad(f))(jnp.asarray(w))
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_()
        dim = None if axis is None else (1, 2, 3)
        got = fake_quantize(wt, dim=dim)
        (g,) = torch.autograd.grad((got * torch.from_numpy(
            np.ascontiguousarray(r.transpose(3, 2, 0, 1)))).sum(), wt)
        np.testing.assert_array_equal(got.detach().numpy().transpose(2, 3, 1, 0), np.asarray(val))
        np.testing.assert_array_equal(g.numpy().transpose(2, 3, 1, 0), np.asarray(grad))
        assert (np.asarray(grad) == 0.5 * r).any()  # the bound's half gradient occurs

    def test_clip_gradient_is_jnp_clip_s(self):
        x = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0], requires_grad=True)
        (g,) = torch.autograd.grad(clip(x, -1.0, 1.0).sum(), x)
        want = jax.grad(lambda a: jnp.clip(a, -1.0, 1.0).sum())(jnp.arange(-2.0, 3.0))
        assert g.tolist() == np.asarray(want).tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]

    @pytest.mark.parametrize("groups", [1, 8], ids=["dense", "depthwise"])
    def test_qat_conv_equals_conv8_qat(self, groups):
        """The fake-quantized conv (depthwise left in float) against
        ``Conv8(qat=True)``: output within 1e-5, gradients within 1e-4
        relative."""
        rng = np.random.default_rng(4)
        x = rng.uniform(-2, 2, (2, 9, 11, 8)).astype(np.float32)
        jmod = Conv8(8, (3, 3), strides=2, feature_group_count=groups, qat=True,
                     dtype=jnp.float32)
        v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        r = rng.standard_normal(jmod.apply(v, jnp.asarray(x)).shape).astype(np.float32)
        y, gj = jax.jit(jax.value_and_grad(
            lambda p, a: jnp.sum(jmod.apply({"params": p}, a) * r), argnums=(0, 1)))(
            v["params"], jnp.asarray(x))
        pmod = QATConv(8, 8, 3, 2, groups, bias=True, dtype=torch.float32)
        pmod.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(np.asarray(v["params"]["bias"]))})
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
        out = (pmod(xt).permute(0, 2, 3, 1) * torch.from_numpy(r)).sum()
        assert abs(float(out) - float(y)) <= 1e-5 * max(1.0, abs(float(y)))
        gw, gx = torch.autograd.grad(out, [pmod.weight, xt])
        for got, want in ((gw.numpy().transpose(2, 3, 1, 0), gj[0]["kernel"]),
                          (gx.numpy().transpose(0, 2, 3, 1), gj[1])):
            want = np.asarray(want)
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_apply_augment_on_jax_draws_is_exact():
    """The draws ``device_augment`` makes from its key (split as it splits
    it) fed to ``apply_augment``: every field equal."""
    batch = JaxData((48, 64), batch_size=4, seed=5).next_batch()
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), 3)
    kf, kwb, kb, kg, ks, kn = jax.random.split(key, 6)
    b = 4
    draws = {
        "flip": jax.random.bernoulli(kf, 0.5, (b,)),
        "wb": jax.random.uniform(kwb, (b, 1, 1, 3), minval=0.9, maxval=1.1),
        "bright": jax.random.uniform(kb, (b, 1, 1, 1), minval=0.8, maxval=1.25),
        "gamma": jax.random.uniform(kg, (b, 1, 1, 1), minval=0.8, maxval=1.25),
        "sigma": jax.random.uniform(ks, (b, 1, 1, 1), maxval=7.0),
        "noise": jax.random.normal(kn, (b, 48, 64, 3)),
    }
    assert np.asarray(draws["flip"]).any() and not np.asarray(draws["flip"]).all()
    want = jax.jit(device_augment)(key, {k: jnp.asarray(v) for k, v in batch.items()})
    got = apply_augment(device_batch(batch, CPU),
                        {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})
    for k in want:
        if k != "image":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # one ulp of a value in [128, 256): compiled XLA rounds the fused power
    # and multiply-adds its own way (measured: 73% of the pixels equal)
    assert np.abs(got["image"].numpy() - np.asarray(want["image"])).max() <= 1.6e-5


class TestAdamW:
    TK = dict(learning_rate=5e-3, warmup_steps=2, total_steps=6, weight_decay=5e-4)

    def test_schedule_equals_optax(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, 5e-3, 2, 6)
        for c in range(10):
            assert np.float32(sched(c)) == np.float32(learning_rate(TrainConfig(**self.TK), c))
        assert learning_rate(TrainConfig(**self.TK), 0) == 0.0

    def test_steps_equal_optax(self):
        """Six steps on the same gradients, alternately below and above the
        clip's norm of 10: the first leaves the parameters as they were,
        and the moments and parameters follow optax's within f32 rounding."""
        rng = np.random.default_rng(6)
        shapes = [(3, 4), (5,), (2, 2, 3)]
        params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        tx = make_optimizer(JaxTrainConfig(**self.TK))
        jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
        state = tx.init(jp)

        @jax.jit
        def update(g, st, p):
            u, st = tx.update(g, st, p)
            return optax.apply_updates(p, u), st

        tp = [torch.from_numpy(p.copy()) for p in params]
        opt = AdamW(tp, TrainConfig(**self.TK))
        assert opt.n_leaves == len(jax.tree.leaves(state))
        norms = []
        for step in range(6):
            g = [(rng.standard_normal(s) * (30.0 if step % 2 else 0.5)).astype(np.float32)
                 for s in shapes]
            norms.append(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g)))
            jp, state = update({str(i): jnp.asarray(x) for i, x in enumerate(g)}, state, jp)
            opt.step([torch.from_numpy(x) for x in g])
            if step == 0:
                assert all((t.numpy() == p).all() for t, p in zip(tp, params))
            adam = state[1][0]
            for i in range(len(shapes)):
                np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[str(i)]), rtol=0,
                                           atol=1e-7)
                np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(adam.mu[str(i)]),
                                           rtol=0, atol=2e-7)
                np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[str(i)]),
                                           rtol=1e-6, atol=0)
        assert min(norms) < 10 < max(norms)


def test_qat_calibration_runs_the_qat_branch():
    """An ``Engine`` of a ``ModelConfig.qat`` model calibrates through the
    QAT branch, as the JAX package's calibration runs the model's own
    (fake-quantized) convs: each site's amax against ``calibrate_amax`` of
    the JAX QAT model on the same folded tree, within 1e-2 relative
    (measured: 2.4e-7, an ulp or two, at every site but ProtoNet's, at most
    3.1e-3: past the upsample, whose f32 roundings differ, activations flip
    to the next int8 level, 1/127 of the amax), and different from the
    dynamic branch's."""
    from tod_tpu.models import create_model
    from tod_tpu.models.prepare import calibrate_amax as jax_calibrate_amax
    from tod_tpu.models.prepare import fold_batchnorm
    from tod_tpu_torch.core import config as tcfg
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.models.prepare import calibrate_amax
    from tod_tpu_torch.models.qconv import conv_sites
    from tod_tpu_torch.models.yolact import Yolact

    kw = dict(TINY, quantized=True, dtype="float32")
    jm, _ = create_model(JaxModelConfig(**kw, qat=True))
    rng = np.random.default_rng(7)
    x0 = jnp.zeros((1, 48, 64, 3), jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(lambda key: jm.init(key, x0, train=False))(
        jax.random.PRNGKey(0)))
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), v["batch_stats"])}
    batches = [rng.normal(0, 1, (2, 48, 64, 3)).astype(np.float32) for _ in range(2)]
    want = flat(jax_calibrate_amax(jm, fold_batchnorm(v), [jnp.asarray(b) for b in batches]))
    state = carry_across(flat(v))
    got = {}
    for branch in ("qat", "dynamic"):
        model = Yolact(tcfg.ModelConfig(**kw, qat=True))
        if branch == "qat":
            for site in conv_sites(model).values():
                site.set_branch("qat")
        model.load_state_dict(state)
        got[branch] = calibrate_amax(model, [torch.from_numpy(b) for b in batches])
    assert len(got["qat"]) == len(want)
    for key, value in want.items():
        site = key[:-len("/amax")].replace("/", ".")
        assert got["qat"][site] == pytest.approx(float(value), rel=1e-2), site
    assert any(got["qat"][s] != got["dynamic"][s] for s in got["qat"])
