"""The port's multi-device layer (``tod_tpu_torch.parallel``) against the
JAX package's ``parallel`` on the CPU: the mesh, the layout rule leaf by
leaf, ``shard_inference`` and ``DPBatchServer`` against the unsharded graph
(and against the JAX server on the carried weights), the spatial split,
and the dp x tp train step over 8 gloo ranks against the JAX package's
sharded step on its 8-device virtual mesh and against the port's own
single-device step.

The multi-rank cases start one ``torch.multiprocessing`` spawn a mesh
(``parallel.mesh.launch``: 8 processes, gloo, a ``FileStore`` in
``tmp_path``, ``OMP_NUM_THREADS=1``); the ranks write their numbers to
``.npz`` files that the test process reads.

Tolerances of the train step, measured with TINY32 at batch 8 from the
JAX trainer's init carried across (the same at tp 1 and 2):

- the loss of step 1 within 1e-4 relative of the JAX sharded step's and
  1e-5 of the port's single-device step's (measured 2.6e-7 for both; step
  2's 8.6e-8 at tp 1, equal at tp 2);
- BatchNorm's running statistics equal on every rank, and after step 1
  within 1e-6 of max(1, |v|) of the single-device step's (measured 9.4e-7):
  the slots' moments are summed in float64 and rounded once, so what is
  left is the single-device step's own f32 rounding;
- the parameters after step 1 bit for bit the single-device step's (the
  schedule's lr is 0 at the first update); Adam's first moments after step
  1 (the clipped gradient) within 1e-4 relative a parameter group
  (measured 1.4e-5 in the backbone, 3.9e-6 in the rest);
- the parameters after step 2 within 2e-3 of max(1, |v|) (measured
  7.3e-4: Adam turns gradients that are rounding noise into full-size
  steps, as ``test_torch_train_step.py`` sets out);
- ``train(chunk=2)`` bit for bit the two per-step sharded steps.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from tod_tpu_torch.core import config as tcfg

# the JAX package is imported inside the tests: the gloo ranks, spawned
# processes that import this module, run the port alone

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

TINY = dict(input_size=(48, 64), fpn_channels=16, proto_channels=16, head_channels=16,
            width_mult=0.35, num_prototypes=8, dtype="float32")
TTRAIN = dict(batch_size=8, warmup_steps=2, total_steps=10)
CPU8 = ["cpu"] * 8
# an 8-rank spawn takes ~10 s alone; a hung collective fails the test here
LAUNCH_TIMEOUT = 300
# ||update - single-device update|| / ||single-device update|| after step
# 2, measured 1.07e-2 (backbone) and 1.70e-5 (the rest) at tp 1 and 2.  The
# backbone's share comes from the projections' BatchNorm biases
# (``ConvBN_2``), a shift that the next block's BatchNorm takes out again:
# their gradient is rounding noise (|mu1| ~1e-9,
# below Adam's eps 1e-8), and Adam's m / (sqrt(v) + eps) turns a rounding
# difference there into a difference of the update's own size.
UPDATE_REL = {"backbone": 2e-2, "rest": 1e-4}


def _require_8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def flat(tree, prefix: str = "", leaf=np.array) -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


def tree_name(name: str) -> str:
    """A state-dict name as the Flax tree names the leaf (the weight
    carry's rule, ``core.weights.train_state_to_tree``)."""
    parent, _, leaf = name.rpartition(".")
    col = "batch_stats" if leaf in ("mean", "var") else "params"
    return f"{col}/{parent.replace('.', '/')}/{'kernel' if leaf == 'weight' else leaf}"


class TestMesh:
    @pytest.mark.parametrize("tp", [1, 2, 4, 8])
    def test_make_mesh_shapes_match_jax(self, tp):
        _require_8()
        from tod_tpu.parallel import make_mesh as jax_mesh
        from tod_tpu_torch.parallel import make_mesh

        m = make_mesh(8, tp=tp, devices=CPU8)
        assert m.shape == dict(jax_mesh(8, tp=tp).shape) == {"dp": 8 // tp, "tp": tp}
        assert m.size == 8 and m.devices.shape == (8 // tp, tp)

    @pytest.mark.parametrize("n,tp", [(8, 3), (9, 1), (6, 4)])
    def test_make_mesh_errors_match_jax(self, n, tp):
        _require_8()
        from tod_tpu.parallel import make_mesh as jax_mesh
        from tod_tpu_torch.parallel import make_mesh

        with pytest.raises(ValueError) as want:
            jax_mesh(n, tp=tp)
        with pytest.raises(ValueError) as got:
            make_mesh(n, tp=tp, devices=CPU8)
        assert str(got.value) == str(want.value)

    def test_no_card_is_an_error_not_the_cpu(self, monkeypatch):
        from tod_tpu_torch.parallel import make_mesh

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(ValueError, match="no CUDA device"):
            make_mesh()


class TestLayoutRule:
    @pytest.mark.parametrize("tp", [2, 4])
    @pytest.mark.parametrize("num_prototypes", [8, 7])
    def test_rule_matches_jax_leaf_by_leaf(self, tp, num_prototypes):
        """Every leaf of the training model, sharded or replicated as the
        JAX rule shards the same leaf of the Flax tree (odd widths, e.g.
        7 prototypes, replicate)."""
        _require_8()
        import jax
        import jax.numpy as jnp

        from tod_tpu.core import config as jcfg
        from tod_tpu.models.yolact import create_model
        from tod_tpu.parallel.sharding import _leaf_spec
        from tod_tpu_torch.models.yolact import Yolact
        from tod_tpu_torch.parallel import make_mesh, param_sharding_tree

        cfg = dict(TINY, num_prototypes=num_prototypes)
        model, _ = create_model(jcfg.ModelConfig(**cfg))
        x = jnp.zeros((1, 48, 64, 3), jnp.float32)
        variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=True))
        want = {k: "tp" in str(_leaf_spec(v, tp)) for k, v in flat(
            {"params": variables["params"], "batch_stats": variables["batch_stats"]},
            leaf=lambda v: v).items()}
        specs = param_sharding_tree(Yolact(tcfg.ModelConfig(**cfg), train=True),
                                    make_mesh(8, tp=tp, devices=CPU8))
        got = {tree_name(k): bool(v) for k, v in specs.items()}
        assert got == want
        assert any(got.values()) and not all(got.values())
        proto = "params/ProtoNet_0/proto_out/kernel"
        assert got[proto] == (num_prototypes % tp == 0)

    def test_state_and_batch_trees(self):
        """The AdamW moments shard as their parameters, the BatchNorm
        statistics, the count and the step replicate; a batch splits over
        dp on its leading axis."""
        from tod_tpu_torch.parallel import (batch_sharding, make_mesh, param_sharding_tree,
                                            state_sharding_tree)
        from tod_tpu_torch.train import SyntheticDetectionData, Trainer

        mesh = make_mesh(8, tp=2, devices=CPU8)
        state = Trainer(tcfg.ModelConfig(**TINY), tcfg.TrainConfig(**TTRAIN),
                        device="cpu").state()
        tree = state_sharding_tree(state, mesh)
        params = param_sharding_tree(state.params, mesh)
        assert tree["params"] == params
        assert tree["opt_state"]["mu"] == tree["opt_state"]["nu"] == params
        assert tree["opt_state"]["count"] == tree["step"] == ()
        assert set(tree["batch_stats"].values()) == {()}
        batch = SyntheticDetectionData((48, 64), batch_size=8, seed=0).next_batch()
        assert batch_sharding(batch, mesh) == {k: ("dp",) for k in batch}

    def test_odd_output_channels_replicate(self):
        from tod_tpu_torch.parallel import make_mesh, param_sharding_tree

        tree = {"conv": torch.zeros(16, 8, 3, 3), "bias": torch.zeros(16),
                "odd": torch.zeros(5, 8, 3, 3), "dense": torch.zeros(6, 3)}
        sh = param_sharding_tree(tree, make_mesh(8, tp=2, devices=CPU8))
        assert sh == {"conv": ("tp", None, None, None), "bias": (), "odd": (),
                      "dense": ("tp", None)}


@pytest.fixture(scope="module")
def tiny_state():
    """A seeded serving state dict of the TINY model (``bench.configs``'s
    init)."""
    from tod_tpu_torch.bench.configs import model_state

    return model_state(tcfg.ModelConfig(**TINY))


class TestInference:
    def test_shard_inference_matches_unsharded(self, tiny_state):
        from tod_tpu_torch.models.yolact import Yolact
        from tod_tpu_torch.parallel import make_mesh, shard_inference

        model = Yolact(tcfg.ModelConfig(**TINY))
        model.load_state_dict(tiny_state)
        model.eval()

        def fwd(p, imgs):
            return torch.func.functional_call(model, p, (imgs,)).loc

        run = shard_inference(fwd, make_mesh(8, tp=1, devices=CPU8))(tiny_state)
        x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (8, 48, 64, 3))
                             .astype(np.float32))
        with torch.no_grad():
            out, ref = run(tiny_state, x), fwd(tiny_state, x)
        assert out.shape[0] == 8
        torch.testing.assert_close(out, ref, atol=1e-6 * max(ref.abs().max().item(), 1.0),
                                   rtol=0)

    def test_shard_inference_tp_matches_unsharded(self, tiny_state, monkeypatch):
        """A (2, 2) mesh: each row's conv sites split over its two slots and
        joined on its first, against the unsharded forward, f32, within
        1e-6 of the output's largest value; the model's classes restored
        after; tp > 1 without the model refused."""
        from tod_tpu_torch.models.conv import Conv
        from tod_tpu_torch.models.yolact import Yolact
        from tod_tpu_torch.parallel import make_mesh, shard_inference
        from tod_tpu_torch.parallel import sharding

        model = Yolact(tcfg.ModelConfig(**TINY))
        model.load_state_dict(tiny_state)
        model.eval()
        classes = [type(m) for m in model.modules()]
        pieces = []
        split = sharding.TPServeSite.tp_forward

        def counted(site, x):
            pieces.append(id(site))
            return split(site, x)

        monkeypatch.setattr(sharding.TPServeSite, "tp_forward", counted)
        sharding._TP_SERVE_CLASSES.clear()  # built again with the counted forward

        def fwd(p, imgs):
            out = torch.func.functional_call(model, p, (imgs,))
            return out.loc, out.prototypes, out.sem_logits

        mesh = make_mesh(4, tp=2, devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="needs the model"):
            shard_inference(fwd, mesh)
        run = shard_inference(fwd, mesh, model)(tiny_state)
        x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (4, 48, 64, 3))
                             .astype(np.float32))
        with torch.no_grad():
            out = run(tiny_state, x)
            assert [type(m) for m in model.modules()] == classes
            ref = fwd(tiny_state, x)
        sharded = [m for m in model.modules() if isinstance(m, Conv) and m.weight.shape[0] % 2 == 0]
        assert set(pieces) == {id(m) for m in sharded} and len(sharded) > 50
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=1e-6 * max(b.abs().max().item(), 1.0), rtol=0)
        sharding._TP_SERVE_CLASSES.clear()

    def test_dp_batch_server_tp_matches_dp(self, tiny_state):
        """``DPBatchServer`` on a (2, 2) mesh against the (2, 1) mesh's:
        boxes, scores and masks within 1e-6, the class map exact."""
        from tod_tpu_torch.parallel import make_mesh
        from tod_tpu_torch.parallel.serving import DPBatchServer

        cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=64, height=48),
                                  model=tcfg.ModelConfig(**TINY))
        rgb = np.random.default_rng(5).integers(0, 255, (4, 48, 64, 3), np.uint8)
        got = DPBatchServer(cfg, make_mesh(4, tp=2, devices=CPU8[:4]), tiny_state).serve(rgb)
        want = DPBatchServer(cfg, make_mesh(2, tp=1, devices=CPU8[:2]), tiny_state).serve(rgb)
        for field in ("boxes", "scores", "masks"):
            a, b = getattr(got, field), getattr(want, field)
            torch.testing.assert_close(a, b, atol=1e-6 * max(b.abs().max().item(), 1.0),
                                       rtol=0, msg=field)
        assert torch.equal(got.class_map, want.class_map)

    def test_dp_batch_server_matches_unsharded(self, tiny_state):
        """dp-split preprocess, forward and detect against the same graph
        unsharded, f32: 1e-6 of the largest value, class map exact."""
        from tod_tpu_torch.models.yolact import Yolact, detect_batch
        from tod_tpu_torch.ops.anchors import generate_anchors
        from tod_tpu_torch.ops.preprocess import normalize, resize_triangle
        from tod_tpu_torch.parallel import make_mesh
        from tod_tpu_torch.parallel.serving import DPBatchServer

        mcfg = tcfg.ModelConfig(**TINY)
        cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(width=64, height=48), model=mcfg)
        srv = DPBatchServer(cfg, make_mesh(8, tp=1, devices=CPU8), params=tiny_state)
        assert srv.dp == 8
        rgb = np.random.default_rng(4).integers(0, 255, (8, 48, 64, 3), np.uint8)
        dets = srv.serve(rgb)
        with pytest.raises(ValueError, match="not divisible by dp=8"):
            srv.serve(rgb[:6])

        model = Yolact(mcfg)
        model.load_state_dict(tiny_state)
        model.eval()
        anchors = torch.from_numpy(generate_anchors(mcfg))
        with torch.inference_mode():
            x = normalize(resize_triangle(torch.from_numpy(rgb), mcfg.input_size),
                          torch.float32)
            ref = detect_batch(model(x), mcfg, anchors, out_hw=(48, 64))
        for field in ("boxes", "scores", "masks"):
            a, b = getattr(dets, field), getattr(ref, field)
            torch.testing.assert_close(a, b, atol=1e-6 * max(b.abs().max().item(), 1.0),
                                       rtol=0, msg=field)
        assert torch.equal(dets.class_map, ref.class_map)
        assert torch.equal(dets.valid, ref.valid)

    def test_dp_batch_server_matches_jax(self):
        """The port's server against the JAX package's on the JAX server's
        own weights carried across, with the detect tests' tolerances
        (``test_torch_pipeline.py``): boxes, scores and masks within 1e-6
        on the valid slots, the class map exact."""
        _require_8()
        import jax

        from tod_tpu.core import config as jcfg
        from tod_tpu.parallel import make_mesh as jax_mesh
        from tod_tpu.parallel.serving import DPBatchServer as JaxServer
        from tod_tpu_torch.core.weights import carry_across
        from tod_tpu_torch.models.yolact import Yolact
        from tod_tpu_torch.parallel import make_mesh
        from tod_tpu_torch.parallel.serving import DPBatchServer

        cam = dict(width=64, height=48)
        jsrv = JaxServer(jcfg.PipelineConfig(camera=jcfg.CameraConfig(**cam),
                                             model=jcfg.ModelConfig(**TINY)),
                         jax_mesh(8, tp=1))
        mcfg = tcfg.ModelConfig(**TINY)
        state = carry_across(flat(jax.device_get(jsrv.params)), Yolact(mcfg))
        srv = DPBatchServer(tcfg.PipelineConfig(camera=tcfg.CameraConfig(**cam), model=mcfg),
                            make_mesh(8, tp=1, devices=CPU8), params=state)
        rgb = np.random.default_rng(4).integers(0, 255, (8, 48, 64, 3), np.uint8)
        want, got = jsrv.serve(rgb), srv.serve(rgb)
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        for field in ("boxes", "scores", "masks"):
            np.testing.assert_allclose(getattr(got, field).numpy()[valid],
                                       np.asarray(getattr(want, field))[valid], atol=1e-6,
                                       rtol=0, err_msg=field)
        np.testing.assert_array_equal(got.class_map.numpy(), np.asarray(want.class_map))


class TestSpatial:
    @pytest.mark.parametrize("field", ["loc", "conf", "prototypes", "sem_logits"])
    def test_spatial_forward_matches_unsharded(self, tiny_state, field):
        """H split over 8 slabs: within 1e-4 of the largest value
        (``tests/test_parallel.py``'s gate), some layers run split."""
        from tod_tpu_torch.models.yolact import Yolact
        from tod_tpu_torch.parallel import make_mesh, spatial_sharded_forward

        model = Yolact(tcfg.ModelConfig(**TINY))
        model.load_state_dict(tiny_state)
        model.eval()
        fwd = spatial_sharded_forward(lambda p, imgs: getattr(model(imgs), field),
                                      make_mesh(8, tp=1, devices=CPU8))
        x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 48, 64, 3))
                             .astype(np.float32))
        with torch.no_grad():
            out, ref = fwd(None, x), getattr(model(x), field)
        assert fwd.split_layers > 0 and fwd.gathered_layers > 0
        torch.testing.assert_close(out, ref, atol=1e-4 * max(ref.abs().max().item(), 1.0),
                                   rtol=0)


# --- the train step over 8 gloo ranks --------------------------------------

def _slot_steps(mesh, cfg: dict, out_dir: str) -> None:
    """One rank: the trainer from the carried JAX init, two per-step steps
    on seed-3 batches, then a second trainer over the same two batches by
    ``train(chunk=2)``; writes its numbers to ``out_dir/r<rank>.npz``."""
    torch.set_num_threads(1)
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer
    from tod_tpu_torch.train.trainer import device_batch

    mcfg, ttrain = tcfg.ModelConfig(**cfg), tcfg.TrainConfig(**TTRAIN)
    out = {}
    t = Trainer(mcfg, ttrain, mesh=mesh)
    t.load(os.path.join(out_dir, "init.npz"))
    data = SyntheticDetectionData(mcfg.input_size, batch_size=8, seed=3)
    m1 = t.train_step(device_batch(data.next_batch(), t.device))
    s1 = t.state()
    out["loss1"] = float(m1["loss"])
    # copies: the state's tensors are the live ones, which step 2 updates
    out.update({f"stats1/{k}": v.numpy().copy() for k, v in s1.batch_stats.items()})
    out.update({f"params1/{k}": v.numpy().copy() for k, v in s1.params.items()})
    out.update({f"mu1/{k}": v.numpy().copy() for k, v in s1.opt_state["mu"].items()})
    m2 = t.train_step(device_batch(data.next_batch(), t.device))
    out["loss2"] = float(m2["loss"])
    out.update({f"params2/{k}": v.numpy().copy() for k, v in t.state().params.items()})
    tc = Trainer(mcfg, ttrain, mesh=mesh)
    tc.load(os.path.join(out_dir, "init.npz"))
    mc = tc.train(SyntheticDetectionData(mcfg.input_size, batch_size=8, seed=3), steps=2,
                  log_every=10, log_fn=lambda *_: None, chunk=2)
    out["chunk_loss2"] = mc["loss"]
    out["chunk_step"] = tc.step
    out.update({f"chunk_params2/{k}": v.numpy() for k, v in tc.state().params.items()})
    np.savez(os.path.join(out_dir, f"r{mesh.rank}.npz"), **out)


def _run_ranks(tmp_path, tp: int, cfg: dict, init: dict) -> list[dict]:
    from tod_tpu_torch.parallel import make_mesh
    from tod_tpu_torch.parallel.mesh import launch

    np.savez(tmp_path / "init.npz", **init)
    os.environ["OMP_NUM_THREADS"] = "1"
    launch(make_mesh(8, tp=tp, devices=CPU8), _slot_steps, cfg, str(tmp_path),
           store_path=str(tmp_path / "store"), timeout=LAUNCH_TIMEOUT)
    ranks = []
    for r in range(8):
        with np.load(tmp_path / f"r{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


def _single_steps(cfg: dict, init: dict) -> dict:
    from tod_tpu_torch.core.weights import train_state_from_tree
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer
    from tod_tpu_torch.train.trainer import device_batch

    mcfg = tcfg.ModelConfig(**cfg)
    t = Trainer(mcfg, tcfg.TrainConfig(**TTRAIN), device="cpu")
    t.model.load_state_dict(train_state_from_tree(init, t.model))
    data = SyntheticDetectionData(mcfg.input_size, batch_size=8, seed=3)
    out = {"loss1": float(t.train_step(device_batch(data.next_batch(), t.device))["loss"])}
    s1 = t.state()
    out.update({f"stats1/{k}": v.numpy().copy() for k, v in s1.batch_stats.items()})
    out.update({f"params1/{k}": v.numpy().copy() for k, v in s1.params.items()})
    out.update({f"mu1/{k}": v.numpy().copy() for k, v in s1.opt_state["mu"].items()})
    out["loss2"] = float(t.train_step(device_batch(data.next_batch(), t.device))["loss"])
    out.update({f"params2/{k}": v.numpy().copy() for k, v in t.state().params.items()})
    return out


@pytest.fixture(scope="module")
def dp_tp_runs(tmp_path_factory):
    """For tp 1 and 2 (meshes (8, 1) and (4, 2)), run once a module: the
    JAX sharded step's loss, the port's 8 ranks, the port's single-device
    steps, all from the JAX trainer's init."""
    _require_8()
    import jax
    import jax.numpy as jnp

    from tod_tpu.core import config as jcfg
    from tod_tpu.parallel import make_mesh as jax_mesh
    from tod_tpu.train import SyntheticDetectionData as JaxData
    from tod_tpu.train import Trainer as JaxTrainer

    cache: dict = {}

    def get(tp: int) -> dict:
        if tp not in cache:
            jt = JaxTrainer(jcfg.ModelConfig(**TINY), jcfg.TrainConfig(**TTRAIN),
                            mesh=jax_mesh(8, tp=tp))
            init = flat(jax.device_get({"params": jt.state.params,
                                        "batch_stats": jt.state.batch_stats}))
            batch = {k: jnp.asarray(v) for k, v in
                     JaxData((48, 64), batch_size=8, seed=3).next_batch().items()}
            _, jm = jt._step(jt.state, batch)
            cache[tp] = {
                "jax_loss1": float(jm["loss"]),
                "ranks": _run_ranks(tmp_path_factory.mktemp(f"tp{tp}"), tp, TINY, init),
                "single": _single_steps(TINY, init),
            }
        return cache[tp]

    return get


def _keys(run: dict, prefix: str) -> list[str]:
    return [k for k in run if k.startswith(prefix)]


def _group_rel(a: dict, b: dict, keys) -> dict[str, float]:
    """||a - b|| / ||b|| a parameter group (backbone, the rest)."""
    out = {}
    for group in ("backbone", "rest"):
        ks = [k for k in keys if ("MobileNetV2_0." in k) == (group == "backbone")]
        num = sum(float(((a[k].astype(np.float64) - b[k]) ** 2).sum()) for k in ks)
        den = sum(float((b[k].astype(np.float64) ** 2).sum()) for k in ks)
        out[group] = (num / den) ** 0.5
    return out


@pytest.mark.parametrize("tp", [1, 2])
class TestShardedTraining:
    def test_loss_matches_jax_sharded_step(self, dp_tp_runs, tp):
        run = dp_tp_runs(tp)
        assert run["ranks"][0]["loss1"] == pytest.approx(run["jax_loss1"], rel=1e-4)

    def test_loss_matches_single_device_step(self, dp_tp_runs, tp):
        run = dp_tp_runs(tp)
        for r in run["ranks"]:
            assert float(r["loss1"]) == pytest.approx(run["single"]["loss1"], rel=1e-5)
            assert float(r["loss2"]) == pytest.approx(run["single"]["loss2"], rel=1e-5)

    def test_batchnorm_statistics_are_the_global_batchs(self, dp_tp_runs, tp):
        run = dp_tp_runs(tp)
        keys = _keys(run["single"], "stats1/")
        assert keys
        for k in keys:
            for r in run["ranks"][1:]:
                np.testing.assert_array_equal(r[k], run["ranks"][0][k], err_msg=k)
            want = run["single"][k]
            np.testing.assert_allclose(run["ranks"][0][k], want,
                                       atol=1e-6 * max(1.0, float(np.abs(want).max())),
                                       rtol=0, err_msg=k)

    def test_parameters_and_moments_gathered(self, dp_tp_runs, tp):
        """Step 1 (lr 0 in the warmup) leaves the parameters as loaded and
        moves the moments; step 2 (lr 5e-4) is the first update, compared
        as ``params2 - params1`` relative to its own norm (an update not
        applied gives 1).  ``UPDATE_REL`` says what was measured."""
        run = dp_tp_runs(tp)
        r0, single = run["ranks"][0], run["single"]
        for k in _keys(single, "params1/"):
            np.testing.assert_array_equal(r0[k], single[k], err_msg=k)
        mu = _group_rel(r0, single, _keys(single, "mu1/"))
        assert mu["backbone"] < 1e-4 and mu["rest"] < 1e-4, mu
        keys = _keys(single, "params2/")

        def update(run_: dict) -> dict:
            return {k: run_[k].astype(np.float64) - run_["params1/" + k[len("params2/"):]]
                    for k in keys}

        got, want = update(r0), update(single)
        rel = _group_rel(got, want, keys)
        assert rel["backbone"] < UPDATE_REL["backbone"] and rel["rest"] < UPDATE_REL["rest"], rel

    def test_chunked_matches_per_step_sharded(self, dp_tp_runs, tp):
        """``train(chunk=2)`` on the mesh against two per-step sharded
        steps (``tests/test_parallel.py``'s 2-step gate)."""
        r0 = dp_tp_runs(tp)["ranks"][0]
        assert int(r0["chunk_step"]) == 2
        assert float(r0["chunk_loss2"]) == pytest.approx(float(r0["loss2"]), rel=1e-5)
        keys = _keys(r0, "params2/")
        assert keys
        for k in keys:
            np.testing.assert_array_equal(r0["chunk_" + k], r0[k], err_msg=k)


def _slot_odd(mesh, out_dir: str) -> None:
    torch.set_num_threads(1)
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer
    from tod_tpu_torch.train.trainer import device_batch

    mcfg = tcfg.ModelConfig(**dict(TINY, num_prototypes=7))
    t = Trainer(mcfg, tcfg.TrainConfig(**TTRAIN), mesh=mesh)
    assert not t.layout.sharded("ProtoNet_0.proto_out.weight")
    assert t.layout.sharded("ProtoNet_0.conv0.weight")
    data = SyntheticDetectionData(mcfg.input_size, batch_size=8, seed=5)
    m = t.train_step(device_batch(data.next_batch(), t.device))
    np.savez(os.path.join(out_dir, f"r{mesh.rank}.npz"), loss=float(m["loss"]))


def test_nondivisible_widths_replicate_and_train(tmp_path):
    """7 prototypes over tp = 2: the proto_out conv replicates, the others
    shard, and the step trains to a finite loss, the same on every rank."""
    from tod_tpu_torch.parallel import make_mesh
    from tod_tpu_torch.parallel.mesh import launch

    os.environ["OMP_NUM_THREADS"] = "1"
    launch(make_mesh(8, tp=2, devices=CPU8), _slot_odd, str(tmp_path),
           store_path=str(tmp_path / "store"), timeout=LAUNCH_TIMEOUT)
    losses = [float(np.load(tmp_path / f"r{r}.npz")["loss"]) for r in range(8)]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1


def test_batch_dp_does_not_divide_is_refused(tmp_path):
    from tod_tpu_torch.parallel import make_mesh
    from tod_tpu_torch.parallel.mesh import join, leave
    from tod_tpu_torch.train import Trainer

    mesh = join(make_mesh(devices=["cpu"]), 0, str(tmp_path / "store"))
    try:
        t = Trainer(tcfg.ModelConfig(**TINY), tcfg.TrainConfig(**dict(TTRAIN, batch_size=3)),
                    mesh=mesh)
        assert t.layout.dp == 1  # dp = 1 divides every batch
    finally:
        leave(mesh)
    with pytest.raises(ValueError, match="join it first"):
        Trainer(tcfg.ModelConfig(**TINY), tcfg.TrainConfig(**TTRAIN), mesh=make_mesh(
            devices=["cpu"]))


def test_world_one_mesh_equals_the_unmeshed_trainer(tmp_path):
    """A (1, 1) mesh joined in this process: two steps bit for bit the
    trainer without a mesh (every collective is over one rank)."""
    from tod_tpu_torch.parallel import make_mesh
    from tod_tpu_torch.parallel.mesh import join, leave
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer

    mcfg, ttrain = tcfg.ModelConfig(**TINY), tcfg.TrainConfig(**dict(TTRAIN, batch_size=2))
    quiet = dict(log_every=1, log_fn=lambda *_: None)
    plain = Trainer(mcfg, ttrain, device="cpu")
    want = plain.train(SyntheticDetectionData(mcfg.input_size, batch_size=2, seed=3), 2, **quiet)
    mesh = join(make_mesh(devices=["cpu"]), 0, str(tmp_path / "store"))
    try:
        meshed = Trainer(mcfg, ttrain, mesh=mesh)
        got = meshed.train(SyntheticDetectionData(mcfg.input_size, batch_size=2, seed=3), 2,
                           **quiet)
        assert got == want
        for (name, a), b in zip(meshed.model.state_dict().items(),
                                plain.model.state_dict().values()):
            assert torch.equal(a, b), name
    finally:
        leave(mesh)
