"""The port's training surface on the CPU (M14): ``Trainer`` checkpoints
(the serving tree served through ``core.weights.load_checkpoint``, the full
state resumed bit for bit, ``--init-from``'s refusals naming the parameter),
the chunked loop and the device augmentation replaying the per-step run,
``train``'s evaluation, metrics and state files, QAT (the configuration
validates, trains, and its checkpoint serves through the int8 engine), and
``python -m tod_tpu_torch.train.run`` for 2 steps."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from tod_tpu_torch.core import config
from tod_tpu_torch.core.weights import load_checkpoint, read_tree
from tod_tpu_torch.models.yolact import Yolact
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.engine import Engine
from tod_tpu_torch.runtime.frame_source import synth_frame_numpy
from tod_tpu_torch.train import SyntheticDetectionData, Trainer
from tod_tpu_torch.train import run as train_run

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

HW = (48, 64)
TINY = config.ModelConfig(input_size=HW, fpn_channels=16, proto_channels=16, head_channels=16,
                          width_mult=0.35, num_prototypes=8, nms_top_k=8, max_detections=4)
TCFG = config.TrainConfig(batch_size=2, learning_rate=5e-3, warmup_steps=1, total_steps=8)
QUIET = dict(log_every=10**9, log_fn=lambda *_: None)


def data(seed: int = 0):
    return SyntheticDetectionData(HW, batch_size=2, seed=seed)


def states_equal(a: Trainer, b: Trainer) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))


def trained(steps: int = 2, mcfg=TINY, tcfg=TCFG, **kw) -> Trainer:
    tr = Trainer(mcfg, tcfg, device="cpu")
    tr.train(data(), steps=steps, **QUIET, **kw)
    return tr


def test_the_serving_tree_serves_a_frame(tmp_path):
    tr = trained()
    tr.save(tmp_path / "t.npz")
    assert not list(tmp_path.glob("*.saving"))
    tree = read_tree(tmp_path / "t.npz")
    assert any(k.startswith("batch_stats/") for k in tree)
    state = load_checkpoint(tmp_path / "t.npz", TINY)
    for k, v in tr.serving_state().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    cfg = config.PipelineConfig(camera=config.CameraConfig(width=64, height=48), model=TINY)
    eng = Engine(cfg, state, device="cpu")
    f = synth_frame_numpy(0, 0, 48, 64)
    plan = eng.serve_step_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)))
    assert plan.shape == (cfg.planner.max_path_steps + 1, 2) and torch.isfinite(plan).all()


def test_resume_continues_the_same_trajectory(tmp_path):
    straight = trained(4)
    half = trained(2)
    half.save_state(tmp_path / "s.pt")
    resumed = Trainer(TINY, TCFG, device="cpu")
    resumed.load_state(tmp_path / "s.pt")
    assert resumed.step == 2 and resumed.opt.count == 2
    src = data()
    for _ in range(2):
        src.next_batch()
    resumed.train(src, steps=2, **QUIET)
    assert states_equal(resumed, straight)
    for a, b in zip(resumed.opt.mu + resumed.opt.nu, straight.opt.mu + straight.opt.nu):
        assert torch.equal(a, b)


def test_load_state_checks_the_optimizer(tmp_path):
    tr = trained(1)
    tr.save_state(tmp_path / "s.pt")
    saved = torch.load(tmp_path / "s.pt", weights_only=True)
    saved["opt_state"]["mu"].popitem()
    torch.save(saved, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        Trainer(TINY, TCFG, device="cpu").load_state(tmp_path / "bad.pt")


def test_init_from_loads_and_names_a_mismatch(tmp_path):
    tr = trained(1)
    tr.save(tmp_path / "t.npz")
    fresh = Trainer(TINY, TCFG, device="cpu")
    fresh.load(tmp_path / "t.npz")
    assert states_equal(fresh, tr) and fresh.step == 0 and fresh.opt.count == 0
    wider = Trainer(dataclasses.replace(TINY, num_prototypes=16), TCFG, device="cpu")
    with pytest.raises(ValueError, match="mismatch at param ProtoNet_0.proto_out.weight"):
        wider.load(tmp_path / "t.npz")
    with pytest.raises(ValueError, match="leaves"):
        Trainer(dataclasses.replace(TINY, backbone="resnet18"), TCFG, device="cpu").load(
            tmp_path / "t.npz")


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "device_augment"])
def test_chunks_replay_the_per_step_run(augment):
    tcfg = dataclasses.replace(TCFG, device_augment=augment)
    per_step = trained(5, tcfg=tcfg)
    chunked = trained(5, tcfg=tcfg, chunk=2)
    assert states_equal(per_step, chunked)


def test_train_evaluates_and_writes_its_records(tmp_path):
    tr = Trainer(TINY, TCFG, device="cpu")
    lines = []
    last = tr.train(data(), steps=4, log_every=2, log_fn=lines.append, eval_every=2,
                    eval_scenes=1, best_path=str(tmp_path / "best.npz"),
                    metrics_path=str(tmp_path / "m.jsonl"), state_path=str(tmp_path / "s.pt"),
                    state_every=3)
    assert {"loss", "cls", "box", "mask", "sem", "eval_map50", "eval_best_map50"} <= set(last)
    assert sum(line.startswith("step ") for line in lines) == 2
    assert sum(line.startswith("eval @ step") for line in lines) == 2
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["train", "eval", "state", "train", "eval"]
    assert (tmp_path / "s.pt").is_file()
    assert (tmp_path / "best.npz").is_file() == (not np.isnan(last["eval_best_map50"]))


class TestQAT:
    QAT = dataclasses.replace(TINY, quantized=True, qat=True, dtype="float32")

    def test_validates_and_only_qat_trains_a_quantized_model(self):
        assert config.validate(config.PipelineConfig(model=self.QAT)) == []
        assert any("requires model.quantized" in p for p in config.validate(
            config.PipelineConfig(model=dataclasses.replace(TINY, qat=True))))
        with pytest.raises(ValueError, match="only with ModelConfig.qat"):
            Yolact(dataclasses.replace(TINY, quantized=True), train=True)

    def test_a_qat_checkpoint_serves_through_the_int8_engine(self, tmp_path):
        tr = trained(2, mcfg=self.QAT)
        assert all(np.isfinite(v.detach().numpy()).all() for v in tr.model.parameters())
        tr.save(tmp_path / "q.npz")
        int8 = dataclasses.replace(TINY, quantized=True)
        cfg = config.PipelineConfig(camera=config.CameraConfig(width=64, height=48), model=int8)
        eng = Engine(cfg, load_checkpoint(tmp_path / "q.npz", int8), device="cpu")
        assert any(k.endswith(".kernel_q") for k in eng.model.state_dict())
        f = synth_frame_numpy(0, 0, 48, 64)
        plan = eng.serve_step_plan(torch.from_numpy(pack_frame(f.rgb, f.depth)))
        assert torch.isfinite(plan).all()


class TestRunCLI:
    ARGS = ["--height", "48", "--width", "64", "--small", "--batch", "2", "--log-every", "1"]

    def test_two_steps_then_resume_and_warm_start(self, tmp_path, capsys):
        out = str(tmp_path / "y.npz")
        assert train_run.main([*self.ARGS, "--steps", "2", "--out", out, "--save-full-state",
                               "--state-every", "1"], device="cpu") == 0
        text = capsys.readouterr().out
        assert "step 2: loss=" in text and f"saved checkpoint to {out}" in text
        state = str(tmp_path / "y_state.pt")
        assert train_run.main([*self.ARGS, "--steps", "3", "--out", out, "--resume", state,
                               "--state-every", "1"], device="cpu") == 0
        text = capsys.readouterr().out
        assert "resumed from" in text and "continuing 1 steps to the 3 target" in text
        assert "step 3: loss=" in text
        assert train_run.main([*self.ARGS, "--steps", "1", "--out", str(tmp_path / "z.npz"),
                               "--init-from", out, "--qat"], device="cpu") == 0
        assert "warm-started params" in capsys.readouterr().out

    def test_refusals(self, tmp_path):
        # the JAX package's refusal: a one-device mesh (the CPU) cannot split tp = 2
        with pytest.raises(SystemExit, match="tp=2 does not divide n_devices=1"):
            train_run.main([*self.ARGS, "--tp", "2"], device="cpu")
        with pytest.raises(SystemExit):
            train_run.main([*self.ARGS, "--init-from", "a.npz", "--resume", "b.pt"],
                           device="cpu")
