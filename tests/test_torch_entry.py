"""The port's entry points (``tod_tpu_torch/entry.py``, the
counterpart of the root ``__graft_entry__.py``) and its native build names
(``native/build.py``), on the CPU: ``dryrun_multichip(4)`` as four gloo
ranks at TINY (and the flagship widths' sharded forward), ``entry()``'s
flagship forward against the model called directly."""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


def test_dryrun_multichip_four_gloo_ranks(tmp_path, capfd):
    from tod_tpu_torch.entry import dryrun_multichip

    os.environ["OMP_NUM_THREADS"] = "1"
    summary = dryrun_multichip(4, workdir=tmp_path)
    out = capfd.readouterr().out
    for r in range(4):
        assert f"dryrun slot {r}/4: backend gloo, device cpu" in out
    assert "dryrun_multichip ok: mesh dp=2 tp=2" in out
    assert summary["mesh"] == {"dp": 2, "tp": 2}
    assert [s["backend"] for s in summary["slots"]] == ["gloo"] * 4
    assert np.isfinite(summary["loss"]) and np.isfinite(summary["chunked_loss"])
    # the flagship's anchors at 256x320 over a dp slice of one image
    assert summary["flagship_loc"] == [1, 15354, 4]
    assert summary["spatial"] == [1, 594, 4] and summary["shard_inference"] == [2, 594, 4]
    assert summary["dp_serve_boxes"] == [2, 32, 4] and summary["pipeline"] == ["cpu", "cpu"]
    assert list(tmp_path.iterdir()) == []  # the store and the summaries removed


def test_dryrun_odd_count_is_pure_dp(tmp_path, capfd):
    from tod_tpu_torch.entry import dryrun_multichip

    os.environ["OMP_NUM_THREADS"] = "1"
    summary = dryrun_multichip(1, workdir=tmp_path)
    assert summary["mesh"] == {"dp": 1, "tp": 1}
    assert "dryrun slot 0/1: backend gloo, device cpu" in capfd.readouterr().out
    with pytest.raises(ValueError, match="at least 1"):
        dryrun_multichip(0)


def test_entry_is_the_flagship_forward():
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.core.weights import load_pinned
    from tod_tpu_torch.entry import entry
    from tod_tpu_torch.models.yolact import Yolact

    fn, (params, x) = entry(device="cpu")
    assert x.shape == (1, 256, 320, 3) and x.dtype == torch.bfloat16
    assert all(v.device.type == "cpu" for v in params.values())
    x = x + torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, x.shape)).to(x.dtype)
    outs = fn(params, x)
    model = Yolact(ModelConfig())
    model.load_state_dict(load_pinned())
    with torch.inference_mode():
        want = model.to(torch.bfloat16).eval()(x)
    for got, name in zip(outs, ("loc", "conf", "coeff", "prototypes", "sem_logits")):
        assert torch.equal(got, getattr(want, name)), name
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_native_build_names(monkeypatch, caplog):
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.native import build, loader, ring

    path = build.build()
    assert path == build.lib_path() and path.exists()
    assert build.lib_path(ring.SOURCE).exists() and not build.needs_build()
    assert build.ensure_built() == path
    assert loader.available()

    def fail(src):
        raise RuntimeError("g++ failed for planner.cpp")

    monkeypatch.setattr(_build, "build_host", fail)
    with caplog.at_level(logging.WARNING):
        assert build.ensure_built() is None
    assert "falls back to NumPy" in caplog.text
    with pytest.raises(RuntimeError):
        build.build()


def test_python_m_native_build():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "tod_tpu_torch.native.build"],
                         capture_output=True, text=True, timeout=300, check=True)
    assert "libplanner-" in out.stdout and "libframesource-" in out.stdout
