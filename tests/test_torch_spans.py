"""The program's spans and counters (``runtime/profiler.py``): ``span``
records host time into ``SPANS`` always and opens a profiler range only
while a profiler session is active in the process; ``count`` and
``reset(prefix)``; and ``Trainer.train``'s ``train/*`` spans and counters
over two steps on the CPU (each phase nested in its step, in order, on the
profile's clock), the metrics rows that carry them, and the ``mark`` hook
the benchmark's training harness still passes."""

from __future__ import annotations

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tod_tpu_torch.core import config
from tod_tpu_torch.runtime.profiler import SPANS, StageTimer, count, span
from tod_tpu_torch.train import SyntheticDetectionData, Trainer
from tod_tpu_torch.train.trainer import BATCH_KEYS

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

HW = (48, 64)
TINY = config.ModelConfig(input_size=HW, fpn_channels=16, proto_channels=16, head_channels=16,
                          width_mult=0.35, num_prototypes=8, nms_top_k=8, max_detections=4)
TCFG = config.TrainConfig(batch_size=2, learning_rate=5e-3, warmup_steps=1, total_steps=8)
PHASES = ("augment", "forward", "loss", "backward", "optimizer")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
def test_span_records_host_time(profiled):
    SPANS.reset("test/")
    with _cpu_profile() if profiled else contextlib.nullcontext():
        with span("test/sleep"):
            time.sleep(0.002)
        with pytest.raises(KeyError), span("test/raised"):
            raise KeyError("not recorded")
    stats = SPANS.stats("test/sleep")
    assert stats["n"] == 1 and 2.0 <= stats["p50_ms"] < 1000.0
    assert SPANS.stats("test/raised") == {"n": 0}


def test_span_opens_a_profiler_range_only_while_a_profiler_is_active():
    early = span("test/before")
    early.__enter__()
    seen = {}

    def other_thread():
        s = span("test/thread")
        with s:
            # the process-wide flag, where torch's per-thread check says no
            seen["range"] = s._range is not None
            seen["per_thread"] = torch.autograd._profiler_enabled()

    with _cpu_profile() as prof:
        early.__exit__(None, None, None)
        with span("test/inside"):
            torch.ones(3).add_(1)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(30)
    assert not t.is_alive()
    with span("test/after"):
        torch.ones(3).add_(1)
    names = {e.name for e in prof.events()}
    assert "test/inside" in names
    assert "test/before" not in names and "test/after" not in names
    assert seen == {"range": True, "per_thread": False}


def test_count_and_reset_by_prefix():
    timer = StageTimer()
    for name, n in (("a/x", 2), ("a/x", 3), ("a/y", 1), ("b/x", 7)):
        timer.count(name, n)
        timer.record(name, 0.001)
    assert (timer.counter("a/x"), timer.counter("a/y"), timer.counter("b/x")) == (5, 1, 7)
    assert timer.counter("missing") == 0
    assert set(timer.summary("a/")) == {"a/x", "a/y"}
    timer.reset("a/")
    assert timer.counter("a/x") == 0 and timer.stats("a/x") == {"n": 0}
    assert timer.counter("b/x") == 7 and timer.stats("b/x")["n"] == 1
    timer.reset()
    assert timer.counter("b/x") == 0 and timer.summary() == {}
    SPANS.reset("test/")
    count("test/c", 4)
    count("test/c")
    assert SPANS.counter("test/c") == 5


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of ``Trainer.train`` under a CPU profile, with the step
    wrapped as the benchmark's training harness wraps it (``mark`` passed
    positionally), then a second call of one step."""
    tr = Trainer(TINY, TCFG, device="cpu")
    marks = []
    inner = tr._step

    def step(batch, index, mark=None):
        return inner(batch, index, marks.append)

    tr._step = step
    rows = tmp_path_factory.mktemp("spans") / "m.jsonl"
    data = SyntheticDetectionData(HW, batch_size=2, seed=0)
    with _cpu_profile() as prof:
        tr.train(data, steps=2, log_every=1, log_fn=lambda *_: None, metrics_path=str(rows))
    first = {"spans": SPANS.summary("train/"),
             "counts": {k: SPANS.counter(k) for k in ("train/steps", "train/h2d_bytes",
                                                      "train/idle_at_batch",
                                                      "train/idle_at_launch")}}
    batch = SyntheticDetectionData(HW, batch_size=2, seed=0).next_batch()
    # int32 fields reach the device as int64
    nbytes = sum(batch[k].nbytes * (2 if batch[k].dtype == np.int32 else 1) for k in BATCH_KEYS)
    tr.train(data, steps=1, log_every=10 ** 9, log_fn=lambda *_: None)
    second = {"spans": SPANS.summary("train/"),
              "counts": {k: SPANS.counter(k) for k in ("train/steps", "train/h2d_bytes")}}
    ranges = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                    if e.name.startswith("train/"))
    return {"first": first, "second": second, "marks": marks, "nbytes": nbytes,
            "ranges": [(s, -e, n) for s, e, n in ranges],
            "rows": [json.loads(line) for line in rows.read_text().splitlines()]}


def test_train_fills_each_span_once_a_step(trained):
    spans = trained["first"]["spans"]
    for name in ("step", "batch", *PHASES):
        assert spans[f"train/{name}"]["n"] == 2, name
    assert spans["train/log"]["n"] == 2
    assert trained["first"]["counts"]["train/steps"] == 2
    # no CUDA event on the CPU: the idle counters stay at zero
    assert trained["first"]["counts"]["train/idle_at_batch"] == 0
    assert trained["first"]["counts"]["train/idle_at_launch"] == 0


def test_train_phases_nest_in_each_step_in_order(trained):
    steps = [(s, e) for s, e, n in trained["ranges"] if n == "train/step"]
    assert len(steps) == 2
    for s0, e0 in steps:
        inside = [(s, e, n[len("train/"):]) for s, e, n in trained["ranges"]
                  if n != "train/step" and s0 <= s and e <= e0]
        assert [n for _, _, n in inside] == ["batch", *PHASES, "log"]
        # one after another, none overlapping
        assert all(a[1] <= b[0] for a, b in zip(inside, inside[1:]))


def test_train_counts_the_bytes_handed_to_the_device(trained):
    assert trained["first"]["counts"]["train/h2d_bytes"] == 2 * trained["nbytes"]


def test_a_second_call_starts_the_train_names_afresh(trained):
    second = trained["second"]
    assert second["counts"] == {"train/steps": 1, "train/h2d_bytes": trained["nbytes"]}
    for name in ("step", "batch", *PHASES, "log"):
        assert second["spans"][f"train/{name}"]["n"] == 1, name


def test_mark_is_still_called_once_a_phase(trained):
    assert trained["marks"] == [*PHASES, *PHASES, *PHASES]


def test_metrics_rows_carry_host_ms_and_idle_shares(trained):
    rows = [r for r in trained["rows"] if r["kind"] == "train"]
    assert len(rows) == 2
    for row in rows:
        assert set(PHASES) | {"batch"} <= set(row["host_ms"])
        assert row["idle_at_batch_share"] is None and row["idle_at_launch_share"] is None
    assert "step" in rows[1]["host_ms"] and rows[1]["host_ms"]["step"] > 0
