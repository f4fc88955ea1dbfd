"""Tiny CPU runs of each driver: a well-formed result line, no device
number from the CPU, and each planted fault of the timed path turning
``correct`` false."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import harness
from benchmark.tests.tiny import run_tiny

DEVICE_METRICS = {"train.busy_ms", "mfu.train", "idle_share.train"}


def _line(result: dict) -> tuple[dict, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.print_result(result)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("cell", ["tiny.train"])
def test_untraced_run_prints_the_result_line(tiny_root, cell):
    line, err = _line(run_tiny(tiny_root, cell))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    expected = {m["name"] for m in harness.resolve(cell, root=tiny_root).end_to_end}
    assert set(line["metrics"]) == expected
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu" and "busy_s" not in line["device"]
    for name, c in line["checks"].items():
        assert f"check {name} = " in err and c["value"] <= c["limit"]
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", ["tiny.train"])
def test_traced_run_reads_no_device_number_on_the_cpu(tiny_root, cell):
    line, _ = _line(run_tiny(tiny_root, cell, trace=True, seconds=2.5))
    assert not set(line["metrics"]) & DEVICE_METRICS
    assert "busy_s" not in line["device"] and "breakdown" not in line


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny.train", "half_batch", None),
    ("tiny.train", "altered", "loss_gap"),
    ("tiny.train", "unchanged", "update_gap"),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault, number):
    result = run_tiny(tiny_root, cell, fault=fault)
    assert result["correct"] is False
    failed = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert failed and (number is None or number in failed)
