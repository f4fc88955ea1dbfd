"""``BENCHMARK.json`` against its required shape, and every cell resolved
to its files by name."""

from __future__ import annotations

import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_shape():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"] and man["command"][1] == "benchmark/run.py"
    assert 1 <= man["run_seconds"] <= 51
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/configs/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert m["better"] in {"lower", "higher"}
    layers = {}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["source"] in SOURCES and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_resolves_by_name():
    man = harness.manifest()
    for w in man["workloads"]:
        cell = harness.resolve(w["name"])
        assert cell.driver.is_file()
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == []
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert cell.reader(m["name"]).is_file(), m["name"]
            assert w["name"] in m["workloads"]
        assert harness.load_module(cell.driver).run
        assert cell.config["limits"], "every configuration states the limits of its check"
