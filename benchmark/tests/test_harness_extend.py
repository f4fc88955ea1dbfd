"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and manifest entries, in a copy, with no harness file edited."""

from __future__ import annotations

import hashlib
import json

from benchmark.tests.tiny import ROOT, run_tiny, tiny_copy


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*.py")}


def test_new_cell_from_files_only(tmp_path):
    root = tiny_copy(tmp_path)
    before = _digest(root)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "tiny_train.json").read_text())
    config["name"] = "throwaway"
    config["model"]["input_size"] = [64, 96]
    (bench / "configs" / "throwaway.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "tiny_steps.json").read_text())
    mix["pool_batches"] = 5
    (bench / "traffic" / "five_batches.json").write_text(json.dumps(mix))
    (bench / "metrics" / "train.step_count.py").write_text(
        'def read(records):\n    s = records["spans"].get("bench.train_step")\n'
        '    return float(s["count"]) if s else None\n')
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "throwaway", "source": "a test", "reduced": [], "why": "a test",
                           "file": "benchmark/configs/throwaway.json"})
    man["workloads"].append({"name": "throwaway.five", "config": "throwaway",
                             "traffic": "five_batches", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("throwaway.five")
    man["per_layer"].append({"name": "train.step_count", "unit": "steps", "better": "higher",
                             "source": "program_span", "layer": "train step",
                             "moves": "train_images_per_s", "workloads": ["throwaway.five"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    plain = run_tiny(root, "throwaway.five")
    traced = run_tiny(root, "throwaway.five", trace=True, seconds=2.5)
    assert plain["correct"] and plain["attempted"] % 2 == 0
    assert set(plain["metrics"]) == {"train_images_per_s", "setup_s"}
    assert traced["metrics"]["train.step_count"]["value"] >= 1
    assert _digest(root) == {**before, "benchmark/metrics/train.step_count.py":
                             _digest(root)["benchmark/metrics/train.step_count.py"]}
    assert not (ROOT / "benchmark" / "metrics" / "train.step_count.py").exists()
