"""A tiny CPU-sized cell for the benchmark's tests, added to a throwaway
copy of the benchmark as new files and manifest entries only."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]


def tiny_copy(dest: pathlib.Path) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` in ``dest`` with the
    CPU-sized cell ``tiny.train`` (the training driver at batch 2 and 64x80)
    beside the real ones, added as new files and manifest entries only."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".tmp", "__pycache__"))
    bench = dest / "benchmark"
    man = json.loads((dest / "BENCHMARK.json").read_text())
    train = json.loads((bench / "configs" / "yolact_mnv2_vga_train.json").read_text())
    train.update(name="tiny_train")
    train["model"]["input_size"] = [64, 80]
    train["train"]["batch_size"] = 2
    # at 64x80 and batch 2 the deepest BatchNorms normalise two values, and
    # the bf16 loss reads up to ~0.6% from the reference's on the CPU
    train["limits"]["loss_gap"] = 0.015
    steps = json.loads((bench / "traffic" / "scenes4.json").read_text())
    steps.update(warm_steps=1, trace_lead_s=0.2, trace_seconds=0.6)
    for kind, name, body in (("configs", "tiny_train", train), ("traffic", "tiny_steps", steps)):
        (bench / kind / f"{name}.json").write_text(json.dumps(body))
    man["configs"].append({"name": "tiny_train", "source": "a test", "reduced": [], "why": "a test",
                           "file": "benchmark/configs/tiny_train.json"})
    man["workloads"].append({"name": "tiny.train", "config": "tiny_train", "traffic": "tiny_steps",
                             "chips": 1, "why": "a CPU-sized copy of mnv2_train.b16"})
    for metric in man["end_to_end"] + man["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append("tiny.train")
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dest


def run_tiny(root: pathlib.Path, cell: str, trace: bool = False, fault: str | None = None,
             seconds: float = 2.0, seed: int = 2 ** 31 + 11) -> dict:
    import time

    import torch

    from benchmark import harness

    torch.set_num_threads(1)
    ctx = harness.Context(harness.resolve(cell, root=root), seed, seconds, trace, "cpu",
                          time.perf_counter(), fault=fault)
    return harness.run_cell(ctx)
