"""The harness: resolves a cell of ``BENCHMARK.json`` to its files by name,
runs its driver once and prints the result line.

A cell names a configuration (``benchmark/configs/<config>.json``, the
file ``BENCHMARK.json`` gives) and a traffic mix
(``benchmark/traffic/<traffic>.json``); the mix names its driver
(``benchmark/drivers/<driver>.py``, whose ``run(ctx)`` drives the program);
each per-layer metric the cell reports is read by
``benchmark/metrics/<metric>.py`` (``read(records) -> float | None``) from
the traced run's records.  A later cell, configuration, mix or metric is a
new file and a manifest entry: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tod_tpu")
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``tod_tpu_torch`` is the program)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def set_environment() -> None:
    """Caches inside the checkout at fixed paths; no library may load JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    driver: pathlib.Path
    end_to_end: list
    per_layer: list
    root: pathlib.Path = ROOT

    def reader(self, metric: str) -> pathlib.Path:
        return self.root / "benchmark" / "metrics" / f"{metric}.py"


def manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: pathlib.Path = ROOT, man: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, mix, driver and metrics."""
    man = man or manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    driver = root / "benchmark" / "drivers" / f"{mix['driver']}.py"
    if not driver.is_file():
        raise FileNotFoundError(f"mix {w['traffic']} names driver {driver}, which is missing")
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    # a per-layer metric is read where it lists the cell, or, without a
    # list, wherever the end-to-end metric it moves is reported
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"] if ("workloads" in m and name in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, w, config, mix, driver, e2e, layer, root)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the process's
    start, and a log to standard error."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    control: bool = False
    fault: str | None = None
    readings: dict = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        if not self.control:
            return self.cell.config
        return merge(self.cell.config, self.cell.config.get("control", {}))

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def log(self, *parts) -> None:
        print("[bench]", *parts, file=sys.stderr, flush=True)


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def power_limit_w(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        import torch

        uuid = str(torch.cuda.get_device_properties(index).uuid)
        out = subprocess.run(["nvidia-smi", "-i", f"GPU-{uuid}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "unknown"
    except Exception as e:  # the limit is a note beside the numbers, not a result
        return f"unknown ({type(e).__name__})"


def peak(kind: str, name: str) -> float | None:
    """The published peak ``name`` (``bf16``, ``fp32``, ``hbm_bytes_s``...)
    of the card ``kind``, None for a card the table does not know."""
    for card, row in PEAKS["cards"].items():
        if kind.startswith(card):
            return row.get(name)
    return None


def run_cell(ctx: Context) -> dict:
    """Drive the cell once -> the result (its keys in order, and
    ``checks`` last)."""
    driver = load_module(ctx.cell.driver)
    out = driver.run(ctx)
    if ctx.trace:
        records = out.pop("records")
        metrics = {}
        for m in ctx.cell.per_layer:
            value = load_module(ctx.cell.reader(m["name"])).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in ctx.cell.end_to_end if out["metrics"].get(m["name"]) is not None}
    checks = out["checks"]
    if ctx.readings:
        out.setdefault("notes", {})["readings"] = ctx.readings
    correct = bool(checks) and all(c["value"] is not None and math.isfinite(c["value"])
                                   and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": out["device"]}
    if ctx.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    for key in ("setup_stages", "notes"):
        if key in out:
            result[key] = out[key]
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
