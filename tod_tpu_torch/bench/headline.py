"""The headline line on the card (counterpart of the repo-root ``bench.py``):
``python -m tod_tpu_torch.bench.headline`` prints one JSON line.

The pipeline at 320x240, model at 240x320, bf16, pinned weights, the
device planner:

- ``fps_e2e_320x240_b1`` (also ``metric``/``value``): the best of 3
  ``Engine.run`` streams of 200 synthetic frames, with that run's
  ``latency`` p50 and p90 (``p50_frame_ms``, ``p90_frame_ms``) and ``plan``
  p50, and ``vs_baseline`` against the reference's 7 fps;
- ``bounded_*``: 2 in flight, a plan every 4th frame, the run (of 2) with
  the lowest ``latency`` p50;
- ``transport_rtt_ms``: the median 4-byte readback of a finished tensor;
- ``device_step_ms``: 128 ``serve_step_plan`` calls chained on one packed
  synthetic frame on the device, ended by one 4-byte readback, timed by
  CUDA events (``configs.chained_step_s``; the host clock's in
  ``device_step_host_ms``).  The step is host-bound, so this is the launch
  rate of a frame, not its busy device time, which is ``device_busy_ms``;
- ``mfu``: the step's model FLOPs (``configs.count_flops``) over
  ``device_step_ms`` against the card's bf16 peak, ``step_gflops``;
- ``compile_s`` (the engine's warm-up) and ``compile_breakdown_s``;
- ``boot_cold_s`` / ``boot_warm_s`` and their stages: two children of
  ``bench.boot``, the first on an empty build directory, the second on the
  one it filled; ``boot_aot_s``, a third child booting a ``plan`` artifact
  exported ``--aot`` from this engine into another empty build directory
  (``bench.boot --todx``), which raises unless it compiled nothing;
- ``device_busy_ms`` and ``idle_share``: 8 serve steps under
  ``torch.profiler`` (``profiling.top_ops``, which raises where the
  profile holds no CUDA activity), taken after every timed run because a
  profiler session slows later launches; ``profiled`` says so, and names
  the timeline read (``cuda``; ``cpu`` and 1 step on the CPU).
  ``idle_share_chained`` is ``1 - device_busy_ms / device_step_ms``: the
  kernels' own times (which the profiler does not stretch) over the
  chained step's window without the profiler;
- ``device``: the card's name, power limit and count.

``bench.py``'s ``weather`` and its round-trip-corrected fields measure a
remote TPU transport and are left out, as in configs 8 and 17.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

from tod_tpu_torch.bench.configs import (
    _bounded_point,
    _count,
    _engine,
    _labels,
    _mfu,
    _pipeline_cfg,
    chained_step_s,
    count_flops,
    streaming,
    transport_rtt_ms,
)
from tod_tpu_torch.core.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
HW = (240, 320)


def _boot_child(build_dir: str, timeout: float, todx: str | None = None) -> dict:
    env = dict(os.environ, TOD_BOOT_T0=repr(time.time()))
    r = subprocess.run(
        [sys.executable, "-m", "tod_tpu_torch.bench.boot", "--build-dir", build_dir,
         "--width", str(HW[1]), "--height", str(HW[0]), *(["--todx", todx] if todx else [])],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )
    if r.returncode != 0:
        raise RuntimeError(f"boot child failed (rc {r.returncode}): {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def boot_metrics(eng, timeout: float = 600.0) -> dict:
    """A cold boot (an empty build directory under ``build/``), a warm one
    (the directory the cold boot filled) and an ``aot`` one (``eng``'s
    ``plan`` step frozen with its kernel libraries, booted into another
    empty build directory, where it must compile nothing), each a child
    process."""
    from tod_tpu_torch.deploy import build_aot, export_engine, save_artifact
    from tod_tpu_torch.kernels import _build

    root = _build.BUILD_DIR.parent
    root.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="boot-", dir=root) as build_dir:
        for key in ("cold", "warm"):
            r = _boot_child(build_dir, timeout)
            out[f"boot_{key}_s"] = r["boot_to_first_plan_s"]
            out[f"boot_{key}_stages"] = r["stages_s"]
    with tempfile.TemporaryDirectory(prefix="boot-aot-", dir=root) as build_dir:
        exported, meta = export_engine(eng, "plan")
        blob, aot = build_aot(meta, eng.device)
        todx = os.path.join(build_dir, "plan.todx")
        save_artifact(exported, meta, todx, aot_blob=blob, aot_meta=aot)
        r = _boot_child(os.path.join(build_dir, "lib"), timeout, todx=todx)
    if r["boot"] != "todx-aot" or r["nvcc_built"]:
        raise RuntimeError(f"the aot boot was {r['boot']} and compiled {r['nvcc_built']}")
    out["boot_aot_s"] = r["boot_to_first_plan_s"]
    out["boot_aot_stages"] = r["stages_s"]
    return out


def measure(device=None, n_frames: int | None = None, runs: int | None = None,
            bounded_runs: int | None = None, k: int | None = None) -> dict:
    """The headline on ``device`` (default the card).  The counts default
    to ``bench.py``'s on the card and its CPU counts on the CPU, where no
    boot child runs (the boot CLI asks for the card)."""
    from tod_tpu_torch.bench.profiling import capture_trace, top_ops
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_frames = _count(n_frames, dev, 200, 5)
    k = _count(k, dev, 128, 2)

    eng = _engine(_pipeline_cfg(HW), dev)
    compile_s = eng.warmup()
    unbounded = [streaming(HW, n_frames, dev, eng=eng) for _ in range(_count(runs, dev, 3, 1))]
    best = max(unbounded, key=lambda line: line["value"])
    bounded = min((_bounded_point(eng, 2, n_frames) for _ in range(_count(bounded_runs, dev, 2, 1))),
                  key=lambda point: point["p50_ms"] or float("inf"))

    rtt_ms = transport_rtt_ms(device=dev)
    frame0 = next(SyntheticSource(eng.cfg.camera, seed=0, n_frames=1).frames())
    packed = torch.from_numpy(pack_frame(frame0.rgb, frame0.depth)).to(dev)
    step_s, step_host_s, _ = chained_step_s(eng.serve_step_plan, packed, k, dev)
    flops = count_flops(eng.serve_step_plan, packed)

    result = {
        **{key: best[key] for key in ("metric", "value", "unit")},
        "fps_e2e_320x240_b1": best["value"],
        "vs_baseline": best["vs_baseline"],
        "fps_all_runs": [line["value"] for line in unbounded],
        **{key: best[key] for key in ("p50_frame_ms", "p90_frame_ms", "plan_p50_ms")},
        "bounded_fps": bounded["fps"],
        "bounded_p50_ms": bounded["p50_ms"],
        "bounded_p99_ms": bounded["p99_ms"],
        "bounded_plan_p50_ms": bounded["plan_p50_ms"],
        "transport_rtt_ms": round(rtt_ms, 5),
        "device_step_ms": round(step_s * 1e3, 4),
        "device_step_host_ms": round(step_host_s * 1e3, 4),
        "device_step_k": k,
        "mfu": _mfu(flops, step_s, dev),
        "step_gflops": round(flops / 1e9, 4),
        "compile_s": round(compile_s, 3),
        "compile_breakdown_s": eng.warmup_breakdown,
        "n_frames": best["n_frames"],
        "weights": "tod_tpu_torch/weights/yolact_dr.npz",
    }
    if on_card:
        result.update(boot_metrics(eng))
    else:
        result.update(boot_cold_s=None, boot_warm_s=None, boot_aot_s=None)
    # last: a profiler session slows the launches that follow it
    steps = 8 if on_card else 1
    report = top_ops(capture_trace(lambda: eng.serve_step_plan(packed), dev, steps), dev, steps)
    result.update(
        device_busy_ms=report["busy_ms"],
        idle_share=report["idle_share"],
        idle_share_chained=round(1.0 - report["busy_ms"] / (step_s * 1e3), 4),
        profiled={"under_profiler": True, "steps": steps, "wall_ms": report["wall_ms"],
                  "timeline": report["timeline"], "fields": ["device_busy_ms", "idle_share"]},
        **_labels(dev),
    )
    return result


def main(argv=None, device=None) -> int:
    """Print the headline line (on the card unless ``device`` says)."""
    import argparse

    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    print(json.dumps(measure(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
