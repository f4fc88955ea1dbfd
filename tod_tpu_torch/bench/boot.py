"""Boot to first plan: how long a robot waits after starting the server
before its first plan (counterpart of ``tod_tpu/bench/boot.py``).

Run as a child process, so that the time holds everything a real boot
pays::

    TOD_BOOT_T0=$(date +%s.%N) python -m tod_tpu_torch.bench.boot \\
        --build-dir DIR [--width W --height H]

``TOD_BOOT_T0`` is the parent's clock just before it started the child
(without it, this module's import).  The child prints one JSON line:
``boot_to_first_plan_s`` against it and ``stages_s``, each stage's own
seconds, in order: ``python`` (interpreter start to this module),
``import_torch``, ``device_first_touch`` (the CUDA context and a first
copy), ``frame_prep`` (a synthetic frame, packed), ``weights_load`` (the
pinned npz, carried across), ``kernel_build_or_load`` (nvcc for every
``csrc/*.cu`` and g++ for the native planner where ``--build-dir`` lacks
them, then the path's libraries loaded), ``warmup`` (the engine on the
device and its ``warmup()``: cuDNN plans, first launches) and
``first_plan`` (the frame through ``serve_step_plan``, its plan read
back).  A cold boot points ``--build-dir`` at an empty directory, a warm
boot at the one the cold boot filled: the counterpart of the JAX boot's
``--cache``.  ``--todx ARTIFACT`` boots from a frozen ``plan`` artifact
instead: ``artifact_load`` (read, install its kernel libraries when they
fit this card, deserialize; its own stages in ``artifact_load_stages``)
replaces the weights, build and warm-up stages, ``first_plan`` runs the
frozen step, and ``boot`` is ``"todx-"`` + the artifact's boot (``aot``:
no nvcc).  ``nvcc_built`` lists the sources the boot compiled.
"""

from __future__ import annotations

import os
import time

_T0 = float(os.environ.get("TOD_BOOT_T0", time.time()))

import argparse  # noqa: E402  (the clock above starts first)
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None, device=None) -> int:
    """Boot on ``device`` (default the card; the tests pass ``"cpu"``,
    where no CUDA source is built)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--build-dir", default=None,
                   help="build and load the libraries here (default build/tod_tpu_torch)")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--todx", default=None, help="boot from a frozen artifact")
    args = p.parse_args(argv)

    stages = {"python": round(time.time() - _T0, 3)}
    t_prev = time.time()

    def stage(name: str) -> None:
        nonlocal t_prev
        now = time.time()
        stages[name] = round(now - t_prev, 3)
        t_prev = now

    import numpy  # noqa: F401
    import torch

    stage("import_torch")
    from tod_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    torch.zeros(8, device=dev).cpu()
    stage("device_first_touch")

    from tod_tpu_torch.core.config import CameraConfig
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    h, w = args.height, args.width
    cam = CameraConfig(width=w, height=h)
    frame = next(SyntheticSource(cam, seed=0, n_frames=1).frames())
    packed = torch.from_numpy(pack_frame(frame.rgb, frame.depth))
    if dev.type == "cuda":
        packed = packed.pin_memory()
    stage("frame_prep")

    from tod_tpu_torch.kernels import _build

    if args.build_dir:
        _build.set_build_dir(args.build_dir)
    if args.todx:
        from tod_tpu_torch.deploy import ServingArtifact

        art = ServingArtifact.load(args.todx, device=dev)
        stage("artifact_load")
        stages["artifact_load_stages"] = art.load_stages
        path = art.plan(packed)
        stage("first_plan")
        boot = "todx-" + art.boot
    else:
        path = _engine_boot(dev, cam, packed, stage)
        boot = "engine"

    from tod_tpu_torch.bench.configs import device_info

    print(json.dumps({
        "boot_to_first_plan_s": round(time.time() - _T0, 3),
        "stages_s": stages,
        "boot": boot,
        "build_dir": str(_build.BUILD_DIR),
        "nvcc_built": _build.built,
        "first_path_len": len(path.directions),
        "backend": dev.type,
        "device": device_info(dev),
    }), flush=True)
    return 0


def _engine_boot(dev, cam, packed, stage):
    """The engine's boot after ``frame_prep``: weights, kernels, warm-up,
    first plan -> the first Path."""
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig, PlannerConfig
    from tod_tpu_torch.core.weights import load_pinned

    h, w = cam.height, cam.width
    cfg = PipelineConfig(camera=cam, model=ModelConfig(input_size=(h // 8 * 8, w // 8 * 8)),
                         planner=PlannerConfig(backend="tpu"))
    state = load_pinned(cfg=cfg.model)
    stage("weights_load")

    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.native import loader

    if dev.type == "cuda":
        from tod_tpu_torch.kernels import bump, connections, mask_assembly, path_walk, relax

        _build.build(sorted(src.stem for src in _build.CSRC.glob("*.cu")))
        for mod in (mask_assembly, bump, connections, relax, path_walk):
            _build.load(mod.SOURCE, mod.SIGNATURES)
    if not loader.available():
        raise RuntimeError("the native planner did not build")
    stage("kernel_build_or_load")

    from tod_tpu_torch.planner.api import materialize_path
    from tod_tpu_torch.runtime.engine import Engine

    engine = Engine(cfg, state, device=dev)
    engine.warmup()
    stage("warmup")
    path = materialize_path(engine.serve_step_plan(packed))
    stage("first_plan")
    return path


if __name__ == "__main__":
    sys.exit(main())
