"""Frozen serving artifacts: the whole serving step as one deployable file
(counterpart of the JAX package's ``deploy.py``).

The robot carries one file and a thin runtime, never the model code.  An
artifact freezes one of the engine's serving steps with ``torch.export``:
preprocess, the forward with its weights (BN-folded, or the prepared int8
sites with their packed kernels), detection cleanup, scene fusion and, in
the plan modes, the device planner.  Each hand-written kernel is a
``torch.library`` custom op (``tod::*``, registered by its wrapper module),
so the graph keeps the kernel's launch on the card and its plain version on
the CPU: every artifact runs on either.

File format (the port's own: torch cannot read the JAX package's
StableHLO)::

    b"TODXPT1\\n" | u64-LE header length | JSON header | torch.export payload
                  | [built kernel libraries]

The JSON header carries the JAX header's I/O contract and provenance
(mode, camera, packed-input bytes, model and planner facts, engine mode,
platforms) with ``torch_version``, ``cuda_version``, the export ``device``,
the ``kernels`` the graph launches (their ``csrc`` sources), the
``kernel_limits`` the card's kernels would refuse (ROADMAP.md D, D5) and
``payload_bytes``.  With ``--aot`` an ``aot`` block lists the built library
of each of those sources (its ``kernels/_build.library_path`` name, which
hashes the source, the headers and the flags, its size and its sha256) and
the card's compute capability; a loader on a card of that capability whose
own sources hash to the same names, and whose copy of the bytes matches
the digests, writes them into the build directory and boots with no nvcc
(``boot == "aot"``).  Any other loader builds from its sources at the
first launch (``boot == "jit"``).  A ``tod_tpu`` file (``b"TODX1\\n"``)
is refused.

Modes, as in the JAX package:

- ``"plan"``: packed (H*W*5,) u8 frame -> (max_steps+1, 2) f32 plan buffer;
- ``"track_plan"``: ``(packed, bank) -> (plan, bank)``: the tracker kernel
  advances the ``(max_tracks, 10)`` bank in place;
- ``"scene"``: packed frame -> (height (H, W) f32, balls (N, 4) f32);
- ``"packed"``: packed frame -> (H*W*2 + 16*N,) u8 height and balls.

CLI::

    python -m tod_tpu_torch.deploy export --out model.todx [--checkpoint X.npz] [--aot]
    python -m tod_tpu_torch.deploy info model.todx
    python -m tod_tpu_torch.deploy serve model.todx --source synthetic --frames 300
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import struct
import time
from typing import Optional

import numpy as np
import torch

MAGIC = b"TODXPT1\n"
JAX_MAGIC = b"TODX1\n"
FORMAT = 1
MODES = ("plan", "track_plan", "scene", "packed")
EXPORT_COMMAND = "python -m tod_tpu_torch.deploy export"

log = logging.getLogger("tod_tpu_torch.deploy")


def kernel_sources() -> dict[str, str]:
    """Each kernel's custom op -> its ``csrc`` source.  Importing the
    wrappers registers the ops, which ``torch.export.load`` needs."""
    from tod_tpu_torch.kernels import (
        bump,
        cc_labels,
        connections,
        mask_assembly,
        path_walk,
        qconv,
        relax,
        track,
    )

    return {
        "tod::assemble_crop_masks": mask_assembly.SOURCE,
        "tod::connection_planes": connections.SOURCE,
        "tod::dilate_peaks": bump.SOURCE,
        "tod::dilate_peaks_strips": bump.SOURCE,
        "tod::bellman_ford_grid": relax.SOURCE,
        "tod::walk_path": path_walk.SOURCE,
        "tod::root_labels": cc_labels.SOURCE,
        "tod::track_banks": track.SOURCE,
        "tod::qconv": qconv.SOURCE,
    }


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class _Frozen(torch.nn.Module):
    """One serving step of an engine as a module whose parameters and
    buffers are the engine's model's (they become the artifact's
    constants)."""

    def __init__(self, engine, mode: str):
        super().__init__()
        self.model = engine.model
        self._step = {
            "plan": engine.serve_step_plan,
            "track_plan": engine.serve_step_track_plan,
            "scene": engine.serve_step_scene,
            "packed": engine.serve_step_packed,
        }[mode]

    def forward(self, packed: torch.Tensor, *state: torch.Tensor):
        return self._step(packed, *state)


def _example_inputs(engine, mode: str) -> tuple[torch.Tensor, ...]:
    """The step's inputs on the engine's device: the artifact takes the
    packed frame there (``ServingArtifact.call`` copies a host buffer over)."""
    h, w = engine.cam_hw
    packed = torch.zeros(h * w * 5, dtype=torch.uint8, device=engine.device)
    return (packed, engine._init_tracks()) if mode == "track_plan" else (packed,)


def export_engine(engine, mode: str = "plan", platforms=None, portable: bool = False):
    """Freeze one of ``engine``'s serving steps with its weights ->
    ``(torch.export.ExportedProgram, meta)``.

    The step runs once eagerly first (on the card that builds and loads its
    kernels, and it fills the host-computed constants' caches with real
    tensors, which the trace then takes as constants).  ``platforms`` and
    ``portable`` are recorded: every port artifact runs on the CPU and the
    card alike."""
    from tod_tpu_torch.kernels.limits import kernel_limits

    if mode not in MODES:
        raise ValueError(f"unknown artifact mode {mode!r} (use {'/'.join(MODES)})")
    if mode == "track_plan":
        if not engine.cfg.tracker.enabled:
            raise ValueError("track_plan export needs a tracked engine "
                             "(TrackerConfig.enabled; deploy export --track)")
        if engine._obstacle_mem_mode:
            raise ValueError("track_plan freezes the tracked step without the obstacle "
                             "memory: export an engine with tracker.obstacle_memory = 0")
    module = _Frozen(engine, mode).eval()
    example = _example_inputs(engine, mode)
    warm = tuple(t.clone() for t in example)
    module(*warm)
    with torch.no_grad():
        exported = torch.export.export(module, example, strict=False)
    ops = {"tod::" + str(n.target).split(".")[1] for n in exported.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("tod.")}
    sources = kernel_sources()
    cam, pcfg, mcfg = engine.cfg.camera, engine.cfg.planner, engine.cfg.model
    meta = {
        "format": FORMAT,
        "mode": mode,
        "camera": {"height": cam.height, "width": cam.width},
        "packed_input_bytes": cam.height * cam.width * 5,
        "model": {
            "input_size": list(mcfg.input_size),
            "quantized": bool(mcfg.quantized),
            "backbone": mcfg.backbone,
            "dtype": mcfg.dtype,
        },
        "planner": {
            "max_path_steps": pcfg.max_path_steps,
            "max_seed_balls": pcfg.max_seed_balls,
            "signed_turns": pcfg.signed_turns,
            "start_offset": pcfg.start_offset,
        },
        "engine_mode": engine.mode,
        "platforms": list(platforms) if platforms else ["cpu", "cuda"],
        "portable": bool(portable),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": engine.device.type,
        "kernels": sorted({sources[op] for op in ops}),
        "kernel_limits": kernel_limits(engine.cfg, engine.mode),
        "created_unix": time.time(),
    }
    if mode == "track_plan":
        meta["tracker"] = {"max_tracks": engine.cfg.tracker.max_tracks,
                           "state_width": int(example[1].shape[1])}
    return exported, meta


def build_aot(meta: dict, device: torch.device) -> tuple[bytes, dict]:
    """The built library of each kernel the artifact launches, for an
    ``--aot`` artifact -> ``(blob, aot meta)``: the libraries one after
    another, listed by source, name, size and sha256, with ``device``'s
    compute capability.  Builds any that is missing."""
    from tod_tpu_torch.kernels import _build

    if device.type != "cuda":
        raise ValueError("--aot embeds the card's built kernel libraries: export on the card")
    _build.build(meta["kernels"])
    blobs, libs = [], []
    for source in meta["kernels"]:
        path = _build.library_path(source)
        data = path.read_bytes()
        blobs.append(data)
        libs.append({"source": source, "name": path.name, "bytes": len(data),
                     "sha256": hashlib.sha256(data).hexdigest()})
    return b"".join(blobs), {
        "compute_capability": list(torch.cuda.get_device_capability(device)),
        "device_name": torch.cuda.get_device_name(device),
        "libraries": libs,
    }


def save_artifact(exported, meta: dict, path: str, aot_blob: bytes | None = None,
                  aot_meta: dict | None = None) -> None:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    payload = buf.getvalue()
    meta = dict(meta, payload_bytes=len(payload))
    if aot_blob is not None:
        meta["aot"] = dict(aot_meta or {}, bytes=len(aot_blob))
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(payload)
        if aot_blob is not None:
            f.write(aot_blob)


def _read_header(f, path) -> dict:
    magic = f.read(len(MAGIC))
    if magic.startswith(JAX_MAGIC):
        raise ValueError(f"{path}: a tod_tpu (JAX) .todx artifact, whose StableHLO torch "
                         f"cannot read: export one for the port with `{EXPORT_COMMAND}`")
    if magic != MAGIC:
        raise ValueError(f"{path}: not a tod_tpu_torch artifact (bad magic {magic!r})")
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n))


def read_meta(path: str) -> dict:
    """Parse only the JSON header (no deserialization, no build)."""
    with open(path, "rb") as f:
        return _read_header(f, path)


# ---------------------------------------------------------------------------
# load + run
# ---------------------------------------------------------------------------

def planner_config_from_meta(meta: dict):
    """The planner semantics an artifact was exported with: host planning
    for ``scene``/``packed`` artifacts must match what a ``plan`` artifact
    would have frozen (signed turns, start column, seed and step caps)."""
    from tod_tpu_torch.core.config import PlannerConfig

    pmeta = meta.get("planner", {})
    return PlannerConfig(**{k: pmeta[k] for k in
                            ("signed_turns", "start_offset", "max_seed_balls", "max_path_steps")
                            if k in pmeta})


def install_libraries(aot: dict | None, blob: bytes, capability) -> bool:
    """Write an ``--aot`` artifact's kernel libraries into the build
    directory (write, then rename) when they were built for ``capability``,
    each one's name is the one this checkout's sources hash to, and the
    blob holds each one's bytes whole (its size and sha256) -> whether the
    boot needs no nvcc.  Otherwise writes nothing: the kernels build from
    the sources at their first launch."""
    from tod_tpu_torch.kernels import _build

    if not aot or list(aot.get("compute_capability", ())) != list(capability):
        return False
    libs = aot.get("libraries", [])
    if any(_build.library_path(lib["source"]).name != lib["name"] for lib in libs):
        return False
    datas, offset = [], 0
    for lib in libs:
        datas.append(blob[offset: offset + lib["bytes"]])
        offset += lib["bytes"]
    if offset != len(blob) or any(hashlib.sha256(data).hexdigest() != lib.get("sha256")
                                  for lib, data in zip(libs, datas)):
        log.warning("the artifact's kernel libraries are not the bytes its header lists "
                    "(truncated or changed): none is installed")
        return False
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for lib, data in zip(libs, datas):
        out = _build.library_path(lib["source"])
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.aot.tmp")
            tmp.write_bytes(data)
            os.replace(tmp, out)
    return True


class ServingArtifact:
    """A loaded frozen serving step.

    ``call(packed)`` runs it on one packed (H*W*5,) u8 frame; the output is
    the mode's.  Loading needs torch, numpy and the kernel wrappers; no
    model code runs.  ``boot``: ``"aot"`` when the artifact's libraries were
    installed (no nvcc), else ``"jit"``.  ``load_stages``: the seconds of
    each stage of the load."""

    def __init__(self, program, meta: dict, device: torch.device, boot: str,
                 load_stages: dict | None = None):
        self.meta = meta
        self.device = device
        self.boot = boot
        self.load_stages = load_stages or {}
        self._program = program
        self._module = program.module()

    @classmethod
    def load(cls, path: str, device=None) -> "ServingArtifact":
        """Read ``path`` onto ``device`` (the card when None)."""
        from tod_tpu_torch.core.device import resolve_device

        dev = resolve_device(device)
        stages: dict = {}
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            meta = _read_header(f, path)
            payload = f.read(meta["payload_bytes"])
            blob = f.read(meta["aot"]["bytes"]) if meta.get("aot") else b""
        stages["read_file"] = round(time.perf_counter() - t0, 3)
        if dev.type == "cuda" and meta.get("kernel_limits"):
            raise ValueError(f"{path}: the card's kernels cannot serve this artifact's "
                             f"configuration: " + "; ".join(meta["kernel_limits"]))
        t0 = time.perf_counter()
        boot = "jit"
        if dev.type == "cuda":
            if install_libraries(meta.get("aot"), blob, torch.cuda.get_device_capability(dev)):
                boot = "aot"
            else:
                log.info("%s: no kernel libraries for this card in the artifact; the kernels "
                         "build from the sources at their first launch (boot jit)", path)
        stages["install_libraries"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        kernel_sources()  # registers the tod:: ops
        program = torch.export.load(io.BytesIO(payload))
        stages["deserialize"] = round(time.perf_counter() - t0, 3)
        if meta.get("device") != dev.type:
            from torch.export.passes import move_to_device_pass

            t0 = time.perf_counter()
            program = move_to_device_pass(program, dev)
            stages["move_to_device"] = round(time.perf_counter() - t0, 3)
        return cls(program, meta, dev, boot, stages)

    def call(self, packed: torch.Tensor, *state: torch.Tensor):
        """Run the frozen step.  ``"track_plan"`` artifacts take the bank as
        a second argument, advance it in place and return ``(plan, bank)``."""
        n = self.meta["packed_input_bytes"]
        if tuple(getattr(packed, "shape", ())) != (n,) or packed.dtype != torch.uint8:
            raise ValueError(f"artifact expects a ({n},) uint8 packed frame, got "
                             f"{getattr(packed, 'shape', type(packed))}")
        tracked = self.meta["mode"] == "track_plan"
        if (len(state) == 1) != tracked:
            raise ValueError(f"a {self.meta['mode']!r} artifact takes "
                             f"{'(packed, bank)' if tracked else '(packed)'}")
        with torch.inference_mode():
            return self._module(packed.to(self.device, non_blocking=True), *state)

    def init_tracks(self) -> torch.Tensor:
        """A fresh all-inactive bank for a ``"track_plan"`` artifact, sized
        from the header."""
        tk = self.meta.get("tracker")
        if not tk:
            raise ValueError(f"init_tracks() needs a 'track_plan' artifact, this is "
                             f"{self.meta['mode']!r}")
        return torch.zeros((tk["max_tracks"], tk["state_width"]), dtype=torch.float32,
                           device=self.device)

    def plan(self, packed: torch.Tensor):
        """Frame -> Path (``"plan"`` artifacts only)."""
        from tod_tpu_torch.planner.api import materialize_path

        if self.meta["mode"] != "plan":
            raise ValueError(f"plan() needs a 'plan' artifact, this is {self.meta['mode']!r}")
        return materialize_path(self.call(packed))

    def unpack_scene(self, out) -> tuple[np.ndarray, np.ndarray]:
        """A ``"scene"`` or ``"packed"`` output -> (height f32, balls f32)
        numpy arrays."""
        from tod_tpu_torch.ops.packing import unpack_height_balls

        if self.meta["mode"] == "scene":
            height, balls = out
            return height.cpu().numpy(), balls.cpu().numpy()
        height, balls = unpack_height_balls(out.cpu(), self.meta["camera"]["height"],
                                            self.meta["camera"]["width"])
        return height.astype(np.float32), balls


def serve_artifact(artifact: ServingArtifact, source, n_frames: Optional[int] = None,
                   path_store=None, plan_every: int = 4, sync_every: int = 16) -> dict:
    """The artifact-only streaming loop: frames in, Paths out, no model
    built.  Every frame runs the frozen step; every ``plan_every``-th one is
    a planning frame, whose output is decoded when the next planning frame
    is dispatched.  A ``"track_plan"`` artifact advances the bank on
    planning frames only: the others run on a copy, whose update is dropped
    (the JAX loop's contract)."""
    from tod_tpu_torch.planner.api import materialize_path, plan_from_height
    from tod_tpu_torch.runtime.engine import _UploadWorker

    mode = artifact.meta["mode"]
    pcfg = planner_config_from_meta(artifact.meta)
    tracks = artifact.init_tracks() if mode == "track_plan" else None
    cuda = artifact.device.type == "cuda"
    uploader = _UploadWorker(source, n_frames, pin=cuda)
    n_done = n_planned = 0
    last_path = pending = out = None

    def flush(res):
        nonlocal last_path, n_planned
        if mode in ("plan", "track_plan"):
            last_path = materialize_path(res)
        else:
            last_path = plan_from_height(*artifact.unpack_scene(res), pcfg)
        n_planned += 1
        if path_store is not None:
            path_store.set(last_path)

    t0 = time.perf_counter()
    while True:
        item = uploader.next(timeout=0.25)
        if item is _UploadWorker.TIMEOUT:
            continue
        if item is None:
            break
        plan_now = plan_every and n_done % plan_every == 0
        if mode == "track_plan":
            out = artifact.call(item, tracks if plan_now else tracks.clone())[0]
        else:
            out = artifact.call(item)
        if plan_now:
            if pending is not None:
                flush(pending)
            pending = out
        n_done += 1
        if cuda and n_done % sync_every == 0:
            torch.cuda.synchronize(artifact.device)
    if cuda:
        torch.cuda.synchronize(artifact.device)
    if pending is not None:
        flush(pending)
    wall = time.perf_counter() - t0
    uploader.close()
    return {
        "n_frames": n_done,
        "wall_s": wall,
        "fps": n_done / wall if wall > 0 else 0.0,
        "plans_done": n_planned,
        "last_path_len": len(last_path.directions) if last_path else 0,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cmd_export(args, device) -> int:
    from tod_tpu_torch.core.config import (
        CameraConfig,
        ModelConfig,
        PipelineConfig,
        PlannerConfig,
        TrackerConfig,
    )
    from tod_tpu_torch.core.device import resolve_device
    from tod_tpu_torch.core.weights import load_checkpoint, load_pinned
    from tod_tpu_torch.runtime.engine import Engine

    if args.track and args.mode == "plan":
        args.mode = "track_plan"
    if args.aot and resolve_device(device).type != "cuda":
        raise SystemExit("--aot embeds the card's built kernel libraries: export on the card")
    cfg = PipelineConfig(
        camera=CameraConfig(width=args.width, height=args.height),
        model=ModelConfig(input_size=(args.height // 8 * 8, args.width // 8 * 8),
                          quantized=args.int8),
        planner=PlannerConfig(
            backend="tpu" if args.mode in ("plan", "track_plan") else "auto",
            signed_turns=args.signed_turns,
            start_offset=args.start_offset if args.start_offset is not None else 240,
        ),
        tracker=TrackerConfig(enabled=args.mode == "track_plan"),
    )
    if args.checkpoint is None:
        params = load_pinned(cfg=cfg.model)
    else:
        log.info("loading checkpoint %s", args.checkpoint)
        try:
            params = load_checkpoint(args.checkpoint, cfg.model)
        except (ValueError, KeyError, FileNotFoundError) as e:
            raise SystemExit(f"--checkpoint {args.checkpoint}: {e}") from e
    engine = Engine(cfg, params, device=device, mode=args.engine_mode)
    platforms = args.platforms.split(",") if args.platforms else None
    exported, meta = export_engine(engine, mode=args.mode, platforms=platforms,
                                   portable=args.portable)
    aot_blob = aot_meta = None
    if args.aot:
        aot_blob, aot_meta = build_aot(meta, engine.device)
    save_artifact(exported, meta, args.out, aot_blob=aot_blob, aot_meta=aot_meta)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out), **meta,
                      **({"aot": aot_meta} if aot_meta else {})}, indent=2))
    return 0


def _cmd_info(args, device) -> int:
    print(json.dumps(read_meta(args.artifact), indent=2))
    return 0


def _cmd_serve(args, device) -> int:
    from tod_tpu_torch.core.config import CameraConfig, ServerConfig
    from tod_tpu_torch.runtime.frame_source import PNGSource, SyntheticSource, TraceSource
    from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

    art = ServingArtifact.load(args.artifact, device=device)
    print(f"boot: {art.boot}" + (" (no nvcc)" if art.boot == "aot" else ""))
    cam = CameraConfig(width=art.meta["camera"]["width"], height=art.meta["camera"]["height"])
    if args.source == "png":
        if not args.image:
            raise SystemExit("--source png requires --image")
        source = PNGSource(args.image, cam, n_frames=args.frames)
    elif args.source == "trace":
        if not args.trace:
            raise SystemExit("--source trace requires --trace")
        source = TraceSource(args.trace, loop=True, n_frames=args.frames)
    else:
        source = SyntheticSource(cam, n_frames=args.frames)
    store = PathStore()
    server_thread = server = None
    if not args.no_server:
        server_thread, server = run_in_thread(store, ServerConfig(host=args.host, port=args.port))
        print(f"path server on {args.host}:{server.port}")
    try:
        metrics = serve_artifact(art, source, n_frames=args.frames, path_store=store,
                                 plan_every=args.plan_every)
    finally:
        if server is not None:
            stop_thread_server(server)
            server_thread.join(timeout=5)
    print(json.dumps(metrics))
    return 0


def build_arg_parser():
    import argparse

    p = argparse.ArgumentParser(prog="tod_tpu_torch.deploy", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="freeze a serving step to an artifact")
    pe.add_argument("--out", required=True)
    pe.add_argument("--checkpoint", help="checkpoint .npz (default: the pinned weights)")
    pe.add_argument("--mode", choices=MODES, default="plan")
    pe.add_argument("--track", action="store_true",
                    help="freeze the tracked frame+plan step (the bank threads through the "
                    "artifact's signature); shorthand for --mode track_plan")
    pe.add_argument("--engine-mode", choices=("detect", "semantic"), default="detect")
    pe.add_argument("--width", type=int, default=320)
    pe.add_argument("--height", type=int, default=240)
    pe.add_argument("--int8", action="store_true", help="freeze the static-int8 model")
    pe.add_argument("--signed-turns", action="store_true",
                    help="freeze signed turn angles into the plan (recorded in the header)")
    pe.add_argument("--start-offset", type=int, default=None, metavar="COLS",
                    help="planner start column offset from the right edge (default 240)")
    pe.add_argument("--platforms", default=None,
                    help="comma-separated platforms, recorded (every artifact runs on the "
                    "CPU and the card)")
    pe.add_argument("--portable", action="store_true",
                    help="recorded: every port artifact is portable")
    pe.add_argument("--aot", action="store_true",
                    help="embed the card's built kernel libraries: a card of the same "
                    "capability boots with no nvcc")
    pe.set_defaults(fn=_cmd_export)

    pi = sub.add_parser("info", help="print an artifact's JSON header")
    pi.add_argument("artifact")
    pi.set_defaults(fn=_cmd_info)

    ps = sub.add_parser("serve", help="stream frames through a frozen artifact")
    ps.add_argument("artifact")
    ps.add_argument("--source", choices=("synthetic", "png", "trace"), default="synthetic")
    ps.add_argument("--image")
    ps.add_argument("--trace")
    ps.add_argument("--frames", type=int, default=None)
    ps.add_argument("--plan-every", type=int, default=4)
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8080)
    ps.add_argument("--no-server", action="store_true")
    ps.set_defaults(fn=_cmd_serve)
    return p


def main(argv=None, device=None) -> int:
    """Run a subcommand on ``device`` (the card when None; the tests pass
    ``"cpu"``)."""
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    return args.fn(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
