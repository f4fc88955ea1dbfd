"""The application entry point: camera -> model -> scene -> planner -> TCP
server, on one NVIDIA GPU (counterpart of the JAX package's ``app.py``).

Run as::

    python -m tod_tpu_torch.app --source synthetic --frames 300 --port 8080
    python -m tod_tpu_torch.app --source trace --trace capture.todtrace
    python -m tod_tpu_torch.app --source ring --mode semantic --auth-token T
    python -m tod_tpu_torch.app --source png --image scene.png --debug-dump
    python -m tod_tpu_torch.app --track --obstacle-memory 0.8 --plan-every 4
    python -m tod_tpu_torch.app --streams 4 --track
    python -m tod_tpu_torch.app --int8
    python -m tod_tpu_torch.app --todx model.todx
    python -m tod_tpu_torch.app --pipeline

The parser is the JAX package's: the same flags, choices and defaults (a
640x480 camera, the model at the full frame's 480x640, ``--plan-every 4``,
``--max-inflight 2``).  It serves the pinned weights (or ``--checkpoint``,
an npz converted on the JAX side) through ``Engine.run_supervised`` in
``--mode detect`` or ``semantic``, from the synthetic scene, a PNG, a trace
or the native ring, with the path server's ``GetStat`` reporting the
engine's fps, stage timers and restarts; ``--auth-token`` and ``--tls-*``
harden the server, and ``--debug-dump`` writes the reference's BMP dumps of
one synthetic frame into the working directory after the run.  ``--planner`` picks the mode as
the JAX package does: ``tpu``, and ``auto`` on the card, plan on the device
(the relaxation and walk kernels); ``numpy`` and ``native``, and ``auto`` on
the CPU, read the f16 height and the balls back and plan on the host, with
the C++ planner (built with g++ at first use) or its NumPy fallback; a host
``auto`` takes native when it builds.  The log names the planner taken.
``--track`` seeds the device planner from a bank of Kalman tracks updated by
the tracker kernel each planning frame (it takes the device planner and
``--plan-every``), ``--obstacle-memory D`` keeps a decayed memory of robot
bumps beside it, and ``--streams N`` serves N camera streams a tick through
``MultiStreamEngine``, each stream's path answered by ``GetPthN``/``NewPthN``;
the reference's conflict checks between these flags hold.  ``--int8`` serves
the int8 model: the weights calibrated on 4 synthetic frames and quantized
at load, each dense conv one launch of the int8 kernel (``csrc/qconv.cu``);
it goes with every other flag.  ``--todx`` serves a frozen artifact
(``tod_tpu_torch.deploy``) through the same supervised loop and server,
building no model; the artifact fixes the mode, camera and model, so the
flags that would change them exit.  ``--pipeline`` serves stage-split
(``parallel.TwoStagePipeline``): the forward on the first card, detect,
fusion and the device planner on the second, every frame planned, the
freshest plan on the server; with one card both stages share it (a warning
says so).
"""

from __future__ import annotations

import argparse
import json
import logging


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tod_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", choices=("synthetic", "png", "ring", "trace"), default="synthetic")
    p.add_argument("--image", help="PNG or BMP path for --source png")
    p.add_argument("--trace", help="TODTRACE path for --source ring/trace")
    p.add_argument("--frames", type=int, default=None, help="stop after N frames")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--fps", type=float, default=30.0, help="ring producer rate")
    p.add_argument("--mode", choices=("detect", "semantic"), default="detect")
    p.add_argument("--checkpoint", help="checkpoint dir with trained params")
    p.add_argument("--todx", metavar="ARTIFACT", help="serve from a frozen .todx artifact")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--no-server", action="store_true")
    p.add_argument("--auth-token", default=None,
                   help="require the AuthTok handshake before serving commands")
    p.add_argument("--tls-cert", default=None, help="serve the protocol over TLS")
    p.add_argument("--tls-key", default=None)
    p.add_argument("--tls-client-ca", default=None,
                   help="require + verify client certificates against this CA (mTLS)")
    p.add_argument("--planner", choices=("auto", "native", "numpy", "tpu"), default="auto")
    p.add_argument("--signed-turns", action="store_true",
                   help="emit signed turn angles (atan2 turn chain) instead of the "
                   "reference's unsigned acos rotations (PlannerConfig.signed_turns)")
    p.add_argument("--start-offset", type=int, default=240, metavar="COLS",
                   help="planner start-node column offset from the grid's right edge")
    p.add_argument("--int8", action="store_true", help="int8 end-to-end inference")
    p.add_argument("--track", action="store_true", help="temporal ball tracking")
    p.add_argument("--obstacle-memory", type=float, default=0.0, metavar="DECAY",
                   help="decaying robot-obstacle memory (requires --track); 0 disables")
    p.add_argument("--max-inflight", type=int, default=2, metavar="N",
                   help="bound the device queue to N frames (0 = unbounded)")
    p.add_argument("--plan-every", type=int, default=4, metavar="N",
                   help="plan inside the frame step every N frames "
                   "(0 = plan only at batch sync points)")
    p.add_argument("--streams", type=int, default=1, metavar="N",
                   help="serve N camera streams through one batched step")
    p.add_argument("--pipeline", action="store_true", help="pipeline-parallel serving")
    p.add_argument("--debug-dump", action="store_true", help="write map.bmp etc. per run")
    p.add_argument("--metrics-json", action="store_true", help="print metrics as JSON at exit")
    return p


def _check_conflicts(args) -> None:
    """The JAX app's checks of flags that do not go together."""
    if args.track and args.planner not in ("auto", "tpu"):
        raise SystemExit(
            f"--track requires the device planner (the track bank lives on the "
            f"device inside the frame+plan step) - drop --planner {args.planner} "
            f"or use --planner tpu")
    if args.todx:
        return  # the artifact fixes the rest: _main_todx checks its own flags
    if args.track and not args.plan_every and args.streams <= 1:
        raise SystemExit("--track plans in-stream: requires --plan-every >= 1")
    if args.track and args.pipeline:
        raise SystemExit("--track is fused-graph serving (the track bank rides the plan "
                         "dispatch; the stage-split pipeline has no plan stage to carry it)")
    if args.obstacle_memory and args.streams > 1:
        raise SystemExit("--obstacle-memory is single-stream: its state is a full (H, W) "
                         "map per stream and the batched step does not keep the per-stream "
                         "robot layer (runtime/multistream.py docstring)")


def main(argv=None, device=None) -> int:
    """Serve on ``device`` (default ``cuda``; the tests pass ``"cpu"``)."""
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    _check_conflicts(args)
    if args.todx:
        return _main_todx(args, device)

    from tod_tpu_torch.core.config import (
        CameraConfig,
        ModelConfig,
        PipelineConfig,
        PlannerConfig,
        ServerConfig,
        TrackerConfig,
    )
    from tod_tpu_torch.core.weights import load_checkpoint, load_pinned
    from tod_tpu_torch.planner.api import host_backend
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import (
        PNGSource,
        RingSource,
        SyntheticSource,
        TraceSource,
    )
    from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

    cam = CameraConfig(width=args.width, height=args.height, fps=args.fps)
    cfg = PipelineConfig(
        camera=cam,
        model=ModelConfig(input_size=(args.height // 8 * 8, args.width // 8 * 8),
                          quantized=args.int8),
        planner=PlannerConfig(backend="tpu" if args.track else args.planner,
                              signed_turns=args.signed_turns, start_offset=args.start_offset),
        tracker=TrackerConfig(enabled=args.track, obstacle_memory=args.obstacle_memory),
        server=ServerConfig(host=args.host, port=args.port, auth_token=args.auth_token,
                            tls_cert=args.tls_cert, tls_key=args.tls_key,
                            tls_client_ca=args.tls_client_ca),
    )

    if args.checkpoint is None:
        params = load_pinned(cfg=cfg.model)
    else:
        logging.info("loading checkpoint %s", args.checkpoint)
        try:
            params = load_checkpoint(args.checkpoint, cfg.model)
        except (ValueError, KeyError, FileNotFoundError) as e:
            raise SystemExit(f"--checkpoint {args.checkpoint}: {e}") from e

    def make_source():
        """A fresh source per (re)start: recovery re-opens the camera."""
        if args.source == "synthetic":
            return SyntheticSource(cam, n_frames=args.frames)
        if args.source == "png":
            if not args.image:
                raise SystemExit("--source png requires --image")
            return PNGSource(args.image, cam, n_frames=args.frames)
        if args.source == "trace":
            if not args.trace:
                raise SystemExit("--source trace requires --trace")
            return TraceSource(args.trace, loop=True, n_frames=args.frames)
        return RingSource(cam, fps=args.fps, trace_path=args.trace, n_frames=args.frames)

    if args.streams > 1:
        return _main_multistream(args, cfg, params, make_source, device)
    if args.pipeline:
        return _main_pipeline(args, cfg, params, make_source, device)

    sources = [make_source()]
    last_source = list(sources)

    def next_source():
        # the first start takes the source built above; restarts open fresh
        s = sources.pop() if sources else make_source()
        last_source[0] = s
        return s

    store = PathStore()
    server_thread = server = None
    try:
        engine = Engine(cfg, params, device=device, mode=args.mode)
        if engine._plan_on_device_mode:
            logging.info("planner %s: the device planner on %s", args.planner, engine.device)
        else:
            logging.info("planner %s: the %s host planner", args.planner,
                         host_backend(args.planner))
        if not args.no_server:
            stats_fn = lambda: {  # noqa: E731 (GetStat's live metrics)
                "fps": engine.fps.fps,
                "stages": engine.timer.summary(),
                "restarts": engine.restarts,
            }
            server_thread, server = run_in_thread(store, cfg.server, stats_fn=stats_fn)
            logging.info("path server on %s:%s", cfg.server.host, server.port)
        metrics = engine.run_supervised(
            next_source, n_frames=args.frames, path_store=store,
            max_restarts=3, stall_timeout_s=10.0,
            max_inflight=args.max_inflight or None,
            plan_every=args.plan_every or None,
        )
    finally:
        last_source[0].close()
        if server is not None:
            stop_thread_server(server)
            server_thread.join(timeout=5)

    if args.debug_dump:
        from tod_tpu_torch.utils.image_io import dump_scene_debug

        frame = next(SyntheticSource(cam, n_frames=1).frames())
        scene, _ = engine.process(frame)
        logging.info("debug dumps: %s", dump_scene_debug(scene, depth=frame.depth))

    if args.metrics_json:
        print(json.dumps(metrics, default=float))
    else:
        logging.info(
            "done: %d frames, %.1f fps, plan p50 %s ms",
            metrics["n_frames"], metrics["fps"],
            metrics["stages"].get("plan", {}).get("p50_ms"),
        )
    return 0


def _main_pipeline(args, cfg, params, make_source, device) -> int:
    """``--pipeline``: stage-split serving (``parallel.TwoStagePipeline``)
    over the first two cards (or the one device the caller names), every
    frame planned, the freshest plan on the path server."""
    from tod_tpu_torch.parallel.mesh import visible_devices
    from tod_tpu_torch.parallel.pipeline import TwoStagePipeline
    from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

    devices = visible_devices()[:2] if device is None else [device]
    if len(devices) < 2:
        logging.warning("--pipeline with %d device(s): both stages share one device - "
                        "correct, but the overlap win needs two", len(devices))
    pipe = TwoStagePipeline(cfg, devices=devices, params=params)
    store = PathStore()
    server_thread = server = None
    if not args.no_server:
        server_thread, server = run_in_thread(store, cfg.server)
        logging.info("pipeline-parallel: stage 1 on %s, stage 2 on %s", pipe.d_fwd, pipe.d_post)
        logging.info("path server on %s:%s", cfg.server.host, server.port)
    source = make_source()
    try:
        metrics = pipe.run(source, n_frames=args.frames, path_store=store)
    finally:
        source.close()
        if server is not None:
            stop_thread_server(server)
            server_thread.join(timeout=5)
    if args.metrics_json:
        print(json.dumps(metrics, default=float))
    else:
        logging.info("done: %d frames, %.1f fps (stage1 %s, stage2 %s)", metrics["n_frames"],
                     metrics["fps"], metrics["stage1_device"], metrics["stage2_device"])
    return 0


def _main_multistream(args, cfg, params, make_source, device) -> int:
    """``--streams N``: ``MultiStreamEngine`` serving N camera feeds a tick,
    each stream's path on the wire by ``GetPthN``/``NewPthN``."""
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.runtime.multistream import MultiStreamEngine
    from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

    n = args.streams
    if args.source == "synthetic":
        # seed-varied feeds: a rig's cameras see different scenes
        factories = [(lambda i=i: SyntheticSource(cfg.camera, seed=i, n_frames=args.frames))
                     for i in range(n)]
    else:
        factories = [make_source for _ in range(n)]
    engine = MultiStreamEngine(cfg, n_streams=n, params=params, device=device)
    logging.info("%d streams on %s%s", n, engine.device, ", tracked" if engine.tracked else "")
    stores = [PathStore() for _ in range(n)]
    server_thread = server = None
    if not args.no_server:
        stats_fn = lambda: {  # noqa: E731 (GetStat's live metrics)
            "ticks_per_s": engine.fps.fps,
            "stages": engine.timer.summary(),
            "restarts": engine.restarts,
        }
        server_thread, server = run_in_thread(stores[0], cfg.server, stats_fn=stats_fn,
                                              stream_stores=stores)
        logging.info("path server on %s:%s", cfg.server.host, server.port)
    try:
        # each stream's source supervised: a wedged or dead camera reopens
        # while the others serve
        metrics = engine.run_supervised(
            factories, n_ticks=args.frames, path_stores=stores,
            max_inflight=args.max_inflight or None, stall_timeout_s=10.0, max_restarts=3,
        )
    finally:
        if server is not None:
            stop_thread_server(server)
            server_thread.join(timeout=5)
    if args.metrics_json:
        print(json.dumps(metrics, default=float))
    else:
        logging.info("done: %d ticks x %d streams, %.1f frames/s aggregate",
                     metrics["n_ticks"], n, metrics["frames_per_s"])
    return 0


def _main_todx(args, device) -> int:
    """``--todx``: the supervised serving loop, the server and the sources,
    driven by a frozen artifact through ``ArtifactEngine`` (no model is
    built).  With the artifact's kernel libraries for this card the boot
    runs no nvcc (``boot aot``)."""
    for flag, name in (
        (args.track, "--track"),
        (args.streams > 1, "--streams"),
        (args.pipeline, "--pipeline"),
        (args.checkpoint, "--checkpoint"),
        (args.int8, "--int8"),
        (args.debug_dump, "--debug-dump"),
    ):
        if flag:
            raise SystemExit(
                f"{name} is incompatible with --todx (the artifact freezes one serving "
                "graph at export; tracking is an EXPORT-time choice: `deploy export "
                "--track` freezes the tracked graph and the app serves whatever mode the "
                "artifact declares)")
    if not args.plan_every:
        raise SystemExit("--todx plans in-stream or on host: requires --plan-every >= 1")

    from tod_tpu_torch.core.config import ServerConfig
    from tod_tpu_torch.deploy import ServingArtifact
    from tod_tpu_torch.runtime.artifact_engine import ArtifactEngine
    from tod_tpu_torch.runtime.frame_source import (
        PNGSource,
        RingSource,
        SyntheticSource,
        TraceSource,
    )
    from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

    art = ServingArtifact.load(args.todx, device=device)
    logging.info("artifact %s: mode=%s boot=%s%s on %s", args.todx, art.meta["mode"], art.boot,
                 " (no nvcc)" if art.boot == "aot" else "", art.device)
    server_cfg = ServerConfig(host=args.host, port=args.port, auth_token=args.auth_token,
                              tls_cert=args.tls_cert, tls_key=args.tls_key,
                              tls_client_ca=args.tls_client_ca)
    engine = ArtifactEngine(art, server=server_cfg)
    cam = engine.cfg.camera  # the artifact's frozen camera contract
    if (args.width, args.height) != (640, 480) and (args.width, args.height) != (cam.width,
                                                                                cam.height):
        logging.warning("--width/--height ignored: the artifact serves %dx%d", cam.width,
                        cam.height)

    def make_source():
        if args.source == "synthetic":
            return SyntheticSource(cam, n_frames=args.frames)
        if args.source == "png":
            if not args.image:
                raise SystemExit("--source png requires --image")
            return PNGSource(args.image, cam, n_frames=args.frames)
        if args.source == "trace":
            if not args.trace:
                raise SystemExit("--source trace requires --trace")
            return TraceSource(args.trace, loop=True, n_frames=args.frames)
        return RingSource(cam, fps=args.fps, trace_path=args.trace, n_frames=args.frames)

    store = PathStore()
    server_thread = server = None
    if not args.no_server:
        stats_fn = lambda: {  # noqa: E731 (GetStat's live metrics)
            "fps": engine.fps.fps,
            "stages": engine.timer.summary(),
            "restarts": engine.restarts,
            "boot": engine.boot,
        }
        server_thread, server = run_in_thread(store, server_cfg, stats_fn=stats_fn)
        logging.info("path server on %s:%s", server_cfg.host, server.port)
    try:
        metrics = engine.run_supervised(
            make_source, n_frames=args.frames, path_store=store,
            max_restarts=3, stall_timeout_s=10.0,
            max_inflight=args.max_inflight or None,
            plan_every=args.plan_every,
        )
    finally:
        if server is not None:
            stop_thread_server(server)
            server_thread.join(timeout=5)
    metrics["boot"] = engine.boot
    if args.metrics_json:
        print(json.dumps(metrics, default=float))
    else:
        logging.info("done: %d frames, %.1f fps (artifact boot %s)", metrics["n_frames"],
                     metrics["fps"], engine.boot)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
