"""The port's streaming runtime and app on the CPU: ``Engine.run`` against
the JAX package's ``Engine.run`` in device-planner mode, ``run_supervised``
recovering from a stalled source, TODTRACE files across both packages, the
stage timer, the watchdog, the paced source, ``GetStat`` with live metrics,
and ``python -m tod_tpu_torch.app`` (``main``) with its planners, sources,
modes and server flags, tracking (``--track``, ``--obstacle-memory``) and
``--streams``, the conflicts between them, and its refused flags."""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import pytest
import torch

from tod_tpu.core import config as jcfg
from tod_tpu.runtime.frame_source import SyntheticSource as JaxSyntheticSource
from tod_tpu.runtime.frame_source import TraceSource as JaxTraceSource
from tod_tpu.runtime.frame_source import write_trace as jax_write_trace
from tod_tpu.serve.server import PathStore as JaxPathStore
from tod_tpu_torch.app import main
from tod_tpu_torch.core import config as tcfg
from tod_tpu_torch.core.types import Frame
from tod_tpu_torch.runtime.frame_source import (
    PacedSource,
    SyntheticSource,
    TraceSource,
    synth_frame_numpy,
    write_trace,
)
from tod_tpu_torch.serve.server import PathStore

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)

# The app's camera at test size; the model at its trained 256x320 input
# (frames upsampled) so that the synthetic balls are detected and the path
# is not empty.
CAM = dict(width=64, height=48)
MODEL = dict(input_size=(256, 320), dtype="float32")


@pytest.fixture(scope="module")
def flat_weights():
    from tod_tpu_torch.core.weights import read_tree

    return read_tree()


@pytest.fixture(scope="module")
def port_engine(flat_weights):
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    # the device planner, which "auto" selects only on the card
    cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM), model=tcfg.ModelConfig(**MODEL),
                              planner=tcfg.PlannerConfig(backend="tpu"))
    return Engine(cfg, carry_across(flat_weights), device="cpu")


class StallingSource:
    """Yields ``n_good`` synthetic frames, then hangs (an unplugged camera)
    until closed."""

    def __init__(self, n_good: int):
        self.n_good = n_good
        self.closed = False

    def frames(self):
        for t in range(self.n_good):
            yield synth_frame_numpy(0, t, CAM["height"], CAM["width"])
        while not self.closed:
            time.sleep(0.05)

    def close(self):
        self.closed = True


def test_run_matches_jax_run(port_engine, flat_weights):
    """Four frames, a plan every second frame, two in flight: the metrics
    have the JAX package's keys, and the published path is the JAX
    package's device-planner path over the same frames (the device
    planner's tolerances of ``tests/test_torch_pipeline.py``)."""
    from tests.test_torch_pipeline import nest
    from tod_tpu.runtime.engine import Engine as JaxEngine

    jax_engine = JaxEngine(
        jcfg.PipelineConfig(camera=jcfg.CameraConfig(**CAM), model=jcfg.ModelConfig(**MODEL),
                            planner=jcfg.PlannerConfig(backend="tpu")),
        nest(flat_weights), use_pallas=False,
    )
    run_kw = dict(n_frames=4, plan_every=2, max_inflight=2, sync_every=16)
    jstore, store = JaxPathStore(), PathStore()
    want = jax_engine.run(JaxSyntheticSource(jcfg.CameraConfig(**CAM), n_frames=4),
                          path_store=jstore, warmup=False, **run_kw)
    got = port_engine.run(SyntheticSource(tcfg.CameraConfig(**CAM), n_frames=4),
                          path_store=store, **run_kw)
    assert set(got) == set(want)
    assert got["n_frames"] == want["n_frames"] == 4
    assert got["plans_done"] >= 1 and got["fps"] > 0
    assert {"frame", "plan", "latency", "dispatch_plan"} <= set(got["stages"])
    jdirs = np.asarray(jstore.get().directions, np.float32)
    dirs = np.asarray(store.get().directions, np.float32)
    assert len(jdirs) > 5 and dirs.shape == jdirs.shape
    assert got["last_path_len"] == want["last_path_len"] == len(jdirs)
    assert dirs[:, 0].sum() == pytest.approx(jdirs[:, 0].sum(), rel=1e-4)
    np.testing.assert_allclose(dirs[:, 0], jdirs[:, 0], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dirs[:, 1], jdirs[:, 1], atol=1e-4, rtol=0)


def test_plans_at_sync_points_without_plan_every(port_engine):
    """``plan_every=None``: the last scene of each ``sync_every`` batch is
    planned at the sync point, and no frame plans inside its step."""
    store = PathStore()
    port_engine.timer.reset()
    m = port_engine.run(SyntheticSource(tcfg.CameraConfig(**CAM), n_frames=3),
                        path_store=store, warmup=False, sync_every=2)
    assert m["n_frames"] == 3 and m["plans_done"] >= 1
    assert "dispatch_plan" not in m["stages"] and m["stages"]["dispatch_scene"]["n"] == 3
    assert len(store.get().directions) == m["last_path_len"] > 0


def test_run_supervised_recovers_from_a_stalled_source(flat_weights):
    from tod_tpu_torch.core.weights import carry_across
    from tod_tpu_torch.runtime.engine import Engine

    cfg = tcfg.PipelineConfig(camera=tcfg.CameraConfig(**CAM),
                              model=tcfg.ModelConfig(input_size=(48, 64), dtype="float32"))
    eng = Engine(cfg, carry_across(flat_weights), device="cpu")
    made = []

    def factory():
        src = StallingSource(3) if not made else SyntheticSource(cfg.camera, seed=1, n_frames=50)
        made.append(src)
        return src

    m = eng.run_supervised(factory, n_frames=8, max_restarts=2, stall_timeout_s=2.0,
                           sync_every=4, plan_every=2, warmup=False)
    assert made[0].closed, "run_supervised leaked the stalled source"
    assert m["restarts"] == eng.restarts == 1
    assert m["n_frames"] == 8 and m["plans_done"] >= 2


def test_trace_files_replay_across_packages(tmp_path):
    frames = [synth_frame_numpy(0, t, 12, 16) for t in range(3)]
    ours, theirs = tmp_path / "port.todtrace", tmp_path / "jax.todtrace"
    write_trace(ours, frames)
    jax_write_trace(theirs, frames)
    assert ours.read_bytes() == theirs.read_bytes()
    for read in (list(TraceSource(theirs, loop=True, n_frames=5).frames()),
                 list(JaxTraceSource(ours, loop=True, n_frames=5).frames())):
        assert len(read) == 5
        for k, fr in enumerate(read):
            np.testing.assert_array_equal(fr.rgb, frames[k % 3].rgb)
            np.testing.assert_array_equal(fr.depth, frames[k % 3].depth)
    assert len(list(TraceSource(ours).frames())) == 3
    bad = tmp_path / "bad.todtrace"
    bad.write_bytes(b"x" * 32)
    with pytest.raises(ValueError, match="TODTRACE"):
        TraceSource(bad)


def test_stage_timer_and_fps_meter_match_jax():
    from tod_tpu.runtime.profiler import FPSMeter as JaxFPS
    from tod_tpu.runtime.profiler import StageTimer as JaxTimer
    from tod_tpu_torch.runtime.profiler import FPSMeter, StageTimer

    ours, theirs = StageTimer(), JaxTimer()
    for x in np.random.default_rng(0).uniform(0.001, 0.1, 50):
        ours.record("frame", float(x))
        theirs.record("frame", float(x))
    assert ours.summary() == theirs.summary()
    with ours.stage("block"):
        pass
    assert ours.stats("block")["n"] == 1 and ours.stats("none") == {"n": 0}
    meter, jmeter = FPSMeter(), JaxFPS()
    assert meter.fps == jmeter.fps == 0.0
    for _ in range(3):
        meter.tick()
        time.sleep(0.01)
    assert 0 < meter.fps <= 101  # two periods of at least 10 ms


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from tod_tpu_torch.runtime.profiler import device_trace

    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_watchdog_fires_on_stall_and_resets():
    from tod_tpu_torch.runtime.watchdog import Watchdog

    fired = []
    wd = Watchdog(timeout_s=0.2, on_stall=fired.append, check_interval_s=0.05).start()
    try:
        time.sleep(0.5)
        assert len(fired) == 1 and wd.stall_count == 1  # fires once per stall
        wd.heartbeat()
        time.sleep(0.1)
        assert len(fired) == 1
    finally:
        wd.stop()


def test_paced_source_keeps_the_camera_period():
    src = PacedSource(SyntheticSource(tcfg.CameraConfig(width=16, height=12), n_frames=4), fps=40.0)
    t = time.monotonic()
    assert len(list(src.frames())) == 4
    assert time.monotonic() - t >= 3 / 40.0 - 1e-3
    with pytest.raises(ValueError):
        PacedSource(src, fps=0)


def test_getstat_carries_the_engine_metrics():
    from tod_tpu_torch.core.config import ServerConfig
    from tod_tpu_torch.serve.server import run_in_thread, stop_thread_server

    thread, server = run_in_thread(PathStore(), ServerConfig(port=0),
                                   stats_fn=lambda: {"fps": 12.5, "restarts": 1})
    try:
        with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
            s.sendall(b"GetStat")
            data = b""
            while len(data) < 4 or len(data) < 4 + int.from_bytes(data[:4], "big"):
                data += s.recv(65536)
    finally:
        stop_thread_server(server)
        thread.join(timeout=10)
    stats = json.loads(data[4:])
    assert stats["pipeline"] == {"fps": 12.5, "restarts": 1}
    assert stats["requests"]["GetStat"] == 1


def test_main_serves_on_the_cpu(capsys):
    rc = main(["--source", "synthetic", "--frames", "2", "--width", "64", "--height", "48",
               "--planner", "tpu", "--metrics-json", "--port", "0"], device="cpu")
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["n_frames"] == 2 and metrics["fps"] > 0 and metrics["restarts"] == 0


def test_main_replays_a_trace(tmp_path, capsys):
    trace = tmp_path / "cam.todtrace"
    write_trace(trace, [Frame(rgb=f.rgb, depth=f.depth)
                        for f in (synth_frame_numpy(0, t, 48, 64) for t in range(2))])
    rc = main(["--source", "trace", "--trace", str(trace), "--frames", "3", "--width", "64",
               "--height", "48", "--no-server", "--metrics-json"], device="cpu")
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_frames"] == 3


@pytest.mark.parametrize("planner", ["numpy", "native"])
def test_main_plans_on_the_host(planner, capsys, caplog):
    """``--planner numpy|native`` serve in the host-planner mode: every
    frame planned from its f16 height and balls, on the host."""
    caplog.set_level("INFO")
    rc = main(["--source", "synthetic", "--frames", "2", "--width", "64", "--height", "48",
               "--planner", planner, "--plan-every", "1", "--no-server", "--metrics-json"],
              device="cpu")
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["n_frames"] == 2 and metrics["plans_done"] >= 1
    assert f"planner {planner}: the {planner} host planner" in caplog.text


@pytest.mark.parametrize("flags", [["--track"], ["--track", "--obstacle-memory", "0.8"]])
def test_tracking_flags_serve(flags, capsys, caplog):
    """``--track`` (with and without the obstacle memory) takes the device
    planner and plans every ``--plan-every``-th frame from the track bank."""
    caplog.set_level("INFO")
    rc = main(flags + ["--frames", "4", "--plan-every", "2", "--width", "64", "--height", "48",
                       "--no-server", "--metrics-json"], device="cpu")
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["n_frames"] == 4 and metrics["plans_done"] >= 1
    assert "planner auto: the device planner on cpu" in caplog.text


def test_streams_serve_each_stream_over_the_wire():
    """``--streams 2 --track`` on two rings: ``GetPthN`` answers each
    stream, ``NewPthN`` resets one, ``GetStat`` lists both streams."""
    def ask(port):
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            lengths = []
            for i in (0, 1):
                s.sendall(b"GetPthN" + i.to_bytes(4, "big"))
                n = int.from_bytes(s.recv(4), "big")
                data = b""
                while len(data) < n:
                    data += s.recv(n - len(data))
                lengths.append(n)
            s.sendall(b"NewPthN" + (1).to_bytes(4, "big"))
            assert s.recv(2) == b"OK"
            return lengths, read_stat(s)

    lengths, stat = run_with_client(["--streams", "2", "--track"] + RING, ask)
    assert all(n >= 8 and (n - 8) % 8 == 0 for n in lengths)
    assert len(stat["streams"]) == 2 and stat["requests"]["GetPthN"] == 2
    assert stat["requests"]["NewPthN"] == 1 and "restarts" in stat["pipeline"]


def test_streams_without_a_server(capsys):
    rc = main(["--streams", "3", "--frames", "3", "--width", "64", "--height", "48",
               "--no-server", "--metrics-json"], device="cpu")
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["n_streams"] == 3 and metrics["n_ticks"] >= 1
    assert metrics["plans_done"] == 3 * metrics["n_ticks"] and metrics["restarts"] == 0


@pytest.mark.parametrize("flags,error,match", [
    (["--track", "--planner", "native"], SystemExit, "requires the device planner"),
    (["--track", "--plan-every", "0"], SystemExit, "requires --plan-every"),
    (["--track", "--pipeline"], SystemExit, "fused-graph serving"),
    (["--track", "--obstacle-memory", "0.8", "--streams", "2"], SystemExit, "single-stream"),
    (["--obstacle-memory", "0.8"], ValueError, "requires tracker.enabled"),
])
def test_conflicting_flags_are_refused_as_the_jax_app_refuses(flags, error, match):
    with pytest.raises(error, match=match):
        main(flags + ["--frames", "1", "--no-server"], device="cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_with_client(argv, ask):
    """Run ``main(argv)`` on a thread (a 20-frame ring at 20 fps: about a
    second of serving) and call ``ask(port)`` once its server accepts."""
    import threading

    port = free_port()
    result: dict = {}

    def app():
        try:
            result["rc"] = main(argv + ["--port", str(port)], device="cpu")
        except BaseException as e:  # handed to the test below
            result["error"] = e

    t = threading.Thread(target=app, daemon=True)
    t.start()
    deadline = time.time() + 60
    while time.time() < deadline and t.is_alive():
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            time.sleep(0.05)
    try:
        answer = ask(port)
    finally:
        t.join(timeout=120)
    assert not t.is_alive() and "error" not in result, result.get("error")
    assert result["rc"] == 0
    return answer


RING = ["--source", "ring", "--fps", "20", "--frames", "20", "--width", "64", "--height", "48"]


def read_stat(sock) -> dict:
    sock.sendall(b"GetStat")
    data = b""
    while len(data) < 4 or len(data) < 4 + int.from_bytes(data[:4], "big"):
        chunk = sock.recv(65536)
        if not chunk:
            break
        data += chunk
    return json.loads(data[4:])


def ask_with_token(token: bytes):
    def ask(port):
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"AuthTok" + len(token).to_bytes(4, "big") + token)
            assert s.recv(2) == b"OK"
            return read_stat(s)
    return ask


@pytest.mark.parametrize("flag", ["png", "ring", "semantic", "checkpoint", "auth", "tls",
                                  "debug-dump"])
def test_ported_flags_run(flag, tmp_path, monkeypatch, capsys, flat_weights):
    """Each flag the port once refused now serves: two frames, or a ring
    run with a client talking to the server while it serves."""
    small = ["--frames", "2", "--width", "64", "--height", "48", "--no-server",
             "--metrics-json"]
    if flag == "png":
        from tod_tpu_torch.utils.image_io import save_rgb

        save_rgb(tmp_path / "scene.png", synth_frame_numpy(0, 3, 224, 224).rgb)
        assert main(["--source", "png", "--image", str(tmp_path / "scene.png")] + small,
                    device="cpu") == 0
        with pytest.raises(SystemExit, match="--source png requires --image"):
            main(["--source", "png"] + small, device="cpu")
    elif flag == "ring":
        assert main(["--source", "ring", "--fps", "100"] + small, device="cpu") == 0
    elif flag == "semantic":
        assert main(["--mode", "semantic", "--planner", "tpu", "--plan-every", "1"] + small,
                    device="cpu") == 0
    elif flag == "checkpoint":
        np.savez(tmp_path / "ckpt.npz", **flat_weights)
        assert main(["--checkpoint", str(tmp_path / "ckpt.npz")] + small, device="cpu") == 0
        with pytest.raises(SystemExit, match="test_torch_weights.py --write CKPT_DIR OUT.npz"):
            main(["--checkpoint", str(tmp_path)] + small, device="cpu")
    elif flag == "auth":
        stat = run_with_client(RING + ["--auth-token", "T0k"], ask_with_token(b"T0k"))
        assert stat["requests"]["AuthTok"] == 1 and stat["requests"]["unauthorized"] == 0
        assert "pipeline" in stat
    elif flag == "tls":
        import ssl

        from tests.test_torch_serve_auth import make_cert

        cert, key = make_cert(tmp_path, "app")
        ctx = ssl.create_default_context(cafile=cert)

        def ask(port):
            with socket.create_connection(("127.0.0.1", port), timeout=10) as raw:
                with ctx.wrap_socket(raw, server_hostname="localhost") as s:
                    return read_stat(s)

        stat = run_with_client(RING + ["--tls-cert", cert, "--tls-key", key], ask)
        assert stat["requests"]["GetStat"] == 1
    else:
        monkeypatch.chdir(tmp_path)
        assert main(["--debug-dump"] + small, device="cpu") == 0
        for name in ("depth.bmp", "map.bmp", "connections0.bmp", "connections1.bmp"):
            assert (tmp_path / name).read_bytes()[:2] == b"BM"
        return
    if flag in ("png", "ring", "semantic", "checkpoint"):
        lines = capsys.readouterr().out.strip().splitlines()
        metrics = json.loads(next(x for x in lines if x.startswith("{")))
        assert metrics["n_frames"] == 2 and metrics["restarts"] == 0


def test_semantic_ring_app_with_every_new_flag(tmp_path, monkeypatch, flat_weights):
    """``--mode semantic --source ring --checkpoint --debug-dump
    --auth-token`` together, with a client that authenticates, asks for the
    path and the stats while the app serves."""
    np.savez(tmp_path / "ckpt.npz", **flat_weights)
    monkeypatch.chdir(tmp_path)

    def ask(port):
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"AuthTok" + (6).to_bytes(4, "big") + b"secret" + b"GetPath")
            data = b""
            while len(data) < 10:
                data += s.recv(65536)
            assert data[:2] == b"OK"
            return read_stat(s)

    stat = run_with_client(RING + ["--mode", "semantic", "--checkpoint",
                                   str(tmp_path / "ckpt.npz"), "--debug-dump",
                                   "--auth-token", "secret"], ask)
    assert stat["requests"]["AuthTok"] == 1 and stat["requests"]["GetPath"] == 1
    assert (tmp_path / "map.bmp").exists() and (tmp_path / "connections1.bmp").exists()


def test_parser_matches_the_jax_app():
    """Same flags, defaults and choices as ``python -m tod_tpu.app``."""
    from tod_tpu.app import build_arg_parser as jax_parser
    from tod_tpu_torch.app import build_arg_parser

    def shape(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type)
                for a in p._actions}

    assert shape(build_arg_parser()) == shape(jax_parser())
