#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tod_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases, each printed as it ends:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel in ``tod_tpu_torch/csrc`` with nvcc;
3. each kernel (mask assembly, connection weights, path walk) against its
   plain torch version on the card, at the main path's shapes and a ragged
   shape, and its device time (CUDA events, median of 50 calls after a
   warm-up, enqueued behind a sleep kernel) beside the plain version's and a
   library call's;
4. the main path: the pinned weights, the default 640x480 / 256x320 / bf16
   configuration, 8 synthetic frames through ``Engine.serve_step_plan``, with
   every kernel's launch count reset before and read after; then one frame
   under ``torch.profiler`` for the device time of each ``stage/`` range;
5. a reference check on a small input: each stage on the card against the
   same stage on the CPU, fed the same inputs;
6. the last plan published on the port's ``PathServer`` and read back with a
   raw ``GetPath``.

Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero.  Without CUDA, or without the package beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import faulthandler
import json
import pathlib
import socket
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
N_FRAMES = 8


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, n: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(device ms, wall ms) of one call.  Device: median over ``n`` calls of
    CUDA events around each call, all enqueued while a sleep kernel holds the
    stream, so that host enqueue time does not count.  Wall: host clock per
    call, synchronised, including the launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / n
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s: longer than enqueueing n calls
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events), wall


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(torch, np, rng, device):
    from tod_tpu_torch.kernels.mask_assembly import assemble_crop_masks, plain_assemble_crop_masks

    def inputs(b, hm, wm, k, n):
        protos = np.maximum(rng.normal(0, 1, (b, hm, wm, k)), 0).astype(np.float32)
        coeffs = np.tanh(rng.normal(0, 1, (b, n, k))).astype(np.float32)
        c = rng.uniform(-0.1, 1.1, (b, n, 2))
        s = rng.uniform(0.05, 0.6, (b, n, 2))
        boxes = np.concatenate([c - s / 2, c + s / 2], axis=-1).astype(np.float32)
        return [torch.from_numpy(a).to(device) for a in (protos, coeffs, boxes)]

    tol = 2e-6  # expf vs torch's sigmoid in the last bits; the crop is exact
    worst = 0.0
    main = None
    for shape in ((1, 64, 80, 32, 32), (2, 13, 17, 5, 7)):
        args = inputs(*shape)
        got = assemble_crop_masks(*args)
        want = plain_assemble_crop_masks(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_crop = torch.equal(got == 0, want == 0)
        log(f"  K1 mask_assembly B,Hm,Wm,K,N={shape}: max_abs_err={err:.3e} "
            f"(tol {tol:g}), crop identical={same_crop}")
        if not (err <= tol and same_crop):
            raise AssertionError(f"K1 disagrees with its plain version at {shape}")
        worst = max(worst, err)
        if main is None:
            main = args
    protos, coeffs, boxes = main
    b, hm, wm, k = protos.shape
    n = coeffs.shape[1]
    ys = (torch.arange(hm, dtype=torch.float32, device=device) + 0.5) / torch.full((), float(hm), device=device)
    xs = (torch.arange(wm, dtype=torch.float32, device=device) + 0.5) / torch.full((), float(wm), device=device)
    inside = (
        (ys[:, None] >= boxes[..., 0, None, None]) & (ys[:, None] <= boxes[..., 2, None, None])
        & (xs[None, :] >= boxes[..., 1, None, None]) & (xs[None, :] <= boxes[..., 3, None, None])
    ).reshape(b, n, hm * wm)
    protos2d = protos.reshape(b, hm * wm, k)
    ms, wall = time_ms(lambda: assemble_crop_masks(protos, coeffs, boxes), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_assemble_crop_masks(protos, coeffs, boxes), torch)
    library_ms, _ = time_ms(
        lambda: torch.where(inside, torch.sigmoid(coeffs @ protos2d.transpose(1, 2)), 0.0), torch
    )
    n_bytes = 4 * (protos.numel() + coeffs.numel() + boxes.numel() + b * n * hm * wm)
    bms, by = bound_ms(n_bytes, 2.0 * b * n * hm * wm * k)
    log(f"  K1 times at {tuple(protos.shape)}: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={bms:.6f} ({by}); wall per call: kernel "
        f"{wall:.4f} ms, plain {plain_wall:.4f} ms")
    return {
        "name": "mask_assembly", "route": "cuda",
        "source": "tod_tpu_torch/csrc/mask_assembly.cu",
        "replaces": "tod_tpu/kernels/mask_assembly.py:61",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
    }


def check_k2(torch, np, rng, device):
    from tod_tpu_torch.kernels.connections import connection_weights, plain_connection_weights

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    main = None
    for h, w in ((480, 640), (37, 53)):
        hm = rng.uniform(0, 300, (h, w)).astype(np.float32)
        hm[rng.random((h, w)) < 0.01] = np.nan
        height = torch.from_numpy(hm).to(device)
        pos_k, conn_k = connection_weights(height)
        pos_p, conn_p = plain_connection_weights(height)
        torch.cuda.synchronize()
        ok = same(pos_k, pos_p) and same(conn_k, conn_p)
        log(f"  K2 connections H,W=({h},{w}): bitwise equal={ok} (tol exact)")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {(h, w)}")
        if main is None:
            main = torch.from_numpy(np.nan_to_num(hm)).to(device)
    h, w = main.shape
    ms, wall = time_ms(lambda: connection_weights(main), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_connection_weights(main), torch)
    bms, by = bound_ms(4 * (h * w + h * w * 11), 8 * 6.0 * h * w)
    log(f"  K2 times at ({h},{w}): kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"bound_ms={bms:.6f} ({by}); wall per call: kernel {wall:.4f} ms, plain "
        f"{plain_wall:.4f} ms")
    return {
        "name": "connections", "route": "cuda",
        "source": "tod_tpu_torch/csrc/connections.cu",
        "replaces": "tod_tpu/kernels/connections.py:37",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def check_walk(torch, np, rng, device):
    from tod_tpu_torch.kernels.connections import connection_weights
    from tod_tpu_torch.kernels.path_walk import plain_walk_path, walk_path
    from tod_tpu_torch.planner.relax import bellman_ford_grid, start_node_yx

    def relaxed(h, w, seeds):
        hm = np.cumsum(rng.normal(0, 0.3, (h, w)), axis=0).astype(np.float32)
        height = torch.from_numpy(hm - hm.min()).to(device)
        seed = torch.zeros((h, w), dtype=torch.bool, device=device)
        for y, x in seeds:
            seed[y, x] = True
        _, conns = connection_weights(height)
        dist, nxt, _ = bellman_ford_grid(height, conns, seed)
        return dist, nxt

    tol = 1e-6  # turns: acosf/atan2f against libm in the last bit; the rest exact
    worst, main = 0.0, None
    steps = 1024
    for (h, w), seeds in (((480, 640), [(20, 100), (200, 600)]), ((37, 53), [(3, 40)]),
                          ((37, 53), [])):
        dist, nxt = relaxed(h, w, seeds)
        start = start_node_yx((h, w), 240)
        for signed in (False, True):
            got = walk_path(dist, nxt, start, steps, signed)
            want = plain_walk_path(dist, nxt, start, steps, signed)
            got = got.cpu()
            err = (got - want).abs().max().item()
            exact = torch.equal(got[0], want[0]) and torch.equal(got[:, 0], want[:, 0])
            log(f"  path_walk H,W=({h},{w}) seeds={len(seeds)} signed={signed}: "
                f"n_valid={int(want[0, 0])}, header and magnitudes equal={exact}, "
                f"max_abs_err={err:.3e} (tol {tol:g})")
            if not (exact and err <= tol):
                raise AssertionError(f"path_walk disagrees with its plain version at {(h, w)}")
            worst = max(worst, err)
        if main is None:
            main = dist, nxt, start, int(want[0, 0])
    dist, nxt, start, hops = main
    ms, wall = time_ms(lambda: walk_path(dist, nxt, start, steps), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_walk_path(dist, nxt, start, steps), torch)
    # what this walk needs: each hop's node read once from both maps, the plan written
    bms, by = bound_ms((hops + 1) * (4 + 8) + (steps + 1) * 2 * 4, 20.0 * hops)
    log(f"  path_walk times at ({dist.shape[0]},{dist.shape[1]}), {hops} hops: "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} (readback + host walk) "
        f"bound_ms={bms:.6f} ({by}); wall per call: kernel {wall:.4f} ms, plain "
        f"{plain_wall:.4f} ms")
    return {
        "name": "path_walk", "route": "cuda",
        "source": "tod_tpu_torch/csrc/path_walk.cu",
        "replaces": "tod_tpu/planner/tpu_relax.py:200",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def main_path(torch, np, counters):
    from tod_tpu_torch.core.config import PipelineConfig
    from tod_tpu_torch.core.types import Path
    from tod_tpu_torch.core.weights import load_pinned
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    cfg = PipelineConfig()
    t = time.time()
    eng = Engine(cfg, load_pinned(), device="cuda")
    log(f"  engine: camera {cfg.camera.width}x{cfg.camera.height}, model "
        f"{cfg.model.name} input {cfg.model.input_size} {cfg.model.dtype}, "
        f"load {time.time() - t:.2f}s")
    frames = [
        torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
        for f in SyntheticSource(cfg.camera, seed=0, n_frames=N_FRAMES + 1).frames()
    ]
    t = time.time()
    eng.serve_step_plan(frames[0])  # warm-up: cuDNN plans, kernel loads
    log(f"  warm-up frame {1e3 * (time.time() - t):.1f} ms")

    for fn in counters.values():
        fn.launches = 0
    per_frame, sweeps, n_valid = [], [], []
    plan = None
    for packed in frames[1:]:
        t = time.perf_counter()
        plan = eng.serve_step_plan(packed)
        buf = plan.cpu().numpy()
        per_frame.append(1e3 * (time.perf_counter() - t))
        sweeps.append(eng.last_sweeps)
        n_valid.append(int(buf[0, 0]))
        steps = cfg.planner.max_path_steps
        n = int(buf[0, 0])
        if buf.shape != (steps + 1, 2) or not np.isfinite(buf).all() or not 0 <= n <= steps:
            raise AssertionError(f"malformed plan buffer: shape {buf.shape}, n {n}")
        if np.any(buf[1 + n :] != 0):
            raise AssertionError("plan rows past n_valid are not zero")
    launches = {name: fn.launches for name, fn in counters.items()}
    stage_profile(torch, eng, frames[1], counters)
    log(f"  ms per frame: {[round(x, 2) for x in per_frame]} "
        f"(median {statistics.median(per_frame):.2f})")
    log(f"  relaxation sweeps: {sweeps}")
    log(f"  plan n_valid: {n_valid}")
    log(f"  launches over {N_FRAMES} frames: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if max(n_valid) == 0:
        raise AssertionError("no frame produced a path to a ball")
    return Path.from_plan(plan), launches, statistics.median(per_frame)


def stage_profile(torch, eng, packed, kernel_names) -> None:
    """One profiled ``serve_step_plan`` call: the device time of each
    ``stage/`` range the engine opens, of each hand-written kernel (the
    profiler files a kernel launched through ctypes under no range), and the
    device's busy share of the frame (the profiler's own overhead lengthens
    the frame)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.serve_step_plan(packed).cpu()
        wall_ms = 1e3 * (time.perf_counter() - t)
    events = prof.events()
    stages = {e.name[len("stage/"):]: e for e in events
              if e.name.startswith("stage/") and e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("stage/"))
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:  # the union of the device's busy intervals
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    if not spans:
        log(f"  stage profile: the profiler recorded no device activity; device times "
            f"not measured (frame {wall_ms:.2f} ms under the profiler)")
        return
    rows = {name: (round(e.device_time_total / 1e3, 3), round(e.cpu_time_total / 1e3, 3))
            for name, e in stages.items()}
    ours = {name: round(sum(e.time_range.elapsed_us() for e in events
                            if e.device_type == DeviceType.CUDA and f"{name}_kernel" in e.name) / 1e3, 4)
            for name in kernel_names}
    log(f"  stage profile of one frame, (device ms, host ms) per range: {rows}")
    log(f"  hand-written kernels' device ms in that frame: {ours}")
    log(f"  device busy {busy_us / 1e3:.3f} ms of a {wall_ms:.3f} ms frame under the profiler "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f}, {len(spans)} device activities)")


def reference_check(torch, np):
    """Stage by stage on a small input: the card's result against the CPU's
    on the same inputs (float32, TF32 off)."""
    from tod_tpu_torch.core.config import CameraConfig, ModelConfig, PipelineConfig, PlannerConfig
    from tod_tpu_torch.core.weights import load_pinned
    from tod_tpu_torch.geometry.fusion import ball_centroids, occupancy_map
    from tod_tpu_torch.models.yolact import detect
    from tod_tpu_torch.ops.preprocess import preprocess_frame
    from tod_tpu_torch.planner.relax import plan_on_device
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PipelineConfig(
        camera=CameraConfig(width=160, height=120),
        model=ModelConfig(dtype="float32"),
        planner=PlannerConfig(start_offset=80),
    )
    cam, geom, pcfg = cfg.camera, cfg.geometry, cfg.planner
    state = load_pinned()
    engines = {d: Engine(cfg, state, device=d) for d in ("cpu", "cuda")}
    for t in (0, 7):
        f = synth_frame_numpy(0, t, cam.height, cam.width)
        x = preprocess_frame(torch.from_numpy(f.rgb), cfg.model.input_size, torch.float32)
        with torch.inference_mode():
            out = {d: e.model(x.to(e.device)) for d, e in engines.items()}
            err = max(
                (getattr(out["cuda"], k).float().cpu() - getattr(out["cpu"], k).float()).abs().max().item()
                for k in ("loc", "conf", "coeff", "prototypes")
            )
            # detection cleanup on the CPU's head outputs, on both devices
            dets = {
                d: detect(type(out["cpu"])(*(getattr(out["cpu"], k).to(e.device) for k in
                          ("loc", "conf", "coeff", "prototypes", "sem_logits"))),
                          cfg.model, e.anchors, out_hw=(cam.height, cam.width))
                for d, e in engines.items()
            }
            v = dets["cpu"].valid
            same_valid = torch.equal(dets["cuda"].valid.cpu(), v)
            box_err = (dets["cuda"].boxes.cpu()[v] - dets["cpu"].boxes[v]).abs().max().item() if v.any() else 0.0
            cls_diff = (dets["cuda"].class_map.cpu() != dets["cpu"].class_map).float().mean().item()
            # fusion on the CPU's class/id maps, on both devices
            depth = torch.from_numpy(f.depth.astype(np.int32))
            cm, im = dets["cpu"].class_map, dets["cpu"].id_map
            dev = {d: e.device for d, e in engines.items()}
            hts = {d: occupancy_map(depth.to(v), cm.to(v), cam, geom) for d, v in dev.items()}
            balls = {d: ball_centroids(depth.to(v), cm.to(v), im.to(v), cam, geom)
                     for d, v in dev.items()}
            h_diff = (hts["cuda"].cpu() != hts["cpu"]).float().mean().item()
            b_err = (balls["cuda"].cpu() - balls["cpu"]).abs().max().item()
            # the planner on the CPU's height and balls, on both devices
            plans = {
                d: plan_on_device(hts["cpu"].to(v), balls["cpu"].to(v), engines[d].start_yx,
                                  pcfg.max_seed_balls, pcfg.min_ball_pixels,
                                  pcfg.max_path_steps, pcfg.tpu_max_iters)
                for d, v in dev.items()
            }
            got, want = plans["cuda"][0].cpu(), plans["cpu"][0]
            # header and magnitudes exact; turns to 1e-6 (acosf vs libm)
            plan_eq = (torch.equal(got[:, 0], want[:, 0]) and torch.equal(got[0], want[0])
                       and (got - want).abs().max().item() <= 1e-6)
        log(f"  frame t={t}: forward max_abs_err={err:.2e} (tol 2e-3); detect valid equal={same_valid}, "
            f"box err={box_err:.2e} (tol 1e-5), class-map cells differing={cls_diff:.2e} (tol 1e-3); "
            f"heights differing={h_diff:.2e} (tol 5e-3), balls err={b_err:.2e} (tol 1e-3); "
            f"plan equal={plan_eq} (turns tol 1e-6; n={int(plans['cpu'][0][0, 0])}, sweeps {plans['cuda'][1]})")
        if not (err <= 2e-3 and same_valid and box_err <= 1e-5 and cls_diff <= 1e-3
                and h_diff <= 5e-3 and b_err <= 1e-3 and plan_eq):
            raise AssertionError(f"card and CPU disagree on frame t={t}")


def serve_and_query(path):
    from tod_tpu_torch.core.config import ServerConfig
    from tod_tpu_torch.core.types import Path
    from tod_tpu_torch.serve.server import PathStore, run_in_thread, stop_thread_server

    store = PathStore()
    store.set(path)
    thread, server = run_in_thread(store, ServerConfig(host="127.0.0.1", port=0))
    port = server.port
    try:
        expect = 8 + 8 * len(path.directions)
        with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
            sock.sendall(b"GetPath")
            data = b""
            while len(data) < expect:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
        got = Path.deserialize(data)
    finally:
        stop_thread_server(server)
        thread.join(timeout=10)
    if thread.is_alive():
        raise AssertionError("path server thread did not stop")
    want = [(float(m), float(r)) for m, r in path.directions]
    if [tuple(map(float, d)) for d in got.directions] != want:
        raise AssertionError("GetPath reply differs from the served plan")
    log(f"  GetPath on port {port}: {len(data)} bytes, {len(got.directions)} directions, "
        "equal to the served plan")


def main() -> int:
    faulthandler.dump_traceback_later(600, exit=True)
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "tod_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the tod_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np

    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels.connections import connection_weights
    from tod_tpu_torch.kernels.mask_assembly import assemble_crop_masks
    from tod_tpu_torch.kernels.path_walk import walk_path

    counters = {"mask_assembly": assemble_crop_masks, "connections": connection_weights,
                "path_walk": walk_path}

    log("== 1. device")
    smi = nvidia_smi_line()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== 2. build")
    t = time.time()
    logs = _build.build(counters)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(logs) or 'nothing (cached)'} in {time.time() - t:.1f}s")

    log("== 3. kernels against their plain versions")
    rng = np.random.default_rng(0)
    device = torch.device("cuda", 0)
    floor_ms, _ = time_ms(lambda: torch.cuda._sleep(0), torch)
    log(f"  timing floor (an empty kernel, same method): {floor_ms:.5f} ms")
    kernels = [check_k1(torch, np, rng, device), check_k2(torch, np, rng, device),
               check_walk(torch, np, rng, device)]
    log("  kernels: " + ", ".join(f"{k['name']} ok" for k in kernels))

    log("== 4. main path")
    path, launches, frame_ms = main_path(torch, np, counters)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    log("== 5. reference check on a small input")
    reference_check(torch, np)

    log("== 6. server")
    serve_and_query(path)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(f"main path median {frame_ms:.2f} ms/frame; total {time.time() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
