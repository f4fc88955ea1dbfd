#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tod_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases, each printed as it ends:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of every kernel in ``tod_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and of the native host planner with g++;
3. each kernel (mask assembly, connection weights, the relaxation, the path
   walk, the terrain dilation K3/K4, the stochastic quantizer K5, the
   connected-components labels, the tracker) against its plain torch version
   on the card, at the main path's shapes and ragged ones (the cc kernel bit
   for bit at 97x131 and below, and at 480x640 and 479x641 against
   ``scipy.ndimage.label``, among them masks bridged across its tile
   borders by one pixel and a spiral; the tracker bit for bit on random
   banks at N = 1, 4, 16 and 33, on banks whose costs tie, at other ball
   counts and over a 64-step sequence of 4 banks with births, deaths,
   coasting and contended gates; the int8 convolution bit for bit
   at every distinct conv site of the 256x320 forward at batch 1 and 16, in
   bf16 and f32, with per-sample scales, at the shapes its tiling makes
   risky, twice in a row at its largest split, and past 2^24; and at the
   ResNet stem's 7x7 stride-2 site, (1 and 16, 3, 480, 640) -> 64 in bf16
   and f32, both quantize forms, its own row ``qconv_stem`` in the kernels
   line), and its device time (CUDA
   events, median of 50 calls after a warm-up, enqueued behind a sleep
   kernel) beside the plain version's and a library call's; then the
   configurations past a kernel's limit (ROADMAP.md D5: K1's prototypes,
   K3/K4's radius, the tracker's bank) refused by ``Engine`` and
   ``MultiStreamEngine`` on the card before anything loads;
4. the main path: the pinned weights, the default 640x480 / 256x320 / bf16
   configuration; one frame through ``Engine.serve_step_plan`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host synchronisation
   fails the phase), then 8 synthetic frames, with the path's launch counts
   reset before and read after (the terrain dilation's kernel once a
   frame); then one frame under ``torch.profiler`` for the device time of
   each ``stage/`` range;
5. a reference check on a small input: each stage on the card against the
   same stage on the CPU, fed the same inputs, and the occupancy map with
   and without ``pallas_bump`` (K3's strips, K4's whole map) against the
   CPU's, exactly, each with its one launch;
6. the last plan published on the port's ``PathServer`` and read back with a
   raw ``GetPath``;
7. the streaming loop at the app's configuration (640x480 camera, model at
   480x640, bf16) with ``pallas_bump``: ``Engine.run_supervised`` over 16
   frames, a plan every 4th, 2 in flight, with its own launch counts; the
   fusion stage of one profiled frame with K3's strips and with K4's whole
   map, each beside its kernel's device time; then K4 as a library call on
   the terrain peaks of 4 of those frames against the plain ring loop;
8. ``python3 -m tod_tpu_torch.app`` as a subprocess over 16 frames, with
   one ``GetStat`` while it runs;
9. weight-only PTQ: the pinned tree quantized with K5 (stochastic, seed 0),
   dequantized, carried across and served for 4 frames;
10. the host-planner mode: the default configuration with
   ``PlannerConfig(backend="native")`` streamed through ``run_supervised``
   for 8 frames, every frame planned by the native planner on the host;
11. each kernel's own device time: the median duration of its kernel over
   50 more calls of phase 3's timed call, from ``torch.profiler``, and of
   each kernel apart where a call launches several (last,
   since a profiler session leaves the host slower at launching and the
   phases before are timed on the host);
12. the bench (``tod_tpu_torch.bench``): ``fuse_scene_batch`` at batch 8
   on the card exactly equal to ``fuse_scene`` frame by frame (K4 and K2
   once a map) and at batch 2 to the CPU; then, with the serve path's
   launch counts reset before and read after, configs 2, 3, 4, 7, 14, 16,
   19, 10 and 13 and the headline (with one cold and one warm boot child) in this process at
   reduced counts, each line held: a positive value and fps, 0 < mfu <= 1,
   0 <= idle_share <= 1, the card's name, a cold boot slower than the warm;
13. semantic mode (``Engine(mode="semantic")``) at the app's configuration:
   one ``serve_step_plan`` frame under ``set_sync_debug_mode("error")``,
   then 8 frames with the path's launch counts (the cc kernel and K4 once a
   frame), the cc kernel on a served frame's ball mask against its plain
   version and scipy, and ``Engine._step`` on the card against the CPU's
   at the same configuration in f32 (TF32 off): the class maps within a
   share of differing pixels, the ids exact on the same class map;
14. ``python3 -m tod_tpu_torch.app --mode semantic --source ring
   --auth-token`` with a client that authenticates and sends ``GetPath``
   and ``GetStat``, then ``--source png --checkpoint --debug-dump`` in a
   temporary directory, whose BMPs must exist;
15. tracked serving at the app's configuration with the obstacle memory
   (0.8): one ``serve_step_track_plan`` and one ``serve_step_track_plan_mem``
   frame under the sync check, 8 tracked frames with the path's launch
   counts (every kernel of the path, the tracker's among them, once a
   frame), the bank on the card against the CPU's plain ``track_update``
   fed the card's own ball slots, and ``run_supervised`` with the tracker
   (a plan and a tracker launch every 4th frame);
16. ``MultiStreamEngine`` with 4 streams at 320x240: a tick and a tracked
   tick under the sync check, a tracked tick's launches (K1 and the tracker
   once, K4, K2, the relaxation and the walk once a stream), and in f32 each
   stream's class and id maps, scene and plan exactly against a
   single-stream ``Engine`` on the same frame, and 4 tracked ticks' plans
   and banks exactly against ``Engine.serve_step_track_plan`` stream by
   stream from the same starting banks; then the app
   as a subprocess with ``--track --obstacle-memory 0.8 --plan-every 4``
   (``GetPath``, ``GetStat``) and with ``--streams 2 --track`` (``GetPthN 0``
   and ``1``, ``NewPthN 1``, ``GetStat`` with its 2 streams);
17. int8 serving (``ModelConfig.quantized``, ``--int8``) at 320x240 and
   640x480: the engine calibrates and quantizes on the card, one frame
   under the sync check, 8 frames with ``qconv`` launched once per dense
   conv call (68 a frame) and K1, K4, K2, the relaxation and the walk once;
   the f32 int8 forward and class map on the card against the CPU's on the
   same prepared tree; then the app with ``--int8``, ``--int8 --track`` and
   ``--int8 --streams 4``;
18. frozen artifacts (``tod_tpu_torch.deploy``) at the app's configuration:
   ``plan``, ``track_plan``, semantic ``plan`` and ``--int8`` ``plan``
   exported on the card, each held against its eager engine over 8 frames
   bit for bit (the bank too) with the same launches a frame and one frame
   under the sync check; an ``--aot`` artifact booted by ``bench.boot
   --todx`` in a fresh process into an empty build directory (no nvcc
   run), and ``python3 -m tod_tpu_torch.app --todx`` with ``GetPath`` and
   ``GetStat``;
19. the ResNet backbones (M13) on seeded init weights: ResNet18 and
   ResNet50 forwards at batch 16, VGA, bf16; each card against CPU in f32
   at 64x64; one ResNet18 ``--int8`` frame with its launches (``qconv``
   once a static conv call, the 7x7 stem's among them);
20. training (M14) of the default model at bench config 11's size (240x320,
   batch 8, ``TrainConfig(warmup_steps=2, total_steps=40)``): 20 steps on one
   synthetic batch (finite losses, the last below the first; one step under
   the sync check), 8 steps with ``chunk=1`` against ``chunk=4`` and a
   ``save_state`` / ``load_state`` resume at step 4 against 8 uninterrupted
   steps (bit for bit, or the largest difference within twice the summed
   learning rates), one ``Trainer.evaluate`` with plans (K1, K2, K4, the
   relaxation, the walk and the cc kernel each launched), the trained
   ``.npz`` served by ``tod_tpu_torch.app --checkpoint`` to a plan, and the
   step's median time of 20 by CUDA events with its ``FlopCounterMode``
   GFLOPs and ``mfu``.

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
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (an FMA counts two)
INT8_OPS = 1979e12  # H100 SXM, dense int8 on the tensor cores (a multiply-add counts two)
# one add, compare or select per lane per clock: 132 SMs x 128 lanes x 1.98 GHz
ALU_OPS = 33.5e12
# K5's device work a call: the memset of its column maxima and its two kernels
K5_PARTS = ("Memset", "quantize")
N_FRAMES = 8
STREAM_FRAMES = 16


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


def own_ms(torch, calls, n: int = 50) -> tuple[float | None, list[float | None]]:
    """Own device times from ``torch.profiler`` (CUPTI): (an empty kernel's,
    and for each ``(call, kernel name)`` the median over ``n`` calls of the
    summed duration of the device activities one call makes whose name holds
    the kernel name, or one of them where it is a tuple).  One profiler session for all, since a session can miss
    launches near its start: each call is made once before any is counted,
    then each in turn ``n`` times behind an empty kernel (``spin_kernel``,
    which no call launches), and the device's activities are split at the
    empty kernels.  None where the profiler did not record the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls:
            fn()
        for _ in range(n):
            torch.cuda._sleep(0)
        for fn, _ in calls:
            torch.cuda._sleep(0)
            for _ in range(n):
                fn()
        torch.cuda._sleep(0)
        torch.cuda.synchronize()
    device = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                    for e in prof.events() if e.device_type == DeviceType.CUDA)
    empty = [d for _, d, name in device if "spin_kernel" in name]
    runs, run = [], None  # the activities between empty kernels
    for _, d, name in device:
        if "spin_kernel" in name:
            run = None
        elif run is None:
            run = [(d, name)]
            runs.append(run)
        else:
            run.append((d, name))
    floor = statistics.median(empty) / 1e3 if empty else None
    if len(runs) != len(calls) + 1:  # the warm-up calls, then one run a call
        return floor, [None] * len(calls)
    result = []
    for (_, kernel), run in zip(calls, runs[1:]):
        parts = (kernel,) if isinstance(kernel, str) else kernel
        spans = [d for d, name in run if any(part in name for part in parts)]
        per = len(spans) // n
        result.append(statistics.median(sum(spans[i * per : (i + 1) * per]) for i in range(n))
                      / 1e3 if spans and len(spans) % n == 0 else None)
    return floor, result


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


def own_times(torch, kernels, floor_ms: float) -> None:
    """Set each kernel row's ``own_ms`` from its ``own`` entry (the call and
    the kernel's name), beside an empty kernel's.  Where a call makes several
    device activities (a tuple of names), each one's own time is also taken
    and logged on its own."""
    calls = [k.pop("own") for k in kernels]
    split = [(i, fn, part) for i, (fn, parts) in enumerate(calls)
             if not isinstance(parts, str) for part in parts]
    floor, own = own_ms(torch, calls + [(fn, part) for _, fn, part in split])
    for k, ms in zip(kernels, own):
        k["own_ms"] = ms
    log(f"  own device ms (median of 50 calls, torch.profiler; an empty kernel {fmt(floor)}, "
        f"{floor_ms:.5f} by events): "
        + ", ".join(f"{k['name']} {fmt(k['own_ms'])} (events {k['ms']:.5f})" for k in kernels))
    for i in sorted({i for i, _, _ in split}):
        log(f"  {kernels[i]['name']} own ms by part (median of 50 calls each): "
            + ", ".join(f"{part} {fmt(ms)}" for (j, _, part), ms in
                        zip(split, own[len(calls):]) if j == i))


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations over
    ``ops_per_s`` (f32 FLOP/s, or ``ALU_OPS`` for work without FMAs)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_inputs(torch, np, gen, device, b, hm, wm, k, n):
    """K1's prototypes (B, Hm, Wm, K), coefficients (B, N, K) and boxes
    (B, N, 4), drawn from ``gen``: ReLU'd prototypes, tanh coefficients, and
    boxes that reach past the image's edges."""
    protos = np.maximum(gen.normal(0, 1, (b, hm, wm, k)), 0).astype(np.float32)
    coeffs = np.tanh(gen.normal(0, 1, (b, n, k))).astype(np.float32)
    c = gen.uniform(-0.1, 1.1, (b, n, 2))
    s = gen.uniform(0.05, 0.6, (b, n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], axis=-1).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (protos, coeffs, boxes)]


def check_k1(torch, np, rng, device):
    from tod_tpu_torch.core.device import sm_count
    from tod_tpu_torch.kernels.mask_assembly import (
        assemble_crop_masks,
        mask_tiling,
        plain_assemble_crop_masks,
    )

    tol = 2e-6  # expf vs torch's sigmoid in the last bits; the crop is exact
    worst = 0.0
    main = None
    # B, Hm, Wm, K, N: the main path; odd K; pixels not a multiple of the
    # tile; N = 1 and 33; B = 2; fewer pixels than a warp.  The first two
    # draw from ``rng`` and the others from their own generator, so that
    # the later checks' inputs do not depend on these shapes.
    extra = np.random.default_rng(1)
    for i, shape in enumerate(((1, 64, 80, 32, 32), (2, 13, 17, 5, 7), (1, 37, 53, 32, 32),
                               (1, 64, 80, 32, 1), (1, 64, 80, 32, 33), (2, 64, 80, 32, 32),
                               (1, 3, 5, 4, 3))):
        args = k1_inputs(torch, np, rng if i < 2 else extra, device, *shape)
        got = assemble_crop_masks(*args)
        want = plain_assemble_crop_masks(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_crop = torch.equal(got == 0, want == 0)
        t = mask_tiling(shape[0], shape[1] * shape[2], shape[4], shape[3], sm_count(device))
        log(f"  K1 mask_assembly B,Hm,Wm,K,N={shape}: max_abs_err={err:.3e} "
            f"(tol {tol:g}), crop identical={same_crop}; {t.blocks} blocks of {t.pixels} "
            f"pixels x {t.groups} detection groups, {t.smem_bytes} bytes of shared memory")
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
    kernel = lambda: assemble_crop_masks(protos, coeffs, boxes)  # noqa: E731
    ms, wall = time_ms(kernel, torch)
    plain_ms, plain_wall = time_ms(lambda: plain_assemble_crop_masks(protos, coeffs, boxes), torch)
    library_ms, _ = time_ms(
        lambda: torch.where(inside, torch.sigmoid(coeffs @ protos2d.transpose(1, 2)), 0.0), torch
    )
    n_bytes = 4 * (protos.numel() + coeffs.numel() + boxes.numel() + b * n * hm * wm)
    bms, by = bound_ms(n_bytes, 2.0 * b * n * hm * wm * k)
    log(f"  K1 times at {tuple(protos.shape)}: kernel_ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} bound_ms={bms:.6f} ({by}); wall "
        f"per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms")
    return {
        "name": "mask_assembly", "route": "cuda",
        "source": "tod_tpu_torch/csrc/mask_assembly.cu",
        "replaces": "tod_tpu/kernels/mask_assembly.py:61",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        "own": (kernel, "mask_assembly_kernel"),
    }


def check_k2(torch, np, rng, device):
    from tod_tpu_torch.core.device import sm_count
    from tod_tpu_torch.kernels.connections import (
        connection_planes,
        connection_tiling,
        connection_weights,
        plain_connection_planes,
        plain_connection_weights,
    )

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    main = None
    extra = np.random.default_rng(2)  # as in check_k1: only the first two draw from rng
    for i, (h, w) in enumerate(((480, 640), (37, 53), (479, 641), (960, 1280), (1, 1))):
        gen = rng if i < 2 else extra
        hm = gen.uniform(0, 300, (h, w)).astype(np.float32)
        hm[gen.random((h, w)) < 0.01] = np.nan
        height = torch.from_numpy(hm).to(device)
        pos_k, conn_k = connection_weights(height)
        pos_p, conn_p = plain_connection_weights(height)
        torch.cuda.synchronize()
        ok = same(pos_k, pos_p) and same(conn_k, conn_p)
        t = connection_tiling(h, w, sm_count(device))
        log(f"  K2 connections H,W=({h},{w}): planes and pos bitwise equal={ok} (tol exact); "
            f"{t.blocks} bands of {t.rows} rows, {t.smem_bytes} bytes of shared memory")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {(h, w)}")
        if main is None:
            main = torch.from_numpy(np.nan_to_num(hm)).to(device)
    h, w = main.shape
    kernel = lambda: connection_planes(main)  # noqa: E731
    ms, wall = time_ms(kernel, torch)
    plain_ms, plain_wall = time_ms(lambda: plain_connection_planes(main), torch)
    # the heights read once, the 8 weights a node written once
    bms, by = bound_ms(4 * (h * w + 8 * h * w), 8 * 6.0 * h * w)
    log(f"  K2 times at ({h},{w}): kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"bound_ms={bms:.6f} ({by}); wall per call: kernel {wall:.4f} ms, plain "
        f"{plain_wall:.4f} ms")
    return {
        "name": "connections", "route": "cuda",
        "source": "tod_tpu_torch/csrc/connections.cu",
        "replaces": "tod_tpu/kernels/connections.py:37",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "own": (kernel, "connections_kernel"),
    }


def relax_inputs(torch, np, rng, device, h, w, seeds):
    """A rolling height map (a random walk down the rows), its K2 edges and
    a seed map, on ``device``."""
    from tod_tpu_torch.kernels.connections import connection_planes

    hm = np.cumsum(rng.normal(0, 0.3, (h, w)), axis=0).astype(np.float32)
    height = torch.from_numpy(hm - hm.min()).to(device)
    seed = torch.zeros((h, w), dtype=torch.bool, device=device)
    for y, x in seeds:
        seed[y, x] = True
    return height, connection_planes(height), seed


def check_relax(torch, np, rng, device):
    """The relaxation kernel against ``plain_bellman_ford_grid`` on the card:
    distances bit for bit, next hops and the sweep count equal, at VGA, QVGA,
    a map its tiles do not divide (479x641), one with more tiles than
    co-resident blocks (960x1280), a small ragged map and a seedless one, and
    at VGA with max_iters 0, 1, k + 1, sweeps - 1 and sweeps - 2."""
    from tod_tpu_torch.kernels.relax import (bellman_ford_grid, plain_bellman_ford_grid,
                                             relax_tiling)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    main = None
    cases = [((480, 640), [(20, 100), (200, 600)]), ((240, 320), [(10, 300), (120, 40), (239, 5)]),
             ((479, 641), [(20, 100), (200, 600)]),
             ((960, 1280), [(40, 200), (400, 1200), (900, 30)]),
             ((37, 53), [(3, 40)]), ((37, 53), [])]
    for (h, w), seeds in cases:
        args = relax_inputs(torch, np, rng, device, h, w, seeds)
        t = relax_tiling(h, w, sms)
        route = "resident" if t.tiles <= t.blocks else "looping"
        log(f"  relax tiling at ({h},{w}) on {sms} SMs: tile {t.tile_h}x{t.tile_w}, k={t.k}, "
            f"{t.tiles} tiles on {t.blocks} blocks ({route}), {t.smem_bytes} bytes of shared "
            "memory a block")
        runs = [(2048, *plain_bellman_ford_grid(*args))]
        if main is None:
            full = runs[0][3]
            for cap in (0, 1, t.k + 1, full - 1, full - 2):
                runs.append((cap, *plain_bellman_ford_grid(*args, max_iters=cap)))
        for max_iters, want_d, want_n, want_s in runs:
            dist, nxt, sweeps = bellman_ford_grid(*args, max_iters=max_iters)
            torch.cuda.synchronize()
            ok = (torch.equal(dist, want_d) and torch.equal(nxt, want_n)
                  and int(sweeps) == want_s)
            log(f"  relax H,W=({h},{w}) seeds={len(seeds)} max_iters={max_iters}: "
                f"sweeps {int(sweeps)} (plain {want_s}), dist bitwise and next_dir equal={ok} "
                f"(tol exact), reached={int((want_d < 3.4e38).sum())}")
            if not ok:
                raise AssertionError(f"the relaxation disagrees with its plain version at "
                                     f"{(h, w)}, max_iters={max_iters}")
        if main is None:
            main = args, runs[0][3]
    args, sweeps = main
    h, w = args[0].shape
    ms, wall = time_ms(lambda: bellman_ford_grid(*args), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_bellman_ford_grid(*args), torch, n=5, warmup=1)
    # inputs read once (height, 8 edges, the seed byte), dist, next_dir and
    # the count written once; 8 candidates x 3 operations a node a sweep,
    # and once more for the argmin, none of them an FMA
    bms, by = bound_ms(h * w * (4 + 32 + 1 + 4 + 8) + 4, 24.0 * h * w * (sweeps + 1), ALU_OPS)
    t = relax_tiling(h, w, sms)
    log(f"  relax times at ({h},{w}), {sweeps} sweeps, {-(-sweeps // t.k) + 1} grid barriers: "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bms:.6f} ({by}; the barriers "
        f"are not in it); wall per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms")
    return {
        "name": "relax", "route": "cuda", "source": "tod_tpu_torch/csrc/relax.cu",
        "replaces": "tod_tpu/planner/tpu_relax.py:50",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "own": (lambda: bellman_ford_grid(*args), "relax_kernel"),
    }


def check_walk(torch, np, rng, device):
    from tod_tpu_torch.kernels.path_walk import plain_walk_path, walk_path
    from tod_tpu_torch.kernels.relax import bellman_ford_grid
    from tod_tpu_torch.planner.relax import start_node_yx

    tol = 1e-6  # turns: acosf/atan2f against libm in the last bit; the rest exact
    worst, main = 0.0, None
    for (h, w), seeds in (((480, 640), [(20, 100), (200, 600)]), ((37, 53), [(3, 40)]),
                          ((37, 53), [])):
        dist, nxt, _ = bellman_ford_grid(*relax_inputs(torch, np, rng, device, h, w, seeds))
        start = start_node_yx((h, w), 240)
        for steps in (2048, 1024, 7, 0):
            for signed in (False, True):
                got = walk_path(dist, nxt, start, steps, signed)
                want = plain_walk_path(dist, nxt, start, steps, signed)
                got = got.cpu()
                err = (got - want).abs().max().item()
                exact = torch.equal(got[0], want[0]) and torch.equal(got[:, 0], want[:, 0])
                log(f"  path_walk H,W=({h},{w}) seeds={len(seeds)} max_steps={steps} "
                    f"signed={signed}: n_valid={int(want[0, 0])}, truncated={int(want[0, 1])}, "
                    f"header and magnitudes equal={exact}, max_abs_err={err:.3e} (tol {tol:g})")
                if not (exact and err <= tol):
                    raise AssertionError(f"path_walk disagrees with its plain version at {(h, w)}")
                worst = max(worst, err)
        if main is None:
            main = dist, nxt, start, int(plain_walk_path(dist, nxt, start, 2048)[0, 0])
    dist, nxt, start, hops = main
    times = {}
    for steps in (2048, 1024):  # the main path's cap, and the serial walk's timed cap
        times[steps] = time_ms(lambda: walk_path(dist, nxt, start, steps), torch)
    ms, wall = times[2048]
    plain_ms, plain_wall = time_ms(lambda: plain_walk_path(dist, nxt, start, 2048), torch)
    # what this walk needs: each hop's node read once from both maps, the plan written
    bms, by = bound_ms((hops + 1) * (4 + 8) + (2048 + 1) * 2 * 4, 20.0 * hops)
    log(f"  path_walk times at ({dist.shape[0]},{dist.shape[1]}), {hops} hops: "
        f"kernel_ms={ms:.5f} at max_steps 2048, {times[1024][0]:.5f} at 1024; "
        f"plain_ms={plain_ms:.5f} (readback + host walk) bound_ms={bms:.6f} ({by}); wall per "
        f"call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms")
    return {
        "name": "path_walk", "route": "cuda",
        "source": "tod_tpu_torch/csrc/path_walk.cu",
        "replaces": "tod_tpu/planner/tpu_relax.py:200",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "own": (lambda: walk_path(dist, nxt, start, 2048), "path_walk_kernel"),
    }


def color_class_map(np, rgb):
    """The synthetic scene's classes by colour, as a perfect detector would
    label them: 3 ball (yellow), 1 red robot, 2 blue robot, 0 terrain."""
    cls = np.zeros(rgb.shape[:2], np.uint8)
    for label, color in ((3, (240, 220, 40)), (1, (220, 40, 40)), (2, (40, 60, 220))):
        cls[(rgb == color).all(axis=-1)] = label
    return cls


def terrain_peaks(torch, np, depth, cls, cam, geom):
    """The P-padded terrain peak map that the occupancy map dilates (the
    input of K3/K4), from a depth map and a class map on one device."""
    from tod_tpu_torch.geometry.fusion import _scatter_peaks, birdseye_project

    h, w = depth.shape
    bird_y, _, _ = birdseye_project(depth, cam)
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    return _scatter_peaks(bird_y, cls == 0, rows, geom.terrain_norm_const)


def needed_ring_work(torch, peaks_ext, bump_size, bump_err, out_shape) -> tuple[int, int]:
    """The work the dilation needs on this input: (maxima, bump
    evaluations), by a per-pixel exact stop.  A pixel takes the NaN-ignoring
    maximum W of its window (separably: 2 x 2L maxima), then its rings in
    ascending r^2 until no ring still to come can raise its accumulator.
    Since g(m, r) <= m, and on the rings whose exponent is >= 0 g(m, r) <=
    m / 2 where m >= 2 err (c1 >= 1), it stops once its accumulator reaches
    floor(W), or on those rings floor(max(min(W, 2 err), W / 2 where W >= 2
    err)).  Each ring it takes costs one maximum a displacement, and one
    evaluation of g where the ring's maximum is positive.  (The bounds are
    in exact arithmetic: this counts work and decides no value.)"""
    from tod_tpu_torch.kernels.bump import _bump_value, ring_table

    h, w = out_shape
    L = bump_size
    pad = (peaks_ext.shape[0] - h) // 2
    src = torch.nan_to_num(peaks_ext[pad - L + 1 : pad + L + h, pad - L + 1 : pad + L + w],
                           nan=0.0, posinf=float("inf"))
    window = torch.nn.functional.max_pool2d(src[None, None], 2 * L, stride=1)[0, 0].clamp_min(0)
    near_stop = torch.floor(window)
    two_err = 2.0 * float(bump_err)
    far_stop = torch.floor(torch.clamp_max(window, two_err))
    far_stop = torch.where(window >= two_err, torch.fmax(far_stop, torch.floor(window / 2)),
                           far_stop)
    acc = torch.zeros((h, w), dtype=torch.float32, device=peaks_ext.device)
    n_maxima, n_evals = 2 * (2 * L) * h * w, 0
    for _, disps, exponent in ring_table(L):
        m = torch.stack([peaks_ext[pad - dy : pad - dy + h, pad - dx : pad - dx + w]
                         for dy, dx in disps]).amax(dim=0)
        live = acc < (far_stop if exponent >= 0 else near_stop)
        n_maxima += len(disps) * int(live.sum())
        n_evals += int((live & (m > 0)).sum())
        contrib = torch.floor(_bump_value(m, exponent, bump_err))
        acc = torch.maximum(acc, torch.where(m > 0, contrib, 0.0))
    return n_maxima, n_evals


def check_bump(torch, np, rng, device):
    """K3 and K4 against the plain ring loop, bitwise (NaN where it has NaN),
    at VGA, QVGA and a ragged shape with the app's radius L = 10, QVGA at
    L = 4 (whose exponents take torch's sqrt and rsqrt cases), VGA with +inf
    and NaN peaks, the largest radius (a tile above 48 KB of shared memory)
    and a map whose tiles ``bump_tiling`` shrinks to one row; then the
    strip check."""
    from tod_tpu_torch.core.config import CameraConfig, GeometryConfig
    from tod_tpu_torch.core.device import sm_count
    from tod_tpu_torch.kernels.bump import (bump_tiling, dilate_peaks, dilate_peaks_strips,
                                            plain_dilate_peaks)
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    def random_peaks(h, w, L, integral, gen=rng):
        ext = np.zeros((h + 2 * L, w + 2 * L), np.float32)
        m = gen.random(ext.shape) < 0.03
        ext[m] = gen.integers(1, h, m.sum()) if integral else gen.uniform(1, 60, m.sum())
        return ext

    def special_peaks(h, w, L, gen):
        ext = random_peaks(h, w, L, True, gen)
        ext[gen.random(ext.shape) < 0.002] = np.inf
        ext[gen.random(ext.shape) < 0.002] = np.nan
        return ext

    geom = GeometryConfig()
    f = synth_frame_numpy(0, 0, 480, 640)
    scene = terrain_peaks(torch, np, torch.from_numpy(f.depth.astype(np.int32)).to(device),
                          torch.from_numpy(color_class_map(np, f.rgb)).to(device),
                          CameraConfig(), geom)
    extra = np.random.default_rng(5)  # the added cases: the later checks' inputs stay
    cases = [("VGA terrain", scene, (480, 640), 10)] + [
        (name, torch.from_numpy(ext).to(device), shape, L) for name, ext, shape, L in (
            ("VGA", random_peaks(480, 640, 10, True), (480, 640), 10),
            ("VGA float", random_peaks(480, 640, 10, False), (480, 640), 10),
            ("QVGA", random_peaks(240, 320, 10, True), (240, 320), 10),
            ("ragged", random_peaks(37, 53, 10, True), (37, 53), 10),
            ("QVGA L=4", random_peaks(240, 320, 4, True), (240, 320), 4),
            ("VGA +inf and NaN", special_peaks(480, 640, 10, extra), (480, 640), 10),
            ("L=47", random_peaks(480, 100, 47, True, extra), (480, 100), 47),
            ("one-row tiles", random_peaks(61, 45, 10, False, extra), (61, 45), 10))]
    sms = sm_count(device)
    for name, ext, shape, L in cases:
        want = plain_dilate_peaks(ext, L, geom.bump_err, shape)

        def differing(got):
            return int(((got != want) & ~(torch.isnan(got) & torch.isnan(want))).sum())

        diff = differing(dilate_peaks(ext, L, geom.bump_err, shape))
        if shape[0] % 16 == 0:
            diff += differing(dilate_peaks_strips(ext, L, geom.bump_err, shape))
        torch.cuda.synchronize()
        t = bump_tiling(*shape, L, sms)
        log(f"  K3/K4 bump {name} {tuple(ext.shape)}->{shape} L={L}: differing values={diff} "
            f"(tol exact, NaN where the plain version has NaN), positive outputs="
            f"{int((want > 0).sum())}, NaN outputs={int(torch.isnan(want).sum())}; {t.blocks} "
            f"blocks of {t.pixels} pixels x {t.rows} rows, {t.smem_bytes} bytes of shared memory")
        if diff:
            raise AssertionError(f"K3/K4 disagree with the plain ring loop at {name}")
    try:
        dilate_peaks_strips(cases[4][1], 10, geom.bump_err, (37, 53))
    except ValueError as e:
        log(f"  K3 rejects H % strip_h != 0: ValueError({e})")
    else:
        raise AssertionError("K3 accepted H=37 with strip_h=16")
    ext, shape, L = scene, (480, 640), 10
    ms, wall = time_ms(lambda: dilate_peaks_strips(ext, L, geom.bump_err, shape), torch)
    k4_ms, _ = time_ms(lambda: dilate_peaks(ext, L, geom.bump_err, shape), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_dilate_peaks(ext, L, geom.bump_err, shape), torch)
    n_maxima, evals = needed_ring_work(torch, ext, L, geom.bump_err, shape)
    # each input read once, the output written once; the work this input
    # needs (needed_ring_work, a per-pixel exact stop, which the kernel
    # does not take): its maxima, and its bump evaluations, each counted as
    # one operation (on these integral peaks a table lookup and a max: the
    # kernel's memo).  None is an FMA: one a lane a clock (ALU_OPS), as for
    # the relaxation.
    bms, by = bound_ms(4 * (ext.numel() + shape[0] * shape[1]), n_maxima + evals, ALU_OPS)
    log(f"  K3 times at the VGA terrain peaks {tuple(ext.shape)}: kernel_ms={ms:.5f} "
        f"(K4 {k4_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms={bms:.6f} ({by}; the input needs "
        f"{n_maxima} maxima, {n_maxima / (shape[0] * shape[1]):.1f} a pixel where the kernel "
        f"takes {(2 * L) ** 2}, and {evals} bump evaluations: "
        f"{(n_maxima + evals) / ALU_OPS * 1e3:.6f} ms at ALU_OPS); wall per call: kernel "
        f"{wall:.4f} ms, plain {plain_wall:.4f} ms")
    common = {"route": "cuda", "source": "tod_tpu_torch/csrc/bump.cu", "max_abs_err": 0.0,
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}
    return [
        {"name": "bump_strips", "replaces": "tod_tpu/kernels/bump.py:90", "ms": ms, **common,
         "own": (lambda: dilate_peaks_strips(ext, L, geom.bump_err, shape), "bump_kernel")},
        {"name": "bump", "replaces": "tod_tpu/kernels/bump.py:160", "ms": k4_ms, **common,
         "own": (lambda: dilate_peaks(ext, L, geom.bump_err, shape), "bump_kernel")},
    ]


def check_k5(torch, np, rng, device):
    """K5: the deterministic path exactly (card against CPU); the stochastic
    kernel bitwise against its plain version (on the card and on the CPU) on
    the pinned tree's largest kernel, a ragged matrix, matrices whose size is
    not a multiple of 4 and a contiguous view whose base is not 16-byte
    aligned; and the properties of stochastic rounding."""
    from tod_tpu_torch.core.weights import read_tree
    from tod_tpu_torch.ops.quantize import (
        plain_quantize_tensor_stochastic,
        quantize_tensor,
        quantize_tensor_pallas,
    )

    tree = read_tree()
    key = max((k for k in tree if k.endswith("/kernel")), key=lambda k: tree[k].size)
    big = tree[key].reshape(-1, tree[key].shape[-1]).astype(np.float32)
    ragged = rng.normal(0, 0.1, (37, 53)).astype(np.float32)
    ragged[:, 3] = 0.0
    extra = np.random.default_rng(6)  # the added cases: the later checks' inputs stay
    cases = [(f"{key} {big.shape}", big, 0), (f"ragged {ragged.shape}", ragged, 0),
             ("(7, 5)", extra.normal(0, 0.1, (7, 5)).astype(np.float32), 0),
             ("(3, 6)", extra.normal(0, 0.1, (3, 6)).astype(np.float32), 0),
             (f"{key} {big.shape}, a view 4 bytes past 16-byte alignment", big, 1)]
    for name, x, offset in cases:
        xc = torch.from_numpy(x)
        buf = torch.empty(x.size + offset, dtype=torch.float32, device=device)
        xd = buf[offset:].view(x.shape)
        xd.copy_(xc)
        if xd.data_ptr() % 16 != 4 * offset or not xd.is_contiguous():
            raise AssertionError(f"K5 case {name}: base {xd.data_ptr() % 16} bytes past alignment")
        qd, sd = quantize_tensor(xd)
        qc, sc = quantize_tensor(xc)
        det = torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)
        q, scale = quantize_tensor_pallas(xd, seed=7)
        pq, ps = plain_quantize_tensor_stochastic(xd, seed=7)
        cq, cs = plain_quantize_tensor_stochastic(xc, seed=7)
        torch.cuda.synchronize()
        stoch = torch.equal(q, pq) and torch.equal(scale, ps)
        host = torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cs)
        r = (xd / scale).double()
        qf = q.double()
        props = {
            "scales exact": torch.equal(scale, sd),
            "|q - x/s| < 1": bool(((qf - r).abs() < 1).all()),
            "floor or ceil": bool(((qf == torch.floor(r)) | (qf == torch.ceil(r))).all()),
            "same seed same q": torch.equal(quantize_tensor_pallas(xd, seed=7)[0], q),
            "other seed other q": not torch.equal(quantize_tensor_pallas(xd, seed=8)[0], q),
        }
        errs = torch.stack([quantize_tensor_pallas(xd, seed=s)[0].double() - r for s in range(64)])
        errs = errs[:, :, sd[0] > 1e-12]
        mean, sem = errs.mean().item(), (errs.std() / errs.numel() ** 0.5).item()
        props["mean error within 3 SE of 0"] = abs(mean) < 3 * sem
        log(f"  K5 quantize {name} (numel % 4 = {x.size % 4}): deterministic card == CPU {det}; "
            f"stochastic kernel == plain {stoch} (on the CPU too: {host}); {props}; mean error "
            f"over 64 seeds {mean:.3e} (SE {sem:.3e})")
        if not (det and stoch and host and all(props.values())):
            raise AssertionError(f"K5 fails at {name}")
    xd = torch.from_numpy(big).to(device)
    n, c = xd.shape
    ms, wall = time_ms(lambda: quantize_tensor_pallas(xd, seed=7), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_quantize_tensor_stochastic(xd, seed=7), torch)
    # x read once, int8 values and f32 scales written once; f32 operations
    # per element: abs, max, division, addition, floor, two clamps (the
    # Philox multiplies are integer work the f32 peak does not count)
    bms, by = bound_ms(4 * n * c + n * c + 4 * c, 7.0 * n * c)
    log(f"  K5 times at {(n, c)}: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"bound_ms={bms:.6f} ({by}); wall per call: kernel {wall:.4f} ms, plain "
        f"{plain_wall:.4f} ms")
    return {
        "name": "quantize", "route": "cuda", "source": "tod_tpu_torch/csrc/quantize.cu",
        "replaces": "tod_tpu/ops/quantize.py:43", "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        # its memset and its two kernels, the column maxima and the quantize pass
        "own": (lambda: quantize_tensor_pallas(xd, seed=7), K5_PARTS),
    }


# the cc kernel's three launches: the unions inside each tile in shared
# memory, the edges across tile borders, the flatten
CC_PARTS = ("cc_local_kernel", "cc_border_kernel", "cc_flatten_kernel")
TRACK_KERNEL = "track_warp_kernel"


def serpentine(np, h, w):
    """Rows joined alternately at their right and left ends: one component
    whose graph diameter is about H*W/2 (the plain loop's worst case)."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def scipy_ids(np, mask, max_labels):
    """The independent oracle: scipy's 4-connected labels, numbered from 1
    in row-major order of each component's first pixel."""
    import scipy.ndimage

    lab, n = scipy.ndimage.label(mask)
    return np.where(lab > 0, np.minimum(lab - 1, max_labels - 1), -1).astype(np.int32), n


def cc_masks(np, gen, h, w):
    return {"random p=0.5": gen.random((h, w)) < 0.5, "serpentine": serpentine(np, h, w),
            "checkerboard": (np.indices((h, w)).sum(0) % 2).astype(bool),
            "full": np.ones((h, w), bool), "empty": np.zeros((h, w), bool)}


def tile_bridges(np, gen, h, w, tile=32):
    """Blobs inside the cc kernel's tiles, some tiles without, joined by
    one-pixel lines lying exactly on tile rows (each tile's last row) and
    tile columns (each tile's first column), cut into segments, with a
    one-pixel stub from each blob to each line: every edge between two
    tiles is a bridge one pixel wide."""
    yy, xx = np.indices((h, w))
    ly, lx = yy % tile, xx % tile
    on = (gen.random((-(-h // tile), -(-w // tile))) < 0.7)[yy // tile, xx // tile]
    m = on & (ly >= 3) & (ly < tile - 3) & (lx >= 3) & (lx < tile - 3)
    m |= (ly == tile - 1) & ((xx // 5) % 4 != 0)
    m |= (lx == 0) & ((yy // 3) % 5 != 0)
    m |= on & (lx == 10) & (ly >= tile - 3) & (ly < tile - 1)  # blob to its tile's last row
    m |= on & (ly == 10) & (lx >= 1) & (lx < 3)  # blob to its tile's first column
    return m


def spiral(np, h, w, gap=2):
    """A square spiral of one-pixel lines ``gap`` apart, from the border
    inward: one component that crosses every tile it passes many times."""
    m = np.zeros((h, w), bool)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if bottom - top < gap or right - left < gap:
            break
        m[bottom, left:right + 1] = True
        m[top + gap:bottom + 1, left] = True
        top, left, bottom, right = top + gap, left + gap, bottom - gap, right - gap
        if top <= bottom:
            m[top, left - gap:left + 1] = True  # the turn inward
    return m


def tile_masks(np, gen, h, w):
    """The masks that cross the cc kernel's tile borders on purpose."""
    return {"tile bridges": tile_bridges(np, gen, h, w), "spiral": spiral(np, h, w)}


def hold_cc(torch, np, mask, name, plain=True) -> None:
    """The cc kernel on ``mask`` against its plain version bit for bit
    (``plain``) and, through the compaction, against the scipy oracle with
    no clamp and with the main path's 100 labels."""
    from tod_tpu_torch.kernels.cc_labels import plain_root_labels, root_labels
    from tod_tpu_torch.ops.cc_labels import compact_labels

    card = torch.from_numpy(mask).cuda()
    labels = root_labels(card)
    torch.cuda.synchronize()
    same = torch.equal(labels.cpu(), plain_root_labels(card).cpu()) if plain else None
    h, w = mask.shape
    oracle = {}
    for cap in (h * w, 100):
        want, n = scipy_ids(np, mask, cap)
        oracle[cap] = bool((compact_labels(labels, cap).cpu().numpy() == want).all())
    log(f"  cc_labels {name} {h}x{w}: {n} components; root labels equal to the plain loop "
        f"{'not run (its sweeps are ~H*W/2 here)' if same is None else same} (tol exact); "
        f"ids equal to scipy.ndimage.label: uncapped {oracle[h * w]}, capped at 100 "
        f"{oracle[100]} (tol exact)")
    if same is False or not all(oracle.values()):
        raise AssertionError(f"the cc kernel disagrees on {name} {h}x{w}")


def check_cc(torch, np, rng, device):
    from tod_tpu_torch.core.config import CameraConfig
    from tod_tpu_torch.kernels.cc_labels import plain_root_labels, root_labels
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    gen = np.random.default_rng(3)
    for h, w in ((64, 64), (37, 53), (97, 131), (1, 1), (1, 64), (64, 1)):
        for name, mask in {**cc_masks(np, gen, h, w), **tile_masks(np, gen, h, w)}.items():
            hold_cc(torch, np, mask, name)
    for h, w in ((480, 640), (479, 641)):
        for name, mask in {**cc_masks(np, gen, h, w), **tile_masks(np, gen, h, w)}.items():
            hold_cc(torch, np, mask, name, plain=name not in ("serpentine", "spiral"))
    # the main path's shape and kind of input: the balls of a synthetic frame
    cam = CameraConfig()
    f = synth_frame_numpy(0, 3, cam.height, cam.width)
    balls = torch.from_numpy(color_class_map(np, f.rgb) == 3).to(device)
    hold_cc(torch, np, balls.cpu().numpy(), "synthetic balls")
    ms, wall = time_ms(lambda: root_labels(balls), torch)
    plain_ms, plain_wall = time_ms(lambda: plain_root_labels(balls), torch)
    h, w = balls.shape
    # the mask read once (1 byte a pixel), the int32 labels written once; a
    # handful of integer operations a pixel (ALU_OPS)
    bms, by = bound_ms(5.0 * h * w, 8.0 * h * w, ALU_OPS)
    log(f"  cc_labels times at ({h},{w}), {int(balls.sum())} ball pixels: kernel_ms={ms:.5f} "
        f"(three launches; each one's own time in phase 11) plain_ms={plain_ms:.5f} (the "
        f"propagation loop, a host read a sweep) "
        f"bound_ms={bms:.6f} ({by}); library: none (no one torch call labels components); "
        f"wall per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms")
    return {
        "name": "cc_labels", "route": "cuda", "source": "tod_tpu_torch/csrc/cc_labels.cu",
        "replaces": "tod_tpu/ops/cc_labels.py:35",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "own": (lambda: root_labels(balls), CC_PARTS),
    }


TRACK_STEPS = 64
TRACKED_TICKS = 4  # phase 16: tracked ticks held against the single-stream tracked step


def random_banks(np, gen, n, k=8, m=100):
    """Random banks and ball slots: every field of a row in its range, a
    third of the rows inactive, balls scattered round the tracks so that
    gates are contended, counts on both sides of min_pixels (3.0)."""
    banks = np.zeros((n, k, 10), np.float32)
    banks[..., 0:2] = gen.uniform(0, 160, (n, k, 2))
    banks[..., 2:4] = gen.normal(0, 2, (n, k, 2))
    banks[..., 4] = gen.uniform(0.5, 30, (n, k))
    banks[..., 5] = gen.uniform(-2, 2, (n, k))
    banks[..., 6] = gen.uniform(0.5, 30, (n, k))
    banks[..., 7] = gen.integers(0, 6, (n, k))
    banks[..., 8] = gen.integers(0, 9, (n, k))
    banks[..., 9] = gen.random((n, k)) < 0.67
    balls = np.zeros((n, m, 4), np.float32)
    near = np.take_along_axis(banks[..., 0:2], gen.integers(0, k, (n, m, 1)), axis=1)
    balls[..., 0:2] = near + gen.normal(0, 12, (n, m, 2))
    balls[..., 2] = gen.choice([0.0, 2.0, 3.0, 3.5, 20.0, 40.0], (n, m))
    balls[..., 2] *= gen.random((n, m)) < 0.3  # most slots empty, as in a scene
    return banks, balls


def tie_banks(np, gen, n, k=8, m=100):
    """Banks whose costs tie: tracks at rest on even integer cells (two may
    share one), valid balls on integer cells between them (two may share
    one), so that a ball lies as far from two tracks as a track from two
    balls, and equal costs fall in different rows and columns: the flat
    index decides every such round."""
    banks = np.zeros((n, k, 10), np.float32)
    banks[..., 0:2] = 2 * gen.integers(0, 6, (n, k, 2))
    banks[..., 4] = banks[..., 6] = 1.0
    banks[..., 7] = gen.integers(0, 6, (n, k))
    banks[..., 9] = gen.random((n, k)) < 0.85
    balls = np.zeros((n, m, 4), np.float32)
    balls[..., 0:2] = gen.integers(-1, 12, (n, m, 2))
    balls[..., 2] = np.where(gen.random((n, m)) < 0.3, 9.0, 0.0)
    return banks, balls


def tied_costs(np, banks, balls, cfg) -> int:
    """Pairs of equal gated costs in one bank's matrix, across its rows or
    its columns."""
    pred = banks[..., 0:2] + banks[..., 2:4]
    d2 = ((pred[:, :, None] - balls[:, None, :, 0:2]) ** 2).sum(-1)
    ok = (banks[..., 9] > 0)[..., None] & (balls[:, None, :, 2] > cfg.min_pixels) \
        & (d2 <= cfg.gate**2)
    n = 0
    for c, g in zip(d2, ok):
        vals = c[g]
        n += int(vals.size - np.unique(vals).size)
    return n


def track_sequence(np, gen, n, steps, m=100):
    """``steps`` frames of ball slots for ``n`` banks: 10 balls a bank on
    straight lines (more than the 8 tracks), each missed a third of the
    time (coasting), some gone for good after a while (deaths), spurious
    blobs (births), two balls crossing in every bank (contended gates) and
    counts at min_pixels exactly (invalid) and just above it."""
    seq = np.zeros((steps, n, m, 4), np.float32)
    for b in range(n):
        pos = gen.uniform(20, 140, (10, 2))
        vel = gen.normal(0, 1.5, (10, 2))
        pos[1], vel[1] = pos[0] + (30, 0), vel[0] + (-1.0, 0)  # ball 1 crosses ball 0
        life = gen.integers(steps // 3, 2 * steps, 10)
        for s in range(steps):
            slots = gen.permutation(m)
            for i in range(10):
                if s < life[i] and gen.random() > 0.33:
                    seq[s, b, slots[i], :3] = (*(pos[i] + gen.normal(0, 0.8, 2)),
                                               gen.choice([3.0, 3.0001, 25.0]))
            for j in range(gen.integers(0, 3)):  # spurious blobs
                seq[s, b, slots[10 + j], :3] = (*gen.uniform(0, 160, 2), 12.0)
            pos += vel
    return seq


def sequence_events(np, banks, seq, cfg) -> dict:
    """Births, deaths, coasting rows and contended gates (an active track
    with two valid balls inside its gate) over a sequence of banks and the
    ball slots that made it."""
    ev = dict(births=0, deaths=0, coasting=0, contended=0)
    for old, new, balls in zip(banks[:-1], banks[1:], seq):
        pred = old[..., 0:2] + old[..., 2:4]
        d2 = ((pred[:, :, None] - balls[:, None, :, 0:2]) ** 2).sum(-1)
        inside = (d2 <= cfg.gate**2) & (balls[:, None, :, 2] > cfg.min_pixels)
        ev["contended"] += int(((old[..., 9] == 1) & (inside.sum(-1) >= 2)).sum())
        born = (new[..., 9] == 1) & (new[..., 7] == 1) & (new[..., 6] == cfg.vel0_var) \
            & (new[..., 2] == 0) & (new[..., 3] == 0)
        ev["births"] += int(born.sum())
        ev["deaths"] += int(((old[..., 9] == 1) & ((new[..., 9] == 0) | born)).sum())
        ev["coasting"] += int(((new[..., 9] == 1) & (new[..., 8] > 0)).sum())
    return ev


def check_track(torch, np, rng, device):
    """The tracker kernel against its plain version on the card: random
    banks at N = 1, 4, 16 and 33 (banks straddling a block), tie banks at
    N = 1, 4 and 33, both also at other ball counts M, then a 64-step
    sequence of 4 banks run side by side; every field of the banks and the
    seeds bit for bit."""
    from tod_tpu_torch.core.config import TrackerConfig
    from tod_tpu_torch.kernels.track import plain_track_banks, track_banks

    cfg = TrackerConfig(enabled=True)
    gen = np.random.default_rng(12)
    worst = 0.0
    ties = 0
    # M = 100 is the main path's (four columns a lane); 20 and 50 take the
    # kernel's one- and two-column builds, 300 its build for any M
    for n, kind, m in ((1, "random", 100), (4, "random", 100), (16, "random", 100),
                       (33, "random", 100), (1, "tie", 100), (4, "tie", 100), (33, "tie", 100),
                       (4, "random", 20), (4, "random", 50), (4, "random", 300),
                       (4, "tie", 300)):
        for trial in range(4):
            banks, balls = (random_banks if kind == "random" else tie_banks)(np, gen, n, m=m)
            ties += tied_costs(np, banks, balls, cfg) if kind == "tie" else 0
            card = torch.from_numpy(banks).to(device)
            b = torch.from_numpy(balls).to(device)
            want, want_seeds = plain_track_banks(card.clone(), b, cfg, 100)
            seeds = track_banks(card, b, cfg, 100)
            torch.cuda.synchronize()
            same = torch.equal(card, want) and torch.equal(seeds, want_seeds)
            worst = max(worst, (card - want).abs().max().item(),
                        (seeds - want_seeds).abs().max().item())
            if not same:
                raise AssertionError(f"the tracker kernel disagrees at N={n} ({kind}) trial "
                                     f"{trial}: rows differing "
                                     f"{int((card != want).any(-1).sum())}")
        log(f"  track N={n}, M={m}: 4 {kind} banks and ball sets, banks and seeds equal to the "
            f"plain version bit for bit (tol exact); active rows after the step "
            f"{int(card[..., 9].sum())} of {n * 8}")
    log(f"  track tie banks: {ties} pairs of equal gated costs in their matrices")
    if ties == 0:
        raise AssertionError("the tie banks made no equal costs")
    n = 4
    seq_np = track_sequence(np, gen, n, TRACK_STEPS)
    seq = torch.from_numpy(seq_np).to(device)
    card = torch.zeros((n, 8, 10), device=device)
    plain = card.clone()
    history = [plain.cpu().numpy()]
    for s in range(TRACK_STEPS):
        seeds = track_banks(card, seq[s], cfg, 100)
        plain, want_seeds = plain_track_banks(plain, seq[s], cfg, 100)
        if not (torch.equal(card, plain) and torch.equal(seeds, want_seeds)):
            raise AssertionError(f"the tracker kernel disagrees at step {s} of the sequence")
        history.append(plain.cpu().numpy())
    ev = sequence_events(np, np.stack(history), seq_np, cfg)
    log(f"  track sequence: {TRACK_STEPS} steps of {n} banks equal to the plain version bit "
        f"for bit (tol exact); events {ev}")
    if min(ev.values()) == 0:
        raise AssertionError(f"the tracker sequence missed a kind of event: {ev}")

    times = {}
    for n in (1, 4, 16, 33):
        banks, balls = random_banks(np, gen, n)
        card = torch.from_numpy(banks).to(device)
        b = torch.from_numpy(balls).to(device)
        ms, _ = time_ms(lambda: track_banks(card, b, cfg, 100), torch)
        plain_ms, _ = time_ms(lambda: plain_track_banks(card, b, cfg, 100), torch)
        # each bank and ball slot read once, the bank and the seeds written once
        bms, by = bound_ms(2 * 4 * n * (8 * 10 + 100 * 4), 0.0)
        times[n] = (ms, plain_ms, bms, by)
    log("  track times by N (kernel_ms, plain_ms, bound_ms, bound_by): "
        + ", ".join(f"N={n} {t}" for n, t in times.items())
        + "; library: none (no one torch call runs the tracker)")
    banks, balls = random_banks(np, gen, 1)
    one = torch.from_numpy(banks).to(device)
    one_balls = torch.from_numpy(balls).to(device)
    ms, plain_ms, bms, by = times[1]
    return {
        "name": "track", "route": "cuda", "source": "tod_tpu_torch/csrc/track.cu",
        "replaces": "tod_tpu/track/tracker.py:113",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "own": (lambda: track_banks(one, one_balls, cfg, 100), TRACK_KERNEL),
    }

def forward_conv_sites(torch, np):
    """Every distinct conv site of the default 256x320 forward: (input
    shape (C, H, W), OIHW kernel shape, stride, groups, ConvBN site) with
    the number of calls a forward, from the float model's convolutions."""
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.core.weights import load_pinned
    from tod_tpu_torch.models.conv import Conv
    from tod_tpu_torch.models.yolact import Yolact

    cfg = ModelConfig()
    model = Yolact(cfg)
    model.load_state_dict(load_pinned())
    model.to(device="cuda", dtype=torch.bfloat16).eval()
    sites: dict = {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            def hook(mod, inp, out, bn=name.endswith("Conv_0")):
                key = (tuple(inp[0].shape[1:]), tuple(mod.weight.shape), mod.stride, mod.groups, bn)
                sites[key] = sites.get(key, 0) + 1
            hooks.append(m.register_forward_hook(hook))
    with torch.inference_mode():
        model(torch.zeros((1, *cfg.input_size, 3), dtype=torch.bfloat16, device="cuda"))
    for h in hooks:
        h.remove()
    return sites


def qconv_inputs(torch, gen, device, b, site, dtype):
    """Random activations, s8 kernel, scales (one per sample) and bias for a
    conv site, drawn from ``gen``; some activations clip at +-127."""
    (c, h, w), wshape, _, _, _ = site
    cout = wshape[0]
    x = (torch.randn((b, c, h, w), generator=gen) * 3).to(dtype).to(device)
    kq = torch.randint(-127, 128, wshape, generator=gen, dtype=torch.int8).to(device)
    ws = (torch.rand(cout, generator=gen) * 1e-2 + 1e-4).to(device)
    sx = (torch.rand(b, generator=gen) * 0.05 + 0.005).to(device)
    bias = torch.randn(cout, generator=gen).to(device)
    return x, kq, ws, sx, bias


# the shapes the dense kernel's tiling makes risky: (batch, input (C, H, W),
# OIHW kernel shape, stride, ConvBN site)
QCONV_EDGES = {
    "M below one tile (P7)": (1, (128, 2, 3), (128, 128, 3, 3), 1, False),
    "M below one tile, stride 2 (P6 -> P7)": (1, (128, 4, 5), (288, 128, 3, 3), 2, False),
    "K not a multiple of a stage (1x1)": (1, (144, 9, 11), (24, 144, 1, 1), 1, True),
    "K not a multiple of a stage (3x3)": (1, (40, 6, 7), (64, 40, 3, 3), 1, False),
    "Cout not a multiple of the N tile": (1, (128, 5, 6), (300, 128, 3, 3), 1, False),
    "stride 2 on odd sizes": (1, (128, 5, 7), (128, 128, 3, 3), 2, False),
    "stride 2 on odd sizes (1x1)": (2, (64, 9, 7), (96, 64, 1, 1), 2, True),
    "Cin < 32 (stem, odd sizes)": (2, (3, 17, 23), (32, 3, 3, 3), 2, True),
    "Cin < 32 (3x3, flat K = 144)": (1, (16, 7, 9), (40, 16, 3, 3), 1, False),
    "Cin < 32 (1x1)": (1, (24, 9, 10), (144, 24, 1, 1), 1, True),
    "the largest split": (1, (224, 4, 5), (128, 224, 3, 3), 1, False),  # 8 splits of 2 stages
    "tiles across the batch": (3, (32, 7, 9), (64, 32, 3, 3), 1, False),
}


def hold_qconv(torch, gen, device, b, site, dtype, divide, what) -> None:
    """One call of the int8 kernel against ``plain_qconv``, bit for bit."""
    from tod_tpu_torch.kernels.qconv import pack_kernel, plain_qconv, qconv

    _, _, stride, groups, bn = site
    x, kq, ws, sx, bias = qconv_inputs(torch, gen, device, b, site, dtype)
    packed = pack_kernel(kq) if groups == 1 else None
    y = qconv(x, kq, ws, sx, bias, stride, groups, bn, divide, packed)
    want = plain_qconv(x, kq, ws, sx, bias, stride, groups, bn, divide)
    if not torch.equal(y, want):
        d = (y.float() - want.float()).abs()
        raise AssertionError(f"qconv disagrees at {what} {site} batch {b} {dtype} divide "
                             f"{divide}: {int((d > 0).sum())} values, max {d.max()}")


def check_qconv(torch, np, rng, device):
    """The int8 convolution kernel against its plain version on the card,
    bit for bit: every distinct conv site of the 256x320 forward (the
    depthwise ones as quantized depthwise sites) at batch 1 and 16 in bf16,
    at batch 1 in f32, with one scale per sample, the static quantize
    (x * (1 / sx)) and at batch 16 also the calibration's (x / sx); the
    shapes the dense kernel's tiling makes risky (``QCONV_EDGES``) in both
    types and both quantize forms; the largest split twice in a row; then a
    site whose int32 sums pass 2^24.  Timed at the ProtoNet 3x3 site beside
    its plain version, ``torch._int_mm`` on the im2col'd operands and the
    bf16 cuDNN conv, and at every site of the forward (the dense and the
    depthwise sums apart)."""
    from tod_tpu_torch.kernels import qconv as qk
    from tod_tpu_torch.kernels.qconv import pack_kernel, plain_qconv, qconv

    gen = torch.Generator().manual_seed(13)
    sites = forward_conv_sites(torch, np)
    n_dense = sum(n for (_, _, _, g, _), n in sites.items() if g == 1)
    log(f"  qconv: {len(sites)} distinct conv sites in the 256x320 forward, "
        f"{n_dense} dense conv calls a forward")
    checked = 0
    for site in sites:
        for b, dtype, modes in ((1, torch.bfloat16, (False,)), (16, torch.bfloat16, (False, True)),
                                (1, torch.float32, (False,))):
            for divide in modes:
                hold_qconv(torch, gen, device, b, site, dtype, divide, "a forward site")
                checked += 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for what, (b, chw, wshape, stride, bn) in QCONV_EDGES.items():
        site = (chw, wshape, stride, 1, bn)
        t = qk.qconv_tiling(b, *chw, wshape[0], wshape[2], stride, sms)
        for dtype in (torch.bfloat16, torch.float32):
            for divide in (False, True):
                hold_qconv(torch, gen, device, b, site, dtype, divide, what)
                checked += 1
        log(f"  qconv edge case {what}: batch {b} {chw} -> {wshape}, stride {stride}: "
            f"{t.m_tiles} M x {t.n_tiles} N tiles of {t.bn}, {t.k_steps} K steps in "
            f"{t.n_stages} stages, {t.splits} splits of {t.stages_per_split}: exact")
    b, chw, wshape, stride, bn = QCONV_EDGES["the largest split"]
    site = (chw, wshape, stride, 1, bn)
    x, kq, ws, sx, bias = qconv_inputs(torch, gen, device, b, site, torch.bfloat16)
    packed = pack_kernel(kq)
    want = plain_qconv(x, kq, ws, sx, bias, stride, 1, bn)
    twice = [qconv(x, kq, ws, sx, bias, stride, 1, bn, packed=packed) for _ in range(2)]
    if not all(torch.equal(y, want) for y in twice):  # nothing is left over from a call
        raise AssertionError("two calls in a row at the largest split disagree")
    # every product +127 x +127 at K = 1152: sums of 18,580,608 > 2^24
    x = torch.full((2, 128, 32, 40), 50.0, device=device)
    kq = torch.full((128, 128, 3, 3), 127, dtype=torch.int8, device=device)
    ones = torch.full((128,), 1e-3, device=device)
    sx = torch.tensor([0.01, 0.02], device=device)
    big = qconv(x, kq, ones, sx, ones, 1, 1, packed=pack_kernel(kq))
    if not torch.equal(big, plain_qconv(x, kq, ones, sx, ones, 1, 1)):
        raise AssertionError("qconv disagrees where the int32 sums pass 2^24")
    torch.cuda.synchronize()
    log(f"  qconv: {checked} site x batch x dtype x quantize cases, two calls in a row at "
        f"the largest split and one with sums of {1152 * 127 * 127} > 2^24 equal to the "
        f"plain version bit for bit (tol exact)")

    # the ProtoNet 3x3 site at batch 1, bf16
    site = ((128, 32, 40), (128, 128, 3, 3), 1, 1, False)
    x, kq, ws, sx, bias = qconv_inputs(torch, gen, device, 1, site, torch.bfloat16)
    packed = pack_kernel(kq)
    sx0 = sx[0]
    call = lambda: qconv(x, kq, ws, sx0, bias, 1, 1, packed=packed)  # noqa: E731
    ms, _ = time_ms(call, torch)
    plain_ms, _ = time_ms(lambda: plain_qconv(x, kq, ws, sx, bias, 1, 1), torch, n=10)
    m, k, n = 32 * 40, 128 * 9, 128
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=device)
    bmat = kq.reshape(n, k).t()
    try:
        int_mm_ms, _ = time_ms(lambda: torch._int_mm(a, bmat), torch)
    except RuntimeError:
        bmat = bmat.contiguous()
        int_mm_ms, _ = time_ms(lambda: torch._int_mm(a, bmat), torch)
    wb = kq.to(torch.bfloat16)
    cudnn_ms, _ = time_ms(lambda: torch.nn.functional.conv2d(x, wb, None, 1, 1), torch)
    # x read once (bf16), y written once (bf16), the s8 kernel, scales and bias
    n_bytes = 2 * 128 * 32 * 40 * 2 + 128 * k + 3 * 128 * 4
    bms, by = bound_ms(n_bytes, 2.0 * m * n * k, INT8_OPS)
    t = qk.qconv_tiling(1, 128, 32, 40, 128, 3, 1, sms)
    log(f"  qconv ProtoNet 3x3 (1, 128, 32, 40) -> 128, K = {k}, bf16 ({t.blocks} blocks: "
        f"{t.m_tiles} M tiles x {t.splits} splits): kernel {ms:.5f} ms, plain {plain_ms:.5f}, "
        f"torch._int_mm (M={m}, K={k}, N={n}) {int_mm_ms:.5f}, bf16 cuDNN conv "
        f"{cudnn_ms:.5f}, bound {bms:.6f} ({by})")

    totals = {1: [0.0, 0.0, 0], 0: [0.0, 0.0, 0]}  # dense / depthwise: ms, bound ms, calls
    for site, calls in sites.items():
        (c, h, w), wshape, stride, groups, bn = site
        xs, kqs, wss, sxs, bs = qconv_inputs(torch, gen, device, 1, site, torch.bfloat16)
        ps = pack_kernel(kqs) if groups == 1 else None
        t_ms, _ = time_ms(lambda: qconv(xs, kqs, wss, sxs, bs, stride, groups, bn, False, ps),
                          torch, n=20)
        ho, wo = -(-h // stride), -(-w // stride)
        kk = wshape[1] * wshape[2] * wshape[3]
        site_bytes = 2 * c * h * w + 2 * wshape[0] * ho * wo + kqs.numel()
        total = totals[int(groups == 1)]
        total[0] += calls * t_ms
        total[1] += calls * bound_ms(site_bytes, 2.0 * ho * wo * wshape[0] * kk, INT8_OPS)[0]
        total[2] += calls
    log(f"  qconv at the dense sites of the 256x320 forward (the default --int8 path), "
        f"batch 1, bf16, by calls: {totals[1][2]} launches, {totals[1][0]:.4f} ms of kernel "
        f"time by events against a {totals[1][1]:.5f} ms bound")
    log(f"  qconv at the depthwise sites (quantize_depthwise only), by calls: {totals[0][2]} "
        f"launches, {totals[0][0]:.4f} ms by events against a {totals[0][1]:.5f} ms bound")
    return {
        "name": "qconv", "route": "cuda", "source": "tod_tpu_torch/csrc/qconv.cu",
        "replaces": "tod_tpu/models/qconv.py:149",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": int_mm_ms, "cudnn_bf16_ms": cudnn_ms,
        "own": (call, "qconv_wgmma_kernel"),
    }


# the ResNet stem (tod_tpu/models/resnet.py:98): 7x7 stride 2 from RGB at VGA,
# a ConvBN site, flat K = 147; as a phase 3 site tuple
STEM = ((3, 480, 640), (64, 3, 7, 7), 2, 1, True)


def check_qconv_stem(torch, np, rng, device):
    """The int8 kernel at the ResNet stem's 7x7 site against ``plain_qconv``,
    bit for bit: (1 and 16, 3, 480, 640) -> 64 in bf16 and f32, both
    quantize forms, and a batch of 2 at odd sizes; timed at batch 1 in bf16
    beside the plain version, ``torch._int_mm`` on the im2col'd operands (K
    padded to 152) and the bf16 cuDNN conv."""
    from tod_tpu_torch.kernels import qconv as qk
    from tod_tpu_torch.kernels.qconv import pack_kernel, plain_qconv, qconv

    gen = torch.Generator().manual_seed(17)
    checked = 0
    for b in (1, 16):
        for dtype in (torch.bfloat16, torch.float32):
            for divide in (False, True):
                hold_qconv(torch, gen, device, b, STEM, dtype, divide, "the ResNet stem")
                checked += 1
    odd = ((3, 17, 23), (64, 3, 7, 7), 2, 1, True)
    for dtype in (torch.bfloat16, torch.float32):
        hold_qconv(torch, gen, device, 2, odd, dtype, False, "the 7x7 stem at odd sizes")
        checked += 1
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t = qk.qconv_tiling(1, 3, 480, 640, 64, 7, 2, sms)
    log(f"  qconv ResNet stem 7x7 stride 2 (B, 3, 480, 640) -> 64, flat K = {t.k_len}: "
        f"{checked} batch x dtype x quantize cases equal to the plain version bit for bit "
        f"(tol exact)")
    x, kq, ws, sx, bias = qconv_inputs(torch, gen, device, 1, STEM, torch.bfloat16)
    packed = pack_kernel(kq)
    sx0 = sx[0]
    call = lambda: qconv(x, kq, ws, sx0, bias, 2, 1, True, packed=packed)  # noqa: E731
    ms, _ = time_ms(call, torch)
    plain_ms, _ = time_ms(lambda: plain_qconv(x, kq, ws, sx, bias, 2, 1, True), torch, n=10)
    m, k, n = 240 * 320, 147, 64
    a = torch.randint(-127, 128, (m, 152), dtype=torch.int8, device=device)
    bmat = torch.nn.functional.pad(kq.reshape(n, k), (0, 5)).t()
    try:
        int_mm_ms, _ = time_ms(lambda: torch._int_mm(a, bmat), torch)
    except RuntimeError:
        bmat = bmat.contiguous()
        int_mm_ms, _ = time_ms(lambda: torch._int_mm(a, bmat), torch)
    wb = kq.to(torch.bfloat16)
    cudnn_ms, _ = time_ms(lambda: torch.nn.functional.conv2d(x, wb, None, 2, 3), torch)
    # x read once (bf16), y written once (bf16), the s8 kernel, scales and bias
    n_bytes = 2 * 3 * 480 * 640 + 2 * 64 * 240 * 320 + 64 * k + 3 * 64 * 4
    bms, by = bound_ms(n_bytes, 2.0 * m * n * k, INT8_OPS)
    log(f"  qconv ResNet stem (1, 3, 480, 640) -> 64, bf16 ({t.blocks} blocks: {t.m_tiles} M "
        f"tiles x {t.splits} splits, {t.k_steps} K steps): kernel {ms:.5f} ms, plain "
        f"{plain_ms:.5f}, torch._int_mm (M={m}, K=152, N={n}) {int_mm_ms:.5f}, bf16 cuDNN "
        f"conv {cudnn_ms:.5f}, bound {bms:.6f} ({by})")
    return {
        "name": "qconv_stem", "route": "cuda", "source": "tod_tpu_torch/csrc/qconv.cu",
        "replaces": "tod_tpu/models/qconv.py:149",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": int_mm_ms, "cudnn_bf16_ms": cudnn_ms,
        "own": (call, "qconv_wgmma_kernel"),
    }


def d5_refusals(torch) -> None:
    """ROADMAP.md D5: a configuration past a card kernel's limit is refused
    by ``Engine`` and ``MultiStreamEngine`` on the card before any weight
    loads, naming the limit; the CPU serves it."""
    import dataclasses

    from tod_tpu_torch.core.config import GeometryConfig, ModelConfig, PipelineConfig, TrackerConfig
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.multistream import MultiStreamEngine

    base = PipelineConfig()
    cases = {
        "K1 MAX_K": base.replace(model=ModelConfig(num_prototypes=40)),
        "K3/K4 radius": base.replace(geometry=GeometryConfig(terrain_norm_const=120)),
        "tracker MAX_TRACKS": base.replace(
            tracker=TrackerConfig(enabled=True, max_tracks=40),
            geometry=dataclasses.replace(base.geometry, max_balls=100),
            planner=dataclasses.replace(base.planner, backend="tpu")),
    }
    for what, cfg in cases.items():
        for make in (lambda c: Engine(c, params={}, device="cuda"),
                     lambda c: MultiStreamEngine(c, 2, params={}, device="cuda")):
            try:
                make(cfg)
            except ValueError as e:
                if "D5" not in str(e):
                    raise AssertionError(f"{what}: refused without naming D5: {e}") from e
            else:
                raise AssertionError(f"{what}: the card took a configuration past its limit")
    log(f"  D5: {', '.join(cases)} refused on the card before anything loads (Engine and "
        f"MultiStreamEngine), each naming ROADMAP.md D, D5")


def artifact_path(torch, np, state, root, paths):
    """Phase 18: frozen artifacts (``tod_tpu_torch.deploy``) at the app's
    configuration (640x480 camera, model at 480x640, bf16): ``plan``,
    ``track_plan``, semantic ``plan`` and ``--int8`` ``plan`` exported on
    the card, each loaded and held against its eager engine over 8 frames
    bit for bit (the plan, and the bank of ``track_plan``) with the same
    launches a frame, and one frame under ``set_sync_debug_mode("error")``;
    then a ``--aot`` artifact booted by ``bench.boot --todx`` in a fresh
    process into an empty build directory (it must compile nothing), and
    ``python3 -m tod_tpu_torch.app --todx`` with one ``GetPath`` and one
    ``GetStat``."""
    import os
    import tempfile

    from tod_tpu_torch.core.config import (
        CameraConfig,
        ModelConfig,
        PipelineConfig,
        PlannerConfig,
        TrackerConfig,
    )
    from tod_tpu_torch.deploy import ServingArtifact, build_aot, export_engine, save_artifact
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    cam = CameraConfig(width=640, height=480)
    base = PipelineConfig(camera=cam, model=ModelConfig(input_size=(480, 640)),
                          planner=PlannerConfig(backend="tpu"))
    # (artifact mode, engine mode, configuration, the path's counters, the
    # kernels that must launch every frame)
    planner = ("connections", "relax", "path_walk", "bump")
    cases = (
        ("plan", "detect", base, paths["serving"], ("mask_assembly", *planner)),
        ("track_plan", "detect", base.replace(tracker=TrackerConfig(enabled=True)),
         paths["tracked"], ("track", "mask_assembly", *planner)),
        ("plan", "semantic", base, paths["semantic"], ("cc_labels", *planner)),
        ("plan", "detect", base.replace(model=ModelConfig(input_size=(480, 640), quantized=True)),
         paths["int8"], ("qconv", "mask_assembly", *planner)),
    )
    frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
              for f in SyntheticSource(cam, seed=0, n_frames=N_FRAMES + 1).frames()]
    (root / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="artifacts-", dir=root / "build")
    plan_art = None
    for amode, emode, cfg, counters, must in cases:
        what = f"{emode} {amode}" + (" --int8" if cfg.model.quantized else "")
        eng = Engine(cfg, state, device="cuda", mode=emode)
        t = time.time()
        exported, meta = export_engine(eng, amode)
        profiler_ops = sum("profiler" in str(n.target) for n in exported.graph.nodes)
        path = os.path.join(tmp, f"{emode}-{amode}{'-int8' if cfg.model.quantized else ''}.todx")
        save_artifact(exported, meta, path)
        export_s = time.time() - t
        t = time.time()
        art = ServingArtifact.load(path, device="cuda")
        load_s = time.time() - t
        tracked = amode == "track_plan"
        bank_a = art.init_tracks() if tracked else None
        bank_e = eng._init_tracks() if tracked else None
        run_a = (lambda f: art.call(f, bank_a)) if tracked else art.call  # noqa: E731
        run_e = ((lambda f: eng.serve_step_track_plan(f, bank_e)) if tracked
                 else eng.serve_step_plan)
        run_a(frames[0])  # warm-up
        run_e(frames[0])
        sync_checked(torch, lambda: run_a(frames[0]))
        if tracked:  # the warm-up and the sync check stepped the banks: start both afresh
            bank_a.zero_()
            bank_e.zero_()
        n_valid, each = [], []
        for f in frames[1:]:
            reset(counters)
            out_a = run_a(f)
            torch.cuda.synchronize()
            la = read(counters)
            reset(counters)
            out_e = run_e(f)
            torch.cuda.synchronize()
            le = read(counters)
            plan_a, plan_e = (out_a[0], out_e[0]) if tracked else (out_a, out_e)
            if not torch.equal(plan_a, plan_e) or (tracked and not torch.equal(bank_a, bank_e)):
                raise AssertionError(f"the {what} artifact disagrees with its eager engine")
            if la != le or min(la[name] for name in must) < 1:
                raise AssertionError(f"{what}: artifact launches {la}, eager {le}")
            each.append(la)
            n_valid.append(check_plan(np, plan_a.cpu().numpy(), cfg.planner.max_path_steps))
        if max(n_valid) == 0:
            raise AssertionError(f"no {what} artifact frame planned a path to a ball")
        log(f"  artifact {what}: exported in {export_s:.1f}s ({art.meta['payload_bytes']} payload "
            f"bytes, kernels {meta['kernels']}, {profiler_ops} profiler ops in the graph), "
            f"loaded in {load_s:.2f}s (stages {art.load_stages}); {N_FRAMES} frames equal to the "
            f"eager engine bit for bit{' (plans and banks)' if tracked else ''}, launches a frame "
            f"{each[0]} on both; one frame under set_sync_debug_mode('error'); plan n_valid "
            f"{n_valid}")
        if amode == "plan" and emode == "detect" and not cfg.model.quantized:
            blob, aot = build_aot(meta, eng.device)
            plan_art = os.path.join(tmp, "plan-aot.todx")
            save_artifact(exported, meta, plan_art, aot_blob=blob, aot_meta=aot)
        del eng, art

    empty = os.path.join(tmp, "empty-build")
    env = dict(os.environ, PYTHONPATH=str(root), TOD_BOOT_T0=repr(time.time()))
    r = subprocess.run([sys.executable, "-m", "tod_tpu_torch.bench.boot", "--todx", plan_art,
                        "--build-dir", empty, "--width", "640", "--height", "480"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=root)
    if r.returncode != 0:
        raise AssertionError(f"the aot boot failed (rc {r.returncode}): {r.stderr[-3000:]}")
    boot = json.loads(r.stdout.strip().splitlines()[-1])
    libs = sorted(p.name for p in pathlib.Path(empty).glob("*.so"))
    log(f"  --aot boot in a fresh process into an empty build directory: boot "
        f"{boot['boot']}, nvcc runs {boot['nvcc_built']}, boot to first plan "
        f"{boot['boot_to_first_plan_s']} s, stages {boot['stages_s']}; libraries written {libs}")
    if boot["boot"] != "todx-aot" or boot["nvcc_built"] or boot["first_path_len"] < 1:
        raise AssertionError(f"the aot boot compiled or fell short: {boot}")

    def talk(port):
        with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
            sock.sendall(b"GetPath")
            reply = read_reply(sock, 8)
            sock.settimeout(0.5)  # the rest of the path: f32 pairs until the server is quiet
            try:
                while chunk := sock.recv(65536):
                    reply += chunk
            except TimeoutError:
                pass
            sock.settimeout(120)
            sock.sendall(b"GetStat")
            stat = b""
            while len(stat) < 4 or len(stat) < 4 + int.from_bytes(stat[:4], "big"):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                stat += chunk
            return reply, json.loads(stat[4:])

    metrics, (reply, stat), secs = run_app(root, ["--todx", plan_art, "--frames", "16",
                                                  "--port", "0"], talk)
    log(f"  app --todx: rc 0 in {secs:.1f}s, n_frames={metrics['n_frames']}, fps="
        f"{metrics['fps']:.3f}, plans_done={metrics['plans_done']}, boot {metrics['boot']}; "
        f"GetPath {len(reply)} bytes, GetStat requests {stat['requests']}, boot "
        f"{stat.get('pipeline', {}).get('boot')}")
    if (metrics["n_frames"] != 16 or metrics["plans_done"] < 1 or metrics["boot"] != "aot"
            or stat["requests"]["GetPath"] != 1):
        raise AssertionError(f"the --todx app fell short: {metrics}")


TRAIN_HW, TRAIN_BATCH = (240, 320), 8  # bench config 11's size


def params_apart(torch, a, b) -> float:
    """The largest |a - b| over two trainers' parameters."""
    with torch.no_grad():
        return max(float((pa - pb).abs().max())
                   for pa, pb in zip(a.model.parameters(), b.model.parameters()))


def replay(batches):
    """A ``next_batch()`` source over a fixed list of batches."""
    class Replay:
        def __init__(self):
            self.it = iter(batches)

        def next_batch(self):
            return next(self.it)

    return Replay()


def train_path(torch, np, counters, root):
    """Phase 20: the default model trained at config 11's size (240x320,
    batch 8, ``TrainConfig(warmup_steps=2, total_steps=40)``) on the card."""
    import contextlib
    import io
    import tempfile

    from tod_tpu_torch import app
    from tod_tpu_torch.bench.configs import _mfu, train_flops
    from tod_tpu_torch.core.config import ModelConfig, TrainConfig
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer
    from tod_tpu_torch.train.trainer import device_batch, learning_rate

    dev = torch.device("cuda", 0)
    mcfg = ModelConfig(input_size=TRAIN_HW)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, warmup_steps=2, total_steps=40)
    quiet = dict(log_every=10**9, log_fn=lambda *_: None)

    def trainer():
        return Trainer(mcfg, tcfg, device="cuda")

    # 1. 20 steps on one fixed batch; one of them under the sync check
    t = time.time()
    tr = trainer()
    fixed = device_batch(SyntheticDetectionData(TRAIN_HW, batch_size=TRAIN_BATCH,
                                                seed=3).next_batch(), dev)
    first, enqueue_ms = sync_checked(torch, lambda: tr.train_step(fixed))
    losses = [first["loss"]] + [tr.train_step(fixed)["loss"] for _ in range(19)]
    losses = [float(v) for v in losses]
    log(f"  1. 20 steps on one batch: loss {[round(v, 4) for v in losses]}; one step under "
        f"set_sync_debug_mode('error') enqueued in {enqueue_ms:.2f} ms, no host sync "
        f"({time.time() - t:.1f}s)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over 20 steps on one batch: {losses}")

    # 2. per step against chunk=4 over the same 8 batches
    src = SyntheticDetectionData(TRAIN_HW, batch_size=TRAIN_BATCH, seed=5)
    batches = [src.next_batch() for _ in range(8)]
    per_step, chunked = trainer(), trainer()
    per_step.train(replay(batches), steps=8, chunk=1, **quiet)
    chunked.train(replay(batches), steps=8, chunk=4, **quiet)
    # Adam moves an element at most ~lr a step, so two runs apart by rounding
    # noise alone stay within twice the summed learning rates
    bound = 2 * sum(learning_rate(tcfg, c) for c in range(8))
    worst = params_apart(torch, per_step, chunked)
    verdict = "bit for bit" if worst == 0.0 else f"largest |difference| {worst:.3e}"
    log(f"  2. 8 steps per step against chunk=4: {verdict} (tolerance {bound:.3e}, twice the "
        f"summed learning rates)")
    if worst > bound:
        raise AssertionError(f"chunk=4 strayed from per-step training: {worst} > {bound}")

    # 3. save_state at step 4, load_state in a fresh trainer, 4 more steps
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        state = pathlib.Path(tmp) / "state.pt"
        first_half = trainer()
        first_half.train(replay(batches[:4]), steps=4, **quiet)
        first_half.save_state(state)
        resumed = trainer()
        resumed.load_state(state)
        if resumed.step != 4 or resumed.opt.count != 4:
            raise AssertionError(f"resumed at step {resumed.step}, count {resumed.opt.count}")
        resumed.train(replay(batches[4:]), steps=4, **quiet)
    worst = params_apart(torch, per_step, resumed)
    verdict = "bit for bit" if worst == 0.0 else f"largest |difference| {worst:.3e}"
    log(f"  3. save_state at 4, load_state, 4 more against 8 uninterrupted: {verdict} "
        f"(tolerance {bound:.3e})")
    if worst > bound:
        raise AssertionError(f"the resumed run strayed: {worst} > {bound}")

    # 4. one in-training evaluation, the serving kernels' launches
    t = time.time()
    reset(counters)
    ev = tr.evaluate(n_scenes=4, plan=True)
    launches = read(counters)
    log(f"  4. evaluate on 4 held-out scenes with plans ({time.time() - t:.1f}s): map50 "
        f"{ev['map50']}, sem_iou {ev['sem_iou']}, plans_found {ev['plans_found']}; launches "
        f"{launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"evaluate launched no {missing}")

    # 5. the trained weights served by the app through --checkpoint
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        npz = pathlib.Path(tmp) / "trained.npz"
        tr.save(npz)
        out = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(out):
            rc = app.main(["--checkpoint", str(npz), "--source", "synthetic", "--frames", "2",
                           "--plan-every", "1", "--no-server", "--metrics-json"])
        metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  5. app --checkpoint trained.npz: rc {rc}, {metrics.get('n_frames')} frames, "
        f"plans_done {metrics.get('plans_done')} ({time.time() - t:.1f}s)")
    if rc != 0 or not metrics.get("plans_done"):
        raise AssertionError(f"the app did not plan from the trained checkpoint: {metrics}")

    # 6. the step's time by CUDA events, images/s, FLOPs and mfu
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_step(fixed)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in times)
    flops = train_flops(tr, fixed)
    mfu = _mfu(flops, step_ms / 1e3, dev)
    log(f"  6. train step at batch {TRAIN_BATCH}, {TRAIN_HW[0]}x{TRAIN_HW[1]}: median "
        f"{step_ms:.3f} ms of 20 by CUDA events, {TRAIN_BATCH / step_ms * 1e3:.1f} images/s, "
        f"{flops / 1e9:.2f} GFLOPs (FlopCounterMode, forward and backward), mfu {mfu} "
        f"(bf16 peak), {nvidia_smi_line()}")
    return step_ms


def resnet_path(torch, np, counters):
    """Phase 19: the ResNet backbones (M13) on seeded init weights: the
    ResNet18 and ResNet50 forwards at batch 16, VGA, bf16 (chained step ms
    and images/s); each against the CPU in f32 (TF32 off) at 64x64; then one
    ResNet18 ``--int8`` frame at 480x640 through ``Engine.serve_step_plan``
    with its launches (``qconv`` once per static conv call).  Returns the
    stem's launches: the rise of ``qconv``'s counter across the 7x7 stem
    site's forward in that frame."""
    from tod_tpu_torch.bench.configs import _forward_point, _model, model_state
    from tod_tpu_torch.core.config import CameraConfig, ModelConfig, PipelineConfig
    from tod_tpu_torch.models.qconv import conv_sites
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    for backbone in ("resnet18", "resnet50"):
        mcfg = ModelConfig(backbone=backbone, input_size=(480, 640))
        point = _forward_point(_model(mcfg, torch.device("cuda")), 16, (480, 640), 16,
                               torch.device("cuda"))
        log(f"  {backbone} forward batch 16 480x640 bf16: step {point['step_ms']} ms, "
            f"{point['images_per_s']} images/s, {point['step_gflops']} GFLOPs, mfu "
            f"{point['mfu']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for backbone in ("resnet18", "resnet50"):
        mcfg = ModelConfig(backbone=backbone, input_size=(64, 64), dtype="float32")
        x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
        with torch.inference_mode():
            card = _model(mcfg, torch.device("cuda"))(x.cuda())
            cpu = _model(mcfg, torch.device("cpu"))(x)
        worst = {f: ((getattr(card, f).cpu() - getattr(cpu, f)).abs().max().item(),
                     getattr(cpu, f).abs().max().item())
                 for f in ("loc", "conf", "coeff", "prototypes", "sem_logits")}
        log(f"  {backbone} f32 64x64 card vs CPU (max abs diff, max |value|): "
            + ", ".join(f"{f} ({d:.3g}, {v:.3g})" for f, (d, v) in worst.items())
            + " (tol 1e-3 of the max |value|)")
        if any(d > 1e-3 * max(v, 1.0) for d, v in worst.values()):
            raise AssertionError(f"{backbone} on the card and on the CPU disagree")
    mcfg = ModelConfig(backbone="resnet18", input_size=(480, 640), quantized=True)
    cfg = PipelineConfig(camera=CameraConfig(width=640, height=480), model=mcfg)
    eng = Engine(cfg, model_state(ModelConfig(backbone="resnet18", input_size=(480, 640))),
                 device="cuda")
    frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
              for f in SyntheticSource(cfg.camera, seed=0, n_frames=2).frames()]
    eng.serve_step_plan(frames[0])
    stem = conv_sites(eng.model)["ResNet_0.Conv_0"]
    # "stem": the qconv launches counted while the stem site's forward runs
    calls = {"static": 0, "stem": 0, "before_stem": 0}
    hooks = [m.register_forward_hook(lambda *_: calls.__setitem__("static", calls["static"] + 1))
             for m in conv_sites(eng.model).values() if m.branch == "static"]
    hooks.append(stem.register_forward_pre_hook(
        lambda *_: calls.__setitem__("before_stem", counters["qconv"].launches)))
    hooks.append(stem.register_forward_hook(lambda *_: calls.__setitem__(
        "stem", calls["stem"] + counters["qconv"].launches - calls["before_stem"])))
    torch.cuda.synchronize()
    reset(counters)
    buf = eng.serve_step_plan(frames[1]).cpu().numpy()
    launches = read(counters)
    for h in hooks:
        h.remove()
    n_valid = check_plan(np, buf, cfg.planner.max_path_steps)
    log(f"  ResNet18 --int8 frame 640x480: launches {launches} ({calls['static']} static int8 "
        f"conv calls; the 7x7 stem site launched qconv {calls['stem']} time(s), {stem.branch}, "
        f"k {stem.k}), plan n_valid {n_valid}")
    if (launches["qconv"] != calls["static"] or calls["stem"] != 1 or stem.branch != "static"
            or min(launches.values()) < 1):
        raise AssertionError(f"the ResNet18 int8 frame's launches {launches}, calls {calls}")
    return calls["stem"]


def reset(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def check_plan(np, buf, steps) -> int:
    """Raise unless ``buf`` is a well-formed plan buffer; returns n_valid."""
    n = int(buf[0, 0])
    if buf.shape != (steps + 1, 2) or not np.isfinite(buf).all() or not 0 <= n <= steps:
        raise AssertionError(f"malformed plan buffer: shape {buf.shape}, n {n}")
    if np.any(buf[1 + n :] != 0):
        raise AssertionError("plan rows past n_valid are not zero")
    return n


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
    plan, enqueue_ms = sync_checked(torch, lambda: eng.serve_step_plan(frames[1]))
    t = time.perf_counter()
    check_plan(np, plan.cpu().numpy(), cfg.planner.max_path_steps)
    log(f"  one frame under set_sync_debug_mode('error'): no host synchronisation; "
        f"enqueued in {enqueue_ms:.2f} ms, plan on the host {1e3 * (time.perf_counter() - t):.2f} "
        f"ms later, {eng.last_sweeps} sweeps")

    reset(counters)
    per_frame, sweeps, n_valid = [], [], []
    plan = None
    for packed in frames[1:]:
        t = time.perf_counter()
        plan = eng.serve_step_plan(packed)
        buf = plan.cpu().numpy()
        per_frame.append(1e3 * (time.perf_counter() - t))
        sweeps.append(eng.last_sweeps)
        n_valid.append(check_plan(np, buf, cfg.planner.max_path_steps))
    launches = read(counters)
    stage_profile(torch, eng, frames[1], counters)
    log(f"  ms per frame: {[round(x, 2) for x in per_frame]} "
        f"(median {statistics.median(per_frame):.2f})")
    log(f"  relaxation sweeps: {sweeps}")
    log(f"  plan n_valid: {n_valid}")
    log(f"  launches over {N_FRAMES} frames: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if launches["bump"] != N_FRAMES:
        raise AssertionError(f"the terrain dilation kernel ran {launches['bump']} times in "
                             f"{N_FRAMES} frames, not once a frame")
    if max(n_valid) == 0:
        raise AssertionError("no frame produced a path to a ball")
    return Path.from_plan(plan), launches, statistics.median(per_frame), eng, frames


def union_us(spans) -> float:
    """The length of the union of sorted (start, end) intervals: the
    device's busy time."""
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


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
    busy_us = union_us(spans)
    if not spans:
        log(f"  stage profile: the profiler recorded no device activity; device times "
            f"not measured (frame {wall_ms:.2f} ms under the profiler)")
        return
    rows = {name: (round(e.device_time_total / 1e3, 3), round(e.cpu_time_total / 1e3, 3))
            for name, e in stages.items()}
    named = {"cc_labels": CC_PARTS, "track": (TRACK_KERNEL,)}
    parts = {name: named.get(name, (f"{name}_kernel",)) for name in kernel_names}
    ours = {name: round(sum(e.time_range.elapsed_us() for e in events
                            if e.device_type == DeviceType.CUDA
                            and any(part in e.name for part in parts[name])) / 1e3, 4)
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
            f"plan equal={plan_eq} (turns tol 1e-6; n={int(plans['cpu'][0][0, 0])}, sweeps "
            f"{int(plans['cuda'][1])} on the card, {int(plans['cpu'][1])} on the CPU)")
        if not (err <= 2e-3 and same_valid and box_err <= 1e-5 and cls_diff <= 1e-3
                and h_diff <= 5e-3 and b_err <= 1e-3 and plan_eq
                and int(plans["cuda"][1]) == int(plans["cpu"][1])):
            raise AssertionError(f"card and CPU disagree on frame t={t}")


def bump_reference_check(torch, np):
    """The occupancy map on the card against the CPU's, exactly, with
    ``pallas_bump`` (K3's strips, 128 rows) and without (K4's whole map),
    each with its one launch of the terrain kernel; class maps by colour on
    the synthetic frames."""
    from tod_tpu_torch.core.config import CameraConfig, GeometryConfig
    from tod_tpu_torch.geometry.fusion import occupancy_map
    from tod_tpu_torch.kernels.bump import dilate_peaks, dilate_peaks_strips
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    cam = CameraConfig(width=160, height=128)
    for pallas_bump, entry in ((True, dilate_peaks_strips), (False, dilate_peaks)):
        geom = GeometryConfig(pallas_bump=pallas_bump)
        for t in (0, 7):
            f = synth_frame_numpy(0, t, cam.height, cam.width)
            depth = torch.from_numpy(f.depth.astype(np.int32))
            cls = torch.from_numpy(color_class_map(np, f.rgb))
            counts = dilate_peaks_strips.launches, dilate_peaks.launches
            card = occupancy_map(depth.cuda(), cls.cuda(), cam, geom).cpu()
            launched = (dilate_peaks_strips.launches - counts[0], dilate_peaks.launches - counts[1])
            host = occupancy_map(depth, cls, cam, geom)
            vs_cpu = int((card != host).sum())
            log(f"  occupancy pallas_bump={pallas_bump} t={t} {tuple(card.shape)}: launches "
                f"(strips, whole map)={launched}, heights differing card vs CPU={vs_cpu} (tol "
                f"exact), positive heights={int((host > 0).sum())}")
            want = (1, 0) if entry is dilate_peaks_strips else (0, 1)
            if launched != want or vs_cpu:
                raise AssertionError(f"the occupancy map with pallas_bump={pallas_bump} "
                                     f"disagrees on frame t={t}")


def fusion_profile(torch, eng, packed) -> tuple[float, float, float]:
    """(device ms, host ms) of the ``stage/fusion`` range of one profiled
    ``serve_step_scene`` call, and the device ms of the terrain kernel, which
    is launched through ctypes and lands under no range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.serve_step_scene(packed)
        torch.cuda.synchronize()
    events = prof.events()
    kernel = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == DeviceType.CUDA and "bump_kernel" in e.name) / 1e3
    for e in events:
        if e.name == "stage/fusion" and e.device_type == DeviceType.CPU:
            return (round(e.device_time_total / 1e3, 4), round(e.cpu_time_total / 1e3, 3),
                    round(kernel, 4))
    raise AssertionError("the profiler recorded no stage/fusion range")


def streaming(torch, np, state, counters, k4):
    """The app's configuration with ``pallas_bump``: ``run_supervised`` over
    16 synthetic frames, a plan every 4th, 2 in flight; then the fusion stage
    of one frame with K3's strips and with K4's whole map; then K4 as a
    library call on the terrain peaks of 4 frames, against the plain ring
    loop on the same peaks."""
    from tod_tpu_torch.core.config import GeometryConfig, ModelConfig, PipelineConfig
    from tod_tpu_torch.kernels.bump import plain_dilate_peaks
    from tod_tpu_torch.models.yolact import detect
    from tod_tpu_torch.ops.preprocess import pack_frame, preprocess_frame, unpack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.serve.server import PathStore

    cfg = PipelineConfig(model=ModelConfig(input_size=(480, 640)),
                         geometry=GeometryConfig(pallas_bump=True))
    eng = Engine(cfg, state, device="cuda")
    log(f"  engine: camera {cfg.camera.width}x{cfg.camera.height}, model input "
        f"{cfg.model.input_size} {cfg.model.dtype}, pallas_bump={cfg.geometry.pallas_bump}, "
        f"warm-up {eng.warmup():.2f}s {eng.warmup_breakdown}")
    store = PathStore()
    reset(counters)
    m = eng.run_supervised(lambda: SyntheticSource(cfg.camera, n_frames=STREAM_FRAMES),
                           n_frames=STREAM_FRAMES, path_store=store, max_restarts=3,
                           stall_timeout_s=10.0, plan_every=4, max_inflight=2, warmup=False)
    launches = read(counters)
    stages = m["stages"]
    p50 = {k: round(v["p50_ms"], 3) for k, v in stages.items() if v.get("n")}
    path = store.get()
    log(f"  {m['n_frames']} frames: fps={m['fps']:.3f}, plans_done={m['plans_done']}, "
        f"restarts={m['restarts']}, published path {len(path.directions)} directions")
    log(f"  stage p50 ms: {p50} (frame = batch mean; plan = the planner thread's wait "
        f"and decode; dispatch_plan / dispatch_scene = the loop thread in each step)")
    if "dispatch_plan" in p50:
        log(f"  dispatch_plan p50 / dispatch_scene p50 = "
            f"{p50['dispatch_plan'] / p50['dispatch_scene']:.3f} (a planning frame holds the "
            f"loop's thread no longer than a scene frame when near 1)")
    log(f"  launches over {STREAM_FRAMES} frames: {launches}")
    if m["n_frames"] != STREAM_FRAMES or m["plans_done"] < 4 or not path.directions:
        raise AssertionError(f"streaming run fell short: {m['n_frames']} frames, "
                             f"{m['plans_done']} plans, {len(path.directions)} directions")
    if launches["bump_strips"] != STREAM_FRAMES or min(launches.values()) == 0:
        raise AssertionError(f"kernels not launched as expected on the streaming path: {launches}")

    frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
              for f in SyntheticSource(cfg.camera, seed=0, n_frames=4).frames()]
    whole_eng = Engine(cfg.replace(geometry=GeometryConfig()), state, device="cuda")
    whole_eng.serve_step_scene(frames[0])
    rows = {}
    for name, e in (("K3 strips", eng), ("K4 whole map", whole_eng), ("K3 strips again", eng),
                    ("K4 whole map again", whole_eng)):
        rows[name] = fusion_profile(torch, e, frames[1])
    log(f"  stage/fusion of one frame, (range device ms, range host ms, terrain kernel device "
        f"ms): {rows}")

    cam, geom = cfg.camera, cfg.geometry
    reset(k4)
    diffs = []
    with torch.inference_mode():
        for packed in frames:
            rgb, depth = unpack_frame(packed.cuda(), (cam.height, cam.width))
            dets = detect(eng.model(preprocess_frame(rgb, cfg.model.input_size, eng.dtype)),
                          cfg.model, eng.anchors, out_hw=(cam.height, cam.width))
            peaks = terrain_peaks(torch, np, depth, dets.class_map, cam, geom)
            shape = (cam.height, cam.width)
            whole = k4["bump"](peaks, geom.terrain_norm_const, geom.bump_err, shape)
            diffs.append(int((whole != plain_dilate_peaks(peaks, geom.terrain_norm_const,
                                                          geom.bump_err, shape)).sum()))
    k4_launches = read(k4)
    log(f"  K4 on the terrain peaks of {len(frames)} streamed frames: launches {k4_launches}, "
        f"values differing from the plain ring loop {diffs} (tol exact)")
    if any(diffs) or k4_launches["bump"] != len(frames):
        raise AssertionError("K4 disagrees with the ring loop on the streamed frames")
    return launches, m


def app_subprocess(root) -> None:
    """``python3 -m tod_tpu_torch.app`` over 16 frames with its defaults,
    one ``GetStat`` through the port it logs while it runs."""
    cmd = [sys.executable, "-m", "tod_tpu_torch.app", "--source", "synthetic", "--frames",
           str(STREAM_FRAMES), "--port", "0", "--metrics-json"]
    t = time.time()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        port, seen = None, []
        for line in proc.stderr:
            seen.append(line)
            if "path server on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        if port is None:
            raise AssertionError("the app never logged its port:\n" + "".join(seen[-20:]))
        with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
            sock.sendall(b"GetStat")
            data = b""
            while len(data) < 4 or len(data) < 4 + int.from_bytes(data[:4], "big"):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
        stat = json.loads(data[4:])
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the app exited {proc.returncode}:\n{err[-3000:]}")
    metrics = json.loads(out.strip().splitlines()[-1])
    log(f"  {' '.join(cmd[1:])}: rc 0 in {time.time() - t:.1f}s; GetStat on port {port}: "
        f"requests {stat['requests']}, pipeline keys {sorted(stat.get('pipeline', {}))}")
    log(f"  app metrics: n_frames={metrics['n_frames']}, fps={metrics['fps']:.3f}, "
        f"plans_done={metrics['plans_done']}, last_path_len={metrics['last_path_len']}, "
        f"compile_s={metrics['compile_s']:.2f}, restarts={metrics['restarts']}")
    if metrics["n_frames"] != STREAM_FRAMES or "pipeline" not in stat:
        raise AssertionError("the app served the wrong number of frames or GetStat lacks metrics")


def ptq(torch, np, f32_engine, frames, counters):
    """Weight-only int8: the pinned tree quantized with K5 (stochastic, seed
    0), dequantized, carried across and served for 4 frames."""
    from tod_tpu_torch.core.weights import carry_across, read_tree
    from tod_tpu_torch.models.yolact import Yolact
    from tod_tpu_torch.ops.quantize import dequantize_params, quantize_params, quantized_size_bytes
    from tod_tpu_torch.runtime.engine import Engine

    tree = read_tree()
    cfg = f32_engine.cfg
    reset(counters)
    t = time.time()
    qtree = quantize_params(tree, stochastic=True, seed=0)
    torch.cuda.synchronize()
    q_s = time.time() - t
    state = carry_across(dequantize_params(qtree), Yolact(cfg.model))
    eng = Engine(cfg, state, device="cuda")
    n_kernels = sum(isinstance(v, dict) for v in qtree.values())
    worst, share, n_valid = 0.0, [], []
    for packed in frames[1:5]:
        n_valid.append(check_plan(np, eng.serve_step_plan(packed).cpu().numpy(),
                                  cfg.planner.max_path_steps))
        h8, _ = eng.serve_step_scene(packed)
        h32, _ = f32_engine.serve_step_scene(packed)
        worst = max(worst, (h8 - h32).abs().max().item())
        share.append(round((h8 != h32).float().mean().item(), 6))
    launches = read(counters)
    f32_bytes = sum(np.asarray(v).nbytes for v in tree.values())
    log(f"  quantized {n_kernels} kernels in {q_s:.3f}s; {quantized_size_bytes(qtree)} bytes "
        f"against {f32_bytes} in f32; plans n_valid {n_valid}; largest height difference "
        f"against the f32 weights {worst}, share of heights differing {share}; "
        f"launches {launches}")
    if launches["quantize"] != n_kernels or min(launches.values()) == 0:
        raise AssertionError(f"kernels not launched as expected on the PTQ path: {launches}")
    return launches


def host_planner(torch, np, state, counters):
    """The host-planner mode on the card: the default configuration with the
    native planner, 8 frames through ``run_supervised``, every frame planned
    on the host from its f16 height and balls."""
    from tod_tpu_torch.core.config import PipelineConfig, PlannerConfig
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.serve.server import PathStore

    cfg = PipelineConfig(planner=PlannerConfig(backend="native"))
    eng = Engine(cfg, state, device="cuda")
    if eng._plan_on_device_mode:
        raise AssertionError("backend='native' selected the device planner")
    store = PathStore()
    warm_s = eng.warmup()  # the first frame's cuDNN plans and the planner's choice
    reset(counters)
    m = eng.run_supervised(lambda: SyntheticSource(cfg.camera, n_frames=N_FRAMES),
                           n_frames=N_FRAMES, path_store=store, max_restarts=0,
                           stall_timeout_s=10.0, plan_every=1, max_inflight=2, warmup=False)
    launches = read(counters)
    path = store.get()
    dirs = np.asarray(path.directions, np.float64).reshape(-1, 2)
    stages = {k: round(v["p50_ms"], 3) for k, v in m["stages"].items() if v.get("n")}
    log(f"  {m['n_frames']} frames: fps={m['fps']:.3f}, plans_done={m['plans_done']}, "
        f"warm-up {warm_s:.2f}s {eng.warmup_breakdown}, published path {len(dirs)} directions "
        f"(magnitudes sum {dirs[:, 0].sum():.3f}); stage p50 ms {stages}; launches {launches}")
    well_formed = (len(dirs) > 0 and np.isfinite(dirs).all() and (dirs[:, 0] > 0).all()
                   and (np.abs(dirs[:, 1]) <= np.pi + 1e-6).all())
    if m["n_frames"] != N_FRAMES or m["plans_done"] < 1 or not well_formed:
        raise AssertionError(f"host-planner run fell short: {m['n_frames']} frames, "
                             f"{m['plans_done']} plans, {len(dirs)} directions")
    if (launches["mask_assembly"] != N_FRAMES or launches["bump"] != N_FRAMES
            or launches["relax"] or launches["path_walk"]):
        raise AssertionError(
            f"kernels not launched as expected on the host-planner path: {launches}")
    return launches


def bench_phase(torch, np, counters) -> None:
    """Phase 12: ``fuse_scene_batch`` exact on the card, then the bench's
    configs and headline at reduced counts through the serve path's
    kernels, each line's fields held."""
    from tod_tpu_torch.bench import configs, headline
    from tod_tpu_torch.geometry.fusion import fuse_scene, fuse_scene_batch

    t = time.time()
    cfg = configs._pipeline_cfg()
    cam, geom = cfg.camera, cfg.geometry
    maps = [torch.from_numpy(a) for a in configs.fusion_inputs(8, (cam.height, cam.width))]
    maps[0] = maps[0].to(torch.int32)
    card = [m.cuda() for m in maps]
    fields = ("height", "pos", "balls", "connections")
    reset(counters)
    batch = fuse_scene_batch(*card, cam, geom)
    launches = read(counters)
    if launches["bump"] != 8 or launches["connections"] != 8:
        raise AssertionError(f"fuse_scene_batch at batch 8 did not launch K4 and K2 once a "
                             f"map: {launches}")
    for j in range(8):
        one = fuse_scene(*(m[j] for m in card), cam, geom)
        for f in fields:
            if not torch.equal(getattr(batch, f)[j], getattr(one, f)):
                raise AssertionError(f"fuse_scene_batch {f}[{j}] differs from fuse_scene")
    cpu = fuse_scene_batch(*(m[:2] for m in maps), cam, geom)
    for f in fields:
        if not torch.equal(getattr(batch, f)[:2].cpu(), getattr(cpu, f)):
            raise AssertionError(f"fuse_scene_batch {f} on the card differs from the CPU")
    log(f"  fuse_scene_batch (8, {cam.height}, {cam.width}): equal to fuse_scene frame by "
        f"frame, bit for bit, and at batch 2 to the CPU; launches {launches}")

    dev = torch.device("cuda", 0)
    reset(counters)
    lines = [configs.run_config(2, dev, n=10), configs.run_config(3, dev, n=10),
             configs.run_config(4, dev, n=10), configs.run_config(7, dev, k=8),
             configs.run_config(14, dev, k=4),
             configs.run_config(16, dev, n_ticks=8, k=4, sweep=(4,)),
             configs.run_config(19, dev, k=4, n_frames=16, ms_k=4),
             configs.run_config(10, dev, k=4), configs.run_config(13, dev, k=4)]
    lines.append(headline.measure(dev, n_frames=40, runs=1, bounded_runs=1, k=16))
    launches = read(counters)
    for line in lines:
        log("  " + json.dumps(line))
    if [n for n, c in launches.items() if c == 0]:
        raise AssertionError(f"kernels never launched on the bench path: {launches}")
    head = lines[-1]
    mfus = [lines[3]["mfu"], lines[8]["mfu"], head["mfu"],
            *(p["mfu"] for p in lines[4]["curve"])]
    problems = [
        *(f"{line.get('config', 'headline')}: value {line['value']}" for line in lines
          if not line["value"] > 0),
        *(f"no device name in {line['metric']}" for line in lines
          if not line["device"].get("name")),
        *(f"mfu {m} not in (0, 1]" for m in mfus if m is None or not 0 < m <= 1),
        # configs 16 and 19: the device's busy time beside each chained time
        *(f"config 16 device_tick_ms {r['device_tick_ms']}" for r in lines[5]["sweep"]
          if not r["device_tick_ms"] > 0),
        *(f"config 19 {hw} {f} {row[f]}" for hw, row in lines[6]["steps"].items()
          for f in ("plan_step_busy_ms", "track_step_busy_ms", "track_mem_step_busy_ms")
          if not row[f] > 0),
        *(f"config 19 multistream {f} {lines[6]['multistream_tracked'][f]}"
          for f in ("tick_busy_ms", "tick_tracked_busy_ms")
          if not lines[6]["multistream_tracked"][f] > 0),
        # config 10: both modes' chained and busy times
        *(f"config 10 {f} {lines[7][f]}" for f in ("bf16_step_ms", "int8_step_ms", "bf16_busy_ms",
                                                   "int8_busy_ms") if not lines[7][f] > 0),
    ]
    if not head["fps_e2e_320x240_b1"] > 0 or not head["bounded_fps"] > 0:
        problems.append(f"headline fps {head['fps_e2e_320x240_b1']}, {head['bounded_fps']}")
    if head["idle_share"] is None or not 0 <= head["idle_share"] <= 1:
        problems.append(f"idle_share {head['idle_share']}")
    if head["profiled"]["timeline"] != "cuda":
        problems.append(f"idle_share read from the {head['profiled']['timeline']} timeline")
    if not head["boot_cold_s"] > head["boot_warm_s"] > 0:
        problems.append(f"boot cold {head['boot_cold_s']} s, warm {head['boot_warm_s']} s")
    if problems:
        raise AssertionError("bench lines out of range: " + "; ".join(problems))
    log(f"  bench launches {launches}; boot cold {head['boot_cold_s']} s "
        f"{head['boot_cold_stages']}, warm {head['boot_warm_s']} s {head['boot_warm_stages']}")
    log(f"  phase 12 took {time.time() - t:.1f}s")


def semantic_path(torch, np, state, counters):
    """Phase 13: ``Engine(mode="semantic")`` at the app's configuration
    (640x480 camera, model at 480x640, bf16, pinned weights): one
    ``serve_step_plan`` frame under ``set_sync_debug_mode("error")``, then 8
    frames with the path's launch counts (the cc kernel and K4 once a frame,
    K1 never); the cc kernel on a served frame's real ball mask against its
    plain version and scipy; a card-against-CPU check in f32 with TF32 off."""
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    cfg = PipelineConfig(model=ModelConfig(input_size=(480, 640)))
    eng = Engine(cfg, state, device="cuda", mode="semantic")
    frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
              for f in SyntheticSource(cfg.camera, seed=0, n_frames=N_FRAMES + 1).frames()]
    t = time.time()
    eng.serve_step_plan(frames[0])
    torch.cuda.synchronize()
    log(f"  engine: mode semantic, camera {cfg.camera.width}x{cfg.camera.height}, model input "
        f"{cfg.model.input_size} {cfg.model.dtype}; warm-up frame {1e3 * (time.time() - t):.1f} ms")
    plan, enqueue_ms = sync_checked(torch, lambda: eng.serve_step_plan(frames[1]))
    check_plan(np, plan.cpu().numpy(), cfg.planner.max_path_steps)
    log(f"  one semantic frame under set_sync_debug_mode('error'): no host synchronisation; "
        f"enqueued in {enqueue_ms:.2f} ms")
    reset(counters)
    per_frame, n_valid, balls = [], [], []
    for packed in frames[1:]:
        t = time.perf_counter()
        buf = eng.serve_step_plan(packed).cpu().numpy()
        per_frame.append(1e3 * (time.perf_counter() - t))
        n_valid.append(check_plan(np, buf, cfg.planner.max_path_steps))
    launches = read(counters)
    with torch.inference_mode():
        _, dets = eng._step(frames[1])
    ball_mask = (dets.class_map == 3).cpu().numpy()
    hold_cc(torch, np, ball_mask, "served frame's ball mask")
    stage_profile(torch, eng, frames[1], counters)
    log(f"  ms per semantic frame: {[round(x, 2) for x in per_frame]} "
        f"(median {statistics.median(per_frame):.2f}); plan n_valid {n_valid}; ball pixels "
        f"{int(ball_mask.sum())}, ids {int(dets.id_map.max()) + 1}")
    log(f"  launches over {N_FRAMES} semantic frames: {launches}")
    if launches["cc_labels"] != N_FRAMES or launches["bump"] != N_FRAMES:
        raise AssertionError(f"the cc kernel and K4 did not run once a frame: {launches}")
    if launches["mask_assembly"] or min(launches[k] for k in ("connections", "relax",
                                                              "path_walk")) == 0:
        raise AssertionError(f"kernels not launched as expected on the semantic path: {launches}")
    if max(n_valid) == 0 or not ball_mask.any():
        raise AssertionError("no semantic frame saw a ball or produced a path to one")
    semantic_reference_check(torch, np, state)
    return launches, statistics.median(per_frame)


def semantic_reference_check(torch, np, state):
    """``Engine._step``'s semantic branch at the app's configuration (640x480
    camera, model at 480x640), f32 with TF32 off, on the card against the
    CPU: the class maps with their share of differing pixels bounded; the
    card's id map exact against the CPU's labelling of the card's class map,
    and against the CPU engine's id map where the two class maps agree."""
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig
    from tod_tpu_torch.ops.cc_labels import connected_components
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PipelineConfig(model=ModelConfig(input_size=(480, 640), dtype="float32"))
    cam_hw = (cfg.camera.height, cfg.camera.width)
    engines = {d: Engine(cfg, state, device=d, mode="semantic") for d in ("cpu", "cuda")}
    for t in (0, 7):
        f = synth_frame_numpy(0, t, *cam_hw)
        packed = torch.from_numpy(pack_frame(f.rgb, f.depth))
        with torch.inference_mode():
            dets = {d: e._step(packed)[1] for d, e in engines.items()}
        cls = {d: x.class_map.cpu() for d, x in dets.items()}
        ids = {d: x.id_map.cpu() for d, x in dets.items()}
        shapes_ok = all(tuple(c.shape) == cam_hw for c in (*cls.values(), *ids.values()))
        diff = (cls["cuda"] != cls["cpu"]).float().mean().item()
        mask = cls["cuda"] == 3
        # the card's ids against the CPU's labelling of the card's class map
        own_ids = torch.equal(ids["cuda"], connected_components(mask, cfg.geometry.max_balls))
        # against the CPU engine's ids, where the class maps agree
        same_cls = torch.equal(cls["cuda"], cls["cpu"])
        engine_ids = torch.equal(ids["cuda"], ids["cpu"]) if same_cls else None
        log(f"  semantic Engine._step t={t} at {cam_hw}: class-map pixels differing card vs CPU="
            f"{diff:.2e} (tol 1e-3), ball pixels {int(mask.sum())}, "
            f"{int(ids['cuda'].max()) + 1} ids; card ids equal to the CPU's labelling of the "
            f"card's class map={own_ids} (tol exact); equal to the CPU engine's ids="
            f"{'not compared (class maps differ)' if engine_ids is None else engine_ids} "
            f"(tol exact)")
        if not (shapes_ok and diff <= 1e-3 and own_ids and engine_ids is not False
                and mask.any()):
            raise AssertionError(f"semantic card and CPU disagree on frame t={t}")


def run_app(root, args, talk=None, cwd=None, timeout=300):
    """``python3 -m tod_tpu_torch.app ARGS --metrics-json`` as a
    subprocess; with ``talk``, ``talk(port)`` once it logs its server's
    port.  Returns (metrics, talk's answer, seconds)."""
    import os

    cmd = [sys.executable, "-m", "tod_tpu_torch.app", *args, "--metrics-json"]
    env = dict(os.environ, PYTHONPATH=str(root))
    t = time.time()
    proc = subprocess.Popen(cmd, cwd=cwd or root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        answer, seen = None, []
        if talk is not None:
            port = None
            for line in proc.stderr:
                seen.append(line)
                if "path server on" in line:
                    port = int(line.rsplit(":", 1)[1])
                    break
            if port is None:
                raise AssertionError("the app never logged its port:\n" + "".join(seen[-20:]))
            answer = talk(port)
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the app exited {proc.returncode}:\n{(''.join(seen) + err)[-3000:]}")
    return json.loads(out.strip().splitlines()[-1]), answer, time.time() - t


def semantic_apps(root, np) -> float:
    """Phase 14: the app in semantic mode on the native ring with a token,
    and a client that authenticates, then sends GetPath and GetStat; then
    the app on a PNG (written by the port's own PNG writer) with
    ``--checkpoint`` (the pinned npz) and ``--debug-dump`` in a temporary
    directory, whose BMPs must exist."""
    import tempfile

    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy
    from tod_tpu_torch.utils.image_io import save_rgb

    token = b"chip-smoke-token"

    def talk(port):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
            sock.sendall(b"AuthTok" + len(token).to_bytes(4, "big") + token + b"GetPath")
            data = b""
            while len(data) < 10:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
            if data[:2] != b"OK":
                raise AssertionError(f"AuthTok answered {data[:2]!r}")
            sock.sendall(b"GetStat")
            stat = b""
            while len(stat) < 4 or len(stat) < 4 + int.from_bytes(stat[:4], "big"):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                stat += chunk
            return json.loads(stat[4:])

    n = 64
    metrics, stat, secs = run_app(root, ["--mode", "semantic", "--source", "ring", "--auth-token",
                                         token.decode(), "--frames", str(n), "--port", "0"], talk)
    log(f"  app --mode semantic --source ring --auth-token: rc 0 in {secs:.1f}s, "
        f"n_frames={metrics['n_frames']}, fps={metrics['fps']:.3f}, plans_done="
        f"{metrics['plans_done']}, last_path_len={metrics['last_path_len']}; GetStat after "
        f"AuthTok + GetPath: requests {stat['requests']}")
    req = stat["requests"]
    if (metrics["n_frames"] != n or req["AuthTok"] != 1 or req["GetPath"] != 1
            or req["unauthorized"] or "pipeline" not in stat):
        raise AssertionError("the semantic ring app fell short")
    fps = metrics["fps"]
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        png = pathlib.Path(tmp) / "scene.png"
        save_rgb(png, synth_frame_numpy(0, 5, 224, 224).rgb)
        ckpt = root / "tod_tpu_torch" / "weights" / "yolact_dr.npz"
        metrics, _, secs = run_app(root, ["--source", "png", "--image", str(png), "--checkpoint",
                                          str(ckpt), "--debug-dump", "--frames", "16",
                                          "--no-server"], cwd=tmp)
        bmps = {p.name: p.stat().st_size for p in pathlib.Path(tmp).glob("*.bmp")}
    log(f"  app --source png --checkpoint --debug-dump: rc 0 in {secs:.1f}s, n_frames="
        f"{metrics['n_frames']}, fps={metrics['fps']:.3f}, plans_done={metrics['plans_done']}; "
        f"BMPs {bmps}")
    want = {"depth.bmp", "map.bmp", "connections0.bmp", "connections1.bmp"}
    if metrics["n_frames"] != 16 or set(bmps) != want:
        raise AssertionError(f"the PNG app fell short: {metrics['n_frames']} frames, BMPs {bmps}")
    return fps


def sync_checked(torch, fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: any host
    synchronisation raises.  Returns (result, enqueue ms)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        out = fn()
        ms = 1e3 * (time.perf_counter() - t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, ms


def read_reply(sock, n_fixed=None):
    """One reply: ``n_fixed`` bytes, or a u32-length-prefixed payload."""
    data = b""
    while True:
        if n_fixed is not None and len(data) >= n_fixed:
            return data[:n_fixed]
        if n_fixed is None and len(data) >= 4 and len(data) >= 4 + int.from_bytes(data[:4], "big"):
            return data[4:]
        chunk = sock.recv(65536)
        if not chunk:
            raise AssertionError(f"the server closed the connection after {len(data)} bytes")
        data += chunk


def tracked_path(torch, np, state, counters):
    """Phase 15: tracked serving at the app's configuration (640x480
    camera, model at 480x640, bf16) with the obstacle memory (0.8): one
    ``serve_step_track_plan`` and one ``serve_step_track_plan_mem`` frame
    under the sync check, 8 tracked frames with their launch counts (the
    tracker kernel, K4 and the relaxation once a planning frame), the bank
    on the card against the CPU's plain ``track_update`` fed the card's own
    ball slots, and ``run_supervised`` with the tracker."""
    from tod_tpu_torch.core.config import ModelConfig, PipelineConfig, PlannerConfig, TrackerConfig
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.serve.server import PathStore
    from tod_tpu_torch.track import track_update

    cfg = PipelineConfig(model=ModelConfig(input_size=(480, 640)),
                         planner=PlannerConfig(backend="tpu"),
                         tracker=TrackerConfig(enabled=True, obstacle_memory=0.8))
    eng = Engine(cfg, state, device="cuda")
    warm = eng.warmup()
    frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
              for f in SyntheticSource(cfg.camera, seed=0, n_frames=N_FRAMES + 1).frames()]
    bank, mem = eng._init_tracks(), eng._init_obstacle_mem()
    (plan, _), ms_a = sync_checked(torch, lambda: eng.serve_step_track_plan(frames[0], bank))
    check_plan(np, plan.cpu().numpy(), cfg.planner.max_path_steps)
    (plan, _, _), ms_b = sync_checked(
        torch, lambda: eng.serve_step_track_plan_mem(frames[0], bank, mem))
    check_plan(np, plan.cpu().numpy(), cfg.planner.max_path_steps)
    log(f"  engine: tracked, obstacle memory 0.8, camera {cfg.camera.width}x{cfg.camera.height}, "
        f"model input {cfg.model.input_size} {cfg.model.dtype}, warm-up {warm:.2f}s "
        f"{eng.warmup_breakdown}; one serve_step_track_plan and one serve_step_track_plan_mem "
        f"frame under set_sync_debug_mode('error'): no host synchronisation; enqueued in "
        f"{ms_a:.2f} and {ms_b:.2f} ms")

    bank, mem = eng._init_tracks(), eng._init_obstacle_mem()
    reset(counters)
    per_frame, n_valid, confirmed = [], [], []
    for packed in frames[1:]:
        t = time.perf_counter()
        plan, bank, mem = eng.serve_step_track_plan_mem(packed, bank, mem)
        buf = plan.cpu().numpy()
        per_frame.append(1e3 * (time.perf_counter() - t))
        n_valid.append(check_plan(np, buf, cfg.planner.max_path_steps))
        confirmed.append(int(((bank[:, 9] > 0) & (bank[:, 7] >= 2)).sum()))
    launches = read(counters)
    log(f"  ms per tracked+memory frame: {[round(x, 2) for x in per_frame]} (median "
        f"{statistics.median(per_frame):.2f}); plan n_valid {n_valid}; confirmed tracks "
        f"{confirmed}; memory max {mem.max().item():.1f}")
    log(f"  launches over {N_FRAMES} tracked frames: {launches}")
    if any(n != N_FRAMES for n in launches.values()):
        raise AssertionError(f"kernels not launched once a tracked frame: {launches}")
    if max(n_valid) == 0 or max(confirmed) == 0:
        raise AssertionError("the tracked frames confirmed no track or planned no path")

    # the kernel on the served frames' ball slots against the plain version on the CPU
    bank = eng._init_tracks()
    same = []
    with torch.inference_mode():
        for packed in frames[1:]:
            _, balls = eng.serve_step_scene(packed)
            before = bank.cpu()
            seeds = eng._track(bank, balls)
            want = track_update(before, balls.cpu(), cfg.tracker)
            same.append(torch.equal(bank.cpu(), want))
    log(f"  the bank after each of {N_FRAMES} served frames' ball slots equal to the CPU's plain "
        f"track_update bit for bit (tol exact): {same}; seeds {seeds.shape[0]} slots")
    if not all(same):
        raise AssertionError("the tracker kernel disagrees with the CPU on served ball slots")

    store = PathStore()
    reset(counters)
    m = eng.run_supervised(lambda: SyntheticSource(cfg.camera, n_frames=STREAM_FRAMES),
                           n_frames=STREAM_FRAMES, path_store=store, max_restarts=3,
                           stall_timeout_s=10.0, plan_every=4, max_inflight=2, warmup=False)
    run_launches = read(counters)
    path = store.get()
    log(f"  run_supervised with the tracker: {m['n_frames']} frames, fps={m['fps']:.3f}, "
        f"plans_done={m['plans_done']}, published path {len(path.directions)} directions, "
        f"launches {run_launches}")
    if m["n_frames"] != STREAM_FRAMES or run_launches["track"] != STREAM_FRAMES // 4 \
            or run_launches["bump"] != STREAM_FRAMES or m["plans_done"] < 1:
        raise AssertionError(f"the tracked run fell short: {m['n_frames']} frames, launches "
                             f"{run_launches}")
    return launches, statistics.median(per_frame)


def device_activity(torch, fn) -> tuple[float, float, int]:
    """(device busy ms, host ms, device activities) of one profiled ``fn()``,
    synchronised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return union_us(spans) / 1e3, wall_ms, len(spans)


def multistream_path(torch, np, state, counters):
    """Phase 16: ``MultiStreamEngine`` at 320x240 with N = 4: one batched
    tick and one tracked tick under the sync check, the launches of a
    tracked tick, and, in f32 with TF32 off, each stream's class and id
    maps, scene and plan against a single-stream ``Engine`` on the same
    frame, and ``TRACKED_TICKS`` tracked ticks' plans and banks against the
    single-stream tracked step, every stream exactly."""
    from tod_tpu_torch.bench.configs import _pipeline_cfg
    from tod_tpu_torch.core.config import ModelConfig, PlannerConfig, TrackerConfig
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.runtime.multistream import MultiStreamEngine
    from tod_tpu_torch.track.tracker import ACTIVE, HITS

    n = 4
    cfg = _pipeline_cfg().replace(planner=PlannerConfig(backend="tpu"),
                                  tracker=TrackerConfig(enabled=True))
    ms = MultiStreamEngine(cfg, n_streams=n, params=state, device="cuda")
    warm = ms.warmup()
    first = [next(SyntheticSource(cfg.camera, seed=7 + i, n_frames=1).frames()) for i in range(n)]
    packed = [pack_frame(f.rgb, f.depth) for f in first]
    batch = torch.from_numpy(np.stack(packed)).pin_memory()
    plans, ms_a = sync_checked(torch, lambda: ms._serve_plan_batch(batch))
    banks = ms._init_track_bank()
    (tplans, _), ms_b = sync_checked(torch, lambda: ms._serve_plan_batch_track(batch, banks))
    n_valid = [check_plan(np, p, cfg.planner.max_path_steps) for p in plans.cpu().numpy()]
    tvalid = [check_plan(np, p, cfg.planner.max_path_steps) for p in tplans.cpu().numpy()]
    log(f"  MultiStreamEngine N={n} at {cfg.camera.width}x{cfg.camera.height}, warm-up "
        f"{warm:.2f}s: one tick and one tracked tick under set_sync_debug_mode('error'): no "
        f"host synchronisation; enqueued in {ms_a:.2f} and {ms_b:.2f} ms; plan n_valid {n_valid}, "
        f"tracked {tvalid}")
    reset(counters)
    ms._serve_plan_batch_track(batch, banks)
    launches = read(counters)
    want = {"mask_assembly": 1, "track": 1, "bump": n, "connections": n, "relax": n,
            "path_walk": n}
    log(f"  launches in one tracked tick of {n} streams: {launches} (K1 and the tracker once "
        f"a tick, the rest once a stream)")
    if launches != want:
        raise AssertionError(f"a tracked tick launched {launches}, not {want}")
    busy, wall, n_act = device_activity(torch, lambda: ms._serve_plan_batch_track(batch, banks))
    log(f"  one profiled tracked tick of {n} streams: device busy {busy:.3f} ms of {wall:.3f} ms "
        f"under the profiler, {n_act} device activities ({n_act / n:.0f} a stream)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = cfg.replace(model=ModelConfig(input_size=(240, 320), dtype="float32"))
    ms32 = MultiStreamEngine(f32, n_streams=n, params=state, device="cuda")
    eng32 = Engine(f32, state, device="cuda")
    rows = []
    with torch.inference_mode():
        heights, balls, dets = ms32._scenes(batch)
        plans = ms32._plan_all(heights, balls)
        for i in range(n):
            _, one = eng32._step(batch[i])
            h1, b1 = eng32.serve_step_scene(batch[i])
            same_maps = (torch.equal(dets.class_map[i], one.class_map)
                         and torch.equal(dets.id_map[i], one.id_map))
            exact = (torch.equal(heights[i], h1) and torch.equal(balls[i], b1)
                     and torch.equal(plans[i], eng32.serve_step_plan(batch[i])))
            rows.append((same_maps, exact))
    log(f"  f32 (TF32 off) tick against a single-stream Engine, per stream (class and id maps "
        f"equal, scene and plan equal; all exact): {rows}")
    if not all(same and ex for same, ex in rows):
        raise AssertionError("the multistream tick disagrees with the single-stream engine")

    # the tracked tick against the single-stream tracked step, stream by stream,
    # from the same starting banks over TRACKED_TICKS frames a stream
    frames = [[torch.from_numpy(pack_frame(f.rgb, f.depth)) for f in
               SyntheticSource(cfg.camera, seed=7 + i, n_frames=TRACKED_TICKS).frames()]
              for i in range(n)]
    banks32 = ms32._init_track_bank()
    singles = [banks32[i].clone() for i in range(n)]
    agree = []
    with torch.inference_mode():
        for t in range(TRACKED_TICKS):
            tick = torch.stack([frames[i][t] for i in range(n)]).pin_memory()
            tplans, _ = ms32._serve_plan_batch_track(tick, banks32)
            for i in range(n):
                plan1, _ = eng32.serve_step_track_plan(tick[i], singles[i])
                agree.append(torch.equal(tplans[i], plan1) and torch.equal(banks32[i], singles[i]))
    confirmed = int(((banks32[..., ACTIVE] > 0)
                     & (banks32[..., HITS] >= f32.tracker.min_hits)).sum())
    log(f"  f32 tracked tick against Engine.serve_step_track_plan stream by stream, "
        f"{TRACKED_TICKS} ticks of {n} streams from the same starting banks: plans and banks "
        f"equal (exact) in {sum(agree)} of {len(agree)}; {confirmed} confirmed tracks at the end")
    if not all(agree) or confirmed == 0:
        raise AssertionError("the tracked multistream tick disagrees with the tracked Engine "
                             f"({sum(agree)} of {len(agree)} agree, {confirmed} confirmed)")
    return launches


def app_streams(root):
    """``python3 -m tod_tpu_torch.app --track --obstacle-memory 0.8
    --plan-every 4`` with one ``GetPath`` and one ``GetStat``; then ``--streams 2
    --track`` asked ``GetPthN 0``, ``GetPthN 1``, ``NewPthN 1`` and
    ``GetStat``, whose ``streams`` list has 2 entries."""
    def talk_tracked(port):
        # GetPath's reply has no length: it ends where GetStat's length-prefixed
        # JSON, which starts with its first key, begins
        with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
            sock.sendall(b"GetPath" + b"GetStat")
            data = b""
            while True:
                at = data.find(b'{"uptime_s"')
                if at >= 4 and len(data) >= at + int.from_bytes(data[at - 4 : at], "big"):
                    break
                chunk = sock.recv(65536)
                if not chunk:
                    raise AssertionError(f"the server closed after {len(data)} bytes")
                data += chunk
            if (at - 4 - 8) % 8:
                raise AssertionError(f"GetPath answered {at - 4} bytes, not 8 + 8 n")
            return json.loads(data[at:])

    metrics, stat, secs = run_app(root, ["--track", "--obstacle-memory", "0.8", "--plan-every",
                                         "4", "--frames", "32", "--port", "0"], talk_tracked)
    log(f"  app --track --obstacle-memory 0.8 --plan-every 4: rc 0 in {secs:.1f}s, n_frames="
        f"{metrics['n_frames']}, fps={metrics['fps']:.3f}, plans_done={metrics['plans_done']}, "
        f"last_path_len={metrics['last_path_len']}; GetStat requests {stat['requests']}")
    if (metrics["n_frames"] != 32 or metrics["plans_done"] < 1 or "pipeline" not in stat
            or stat["requests"]["GetPath"] != 1):
        raise AssertionError("the tracked app fell short")

    def talk_streams(port):
        with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
            out = {}
            for name, cmd in (("GetPthN 0", b"GetPthN" + (0).to_bytes(4, "big")),
                              ("GetPthN 1", b"GetPthN" + (1).to_bytes(4, "big"))):
                sock.sendall(cmd)
                out[name] = len(read_reply(sock))
            sock.sendall(b"NewPthN" + (1).to_bytes(4, "big"))
            out["NewPthN 1"] = read_reply(sock, 2)
            sock.sendall(b"GetStat")
            out["GetStat"] = json.loads(read_reply(sock))
            return out

    metrics, ans, secs = run_app(root, ["--streams", "2", "--track", "--frames", "24", "--port",
                                        "0"], talk_streams)
    stat = ans.pop("GetStat")
    log(f"  app --streams 2 --track: rc 0 in {secs:.1f}s, n_ticks={metrics['n_ticks']}, "
        f"frames_per_s={metrics['frames_per_s']:.3f}, plans_done={metrics['plans_done']}; "
        f"answers {ans}; GetStat streams {stat['streams']}, requests {stat['requests']}")
    if (ans["NewPthN 1"] != b"OK" or len(stat.get("streams", [])) != 2
            or stat["requests"]["GetPthN"] != 2 or metrics["plans_done"] < 2):
        raise AssertionError("the multistream app fell short")


def static_dense_calls(torch, model, x) -> int:
    """The static int8 convolutions one forward of ``model`` makes."""
    from tod_tpu_torch.models.qconv import conv_sites

    calls = [0]
    hooks = [m.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in conv_sites(model).values() if m.branch == "static"]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return calls[0]


def int8_path(torch, np, state, counters):
    """Phase 17: ``--int8`` serving, ``ModelConfig.quantized``, at 320x240
    (model 240x320) and 640x480 (480x640), bf16: the engine prepares the
    int8 tree on the card (calibration through the kernel's dynamic
    branch), then one ``serve_step_plan`` frame under the sync check and 8
    frames with the path's launch counts (``qconv`` once per dense conv
    call of the forward, K1, K4, K2, the relaxation and the walk once a
    frame); then, at 240x320 in f32 (TF32 off), the card's int8 forward and
    ``Engine._step`` against the CPU's on the same prepared tree."""
    from tod_tpu_torch.core.config import CameraConfig, ModelConfig, PipelineConfig
    from tod_tpu_torch.kernels.qconv import qconv
    from tod_tpu_torch.ops.preprocess import pack_frame, preprocess_frame
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    launches, frame_ms = None, {}
    for hw in ((240, 320), (480, 640)):
        cfg = PipelineConfig(camera=CameraConfig(width=hw[1], height=hw[0]),
                             model=ModelConfig(input_size=hw, quantized=True))
        t = time.time()
        qconv.launches = 0
        eng = Engine(cfg, state, device="cuda")
        torch.cuda.synchronize()
        log(f"  int8 engine {hw}: prepared on the card in {time.time() - t:.2f}s "
            f"({qconv.launches} calibration launches)")
        frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
                  for f in SyntheticSource(cfg.camera, seed=0, n_frames=N_FRAMES + 1).frames()]
        eng.serve_step_plan(frames[0])  # warm-up
        per_forward = static_dense_calls(
            torch, eng.model, torch.zeros((1, *hw, 3), dtype=torch.bfloat16, device="cuda"))
        plan, enqueue_ms = sync_checked(torch, lambda: eng.serve_step_plan(frames[1]))
        check_plan(np, plan.cpu().numpy(), cfg.planner.max_path_steps)
        reset(counters)
        per_frame, n_valid = [], []
        for packed in frames[1:]:
            t = time.perf_counter()
            buf = eng.serve_step_plan(packed).cpu().numpy()
            per_frame.append(1e3 * (time.perf_counter() - t))
            n_valid.append(check_plan(np, buf, cfg.planner.max_path_steps))
        launches = read(counters)
        frame_ms[hw] = statistics.median(per_frame)
        log(f"  int8 {hw}: one frame under set_sync_debug_mode('error'): no host sync, "
            f"enqueued in {enqueue_ms:.2f} ms; {N_FRAMES} frames median {frame_ms[hw]:.2f} ms "
            f"{[round(v, 2) for v in per_frame]}; plan n_valid {n_valid}; launches {launches} "
            f"({per_forward} dense conv calls a forward)")
        want = {name: N_FRAMES for name in counters}
        want["qconv"] = N_FRAMES * per_forward
        if launches != want or per_forward != 68:
            raise AssertionError(f"int8 launches {launches}, not {want} (68 dense calls)")
        if max(n_valid) == 0:
            raise AssertionError(f"no int8 frame at {hw} produced a path to a ball")
        del eng

    # the card against the CPU on the same prepared tree, f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hw = (240, 320)
    cfg = PipelineConfig(camera=CameraConfig(width=hw[1], height=hw[0]),
                         model=ModelConfig(input_size=hw, dtype="float32", quantized=True))
    card = Engine(cfg, state, device="cuda")
    prepared = {k: v.cpu() for k, v in card.model.state_dict().items()}
    cpu = Engine(cfg, prepared, device="cpu")
    f = next(SyntheticSource(cfg.camera, seed=0, n_frames=1).frames())
    x = preprocess_frame(torch.from_numpy(f.rgb), hw, torch.float32)
    with torch.inference_mode():
        outs = {"cuda": card.model(x.cuda()), "cpu": cpu.model(x)}
    worst = {}
    for field in ("loc", "conf", "coeff", "prototypes", "sem_logits"):
        a, b = getattr(outs["cuda"], field).cpu(), getattr(outs["cpu"], field)
        worst[field] = ((a - b).abs().max().item(), (a != b).float().mean().item(),
                        b.abs().max().item())
    packed = torch.from_numpy(pack_frame(f.rgb, f.depth))
    with torch.inference_mode():
        dets = {"cuda": card._step(packed)[1], "cpu": cpu._step(packed)[1]}
    cls_diff = (dets["cuda"].class_map.cpu() != dets["cpu"].class_map).float().mean().item()
    log("  int8 forward f32 card vs CPU, same prepared tree (max abs diff, share differing, "
        "max |value|): " + ", ".join(f"{k} ({v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g})"
                                     for k, v in worst.items())
        + f"; class-map pixels differing {cls_diff:.2e} (tol 1e-3; each field's max abs diff "
        f"within 1% of its max |value|: the int8 convolutions are exact, the bf16-kernel "
        f"depthwise convolutions may sum in another order on the card)")
    if cls_diff > 1e-3 or any(v[0] > 0.01 * v[2] for v in worst.values()):
        raise AssertionError("the int8 forward on the card and on the CPU disagree")
    return launches, frame_ms


def int8_apps(root) -> None:
    """``python3 -m tod_tpu_torch.app --int8``, with ``--track`` and with
    ``--streams 4``, each as a subprocess at the app's configuration."""
    for args, what in ((["--int8", "--frames", "16"], "n_frames"),
                       (["--int8", "--track", "--plan-every", "4", "--frames", "16"], "n_frames"),
                       (["--int8", "--streams", "4", "--frames", "8"], "n_ticks")):
        metrics, _, secs = run_app(root, [*args, "--no-server"])
        log(f"  app {' '.join(args)}: rc 0 in {secs:.1f}s, {what}={metrics[what]}, "
            f"plans_done={metrics['plans_done']}")
        if metrics[what] < 1 or metrics["plans_done"] < 1:
            raise AssertionError(f"the app {' '.join(args)} fell short: {metrics}")


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
    faulthandler.dump_traceback_later(1100, exit=True)
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

    from tod_tpu_torch.core.weights import load_pinned
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels.bump import dilate_peaks, dilate_peaks_strips
    from tod_tpu_torch.kernels.cc_labels import root_labels
    from tod_tpu_torch.kernels.connections import connection_planes
    from tod_tpu_torch.kernels.mask_assembly import assemble_crop_masks
    from tod_tpu_torch.kernels.path_walk import walk_path
    from tod_tpu_torch.kernels.qconv import qconv
    from tod_tpu_torch.kernels.relax import bellman_ford_grid
    from tod_tpu_torch.kernels.track import track_banks
    from tod_tpu_torch.native import loader, ring
    from tod_tpu_torch.ops.quantize import quantize_tensor_pallas

    # each path's kernels, with their launch counters
    planner = {"connections": connection_planes, "relax": bellman_ford_grid,
               "path_walk": walk_path}
    serving = {"mask_assembly": assemble_crop_masks, "bump": dilate_peaks, **planner}
    stream_path = {"mask_assembly": assemble_crop_masks, "bump_strips": dilate_peaks_strips,
                   **planner}
    k4_call = {"bump": dilate_peaks}
    ptq_path = {**serving, "quantize": quantize_tensor_pallas}
    semantic = {"cc_labels": root_labels, **serving}
    tracked = {"track": track_banks, **serving}
    int8 = {"qconv": qconv, **serving}

    log("== 1. device")
    smi = nvidia_smi_line()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== 2. build")
    t = time.time()
    logs = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(logs) or 'nothing (cached)'} in {time.time() - t:.1f}s")
    t = time.time()
    if not loader.available():
        raise AssertionError("the native planner did not build")
    log(f"  native planner {_build.build_host(loader.SOURCE).name} ready in {time.time() - t:.1f}s")
    t = time.time()
    ring.get()
    log(f"  native frame ring {_build.build_host(ring.SOURCE).name} ready in {time.time() - t:.1f}s")

    log("== 3. kernels against their plain versions")
    rng = np.random.default_rng(0)
    device = torch.device("cuda", 0)
    floor_ms, _ = time_ms(lambda: torch.cuda._sleep(0), torch)
    log(f"  timing floor (an empty kernel, same method): {floor_ms:.5f} ms")
    kernels = [check_k1(torch, np, rng, device), check_k2(torch, np, rng, device),
               check_relax(torch, np, rng, device), check_walk(torch, np, rng, device),
               *check_bump(torch, np, rng, device), check_k5(torch, np, rng, device),
               check_cc(torch, np, rng, device), check_track(torch, np, rng, device),
               check_qconv(torch, np, rng, device), check_qconv_stem(torch, np, rng, device)]
    log("  kernels: " + ", ".join(f"{k['name']} ok" for k in kernels))
    d5_refusals(torch)

    log("== 4. main path")
    path, launches, frame_ms, eng, frames = main_path(torch, np, serving)

    log("== 5. reference check on a small input")
    reference_check(torch, np)
    bump_reference_check(torch, np)

    log("== 6. server")
    serve_and_query(path)

    log("== 7. streaming loop, app configuration, pallas_bump")
    state = load_pinned()
    stream_launches, _ = streaming(torch, np, state, stream_path, k4_call)

    log("== 8. the app as a subprocess")
    app_subprocess(root)

    log("== 9. weight-only PTQ with K5")
    ptq_launches = ptq(torch, np, eng, frames, ptq_path)

    log("== 10. the host-planner mode (native)")
    host_planner(torch, np, state, serving)

    log("== 11. each kernel's own device time")
    own_times(torch, kernels, floor_ms)

    log("== 12. the bench")
    bench_phase(torch, np, tracked)

    log("== 13. semantic mode, app configuration")
    semantic_launches, semantic_ms = semantic_path(torch, np, state, semantic)

    log("== 14. the app in semantic mode on the ring with auth, and on a PNG")
    semantic_fps = semantic_apps(root, np)

    log("== 15. tracked serving, app configuration, obstacle memory")
    t = time.time()
    tracked_launches, tracked_ms = tracked_path(torch, np, state, tracked)

    log("== 16. multistream, 4 streams at 320x240, and the tracked and multistream apps")
    multistream_path(torch, np, state, tracked)
    app_streams(root)
    log(f"  phases 15 and 16 took {time.time() - t:.1f}s")

    log("== 17. int8 serving (--int8) at 320x240 and 640x480, and the int8 apps")
    t = time.time()
    int8_launches, int8_ms = int8_path(torch, np, state, int8)
    int8_apps(root)
    log(f"  phase 17 took {time.time() - t:.1f}s")

    log("== 18. frozen artifacts at the app's configuration, the --aot boot, the --todx app")
    t = time.time()
    artifact_path(torch, np, state, root, {"serving": serving, "tracked": tracked,
                                           "semantic": semantic, "int8": int8})
    log(f"  phase 18 took {time.time() - t:.1f}s")

    log("== 19. the ResNet backbones")
    t = time.time()
    stem_launches = resnet_path(torch, np, int8)
    log(f"  phase 19 took {time.time() - t:.1f}s")

    log("== 20. training (M14) at 240x320, batch 8, and what it trained served")
    t = time.time()
    train_ms = train_path(torch, np, semantic, root)
    log(f"  phase 20 took {time.time() - t:.1f}s")

    # launches: each kernel's count on the path it belongs to (K4's on the
    # default serve path, K3's on the stream path with pallas_bump, the cc
    # kernel's on the semantic path)
    launches["bump_strips"] = stream_launches["bump_strips"]
    launches["quantize"] = ptq_launches["quantize"]
    launches["cc_labels"] = semantic_launches["cc_labels"]
    launches["track"] = tracked_launches["track"]
    launches["qconv"] = int8_launches["qconv"]
    launches["qconv_stem"] = stem_launches
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "own_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    log(f"main path median {frame_ms:.2f} ms/frame; semantic {semantic_ms:.2f} ms/frame, "
        f"semantic app {semantic_fps:.3f} fps; tracked+memory {tracked_ms:.2f} ms/frame; int8 "
        f"{', '.join(f'{hw}: {ms:.2f}' for hw, ms in int8_ms.items())} ms/frame; train step "
        f"{train_ms:.2f} ms; total "
        f"{time.time() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
