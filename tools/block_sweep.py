#!/usr/bin/env python3
"""Time the relaxation, path-walk, mask-assembly (K1), connection (K2),
terrain dilation (K3/K4) and stochastic quantizer (K5) kernels at several
shapes and build options.

Run from the repository root on a machine with an NVIDIA GPU:
``python3 tools/block_sweep.py [relax] [walk] [k1] [k2] [k3] [k5]`` (all
six when none is named).

- The relaxation is compiled once per block size (``-DTOD_THREADS``) and run
  at several tilings: the batch depth k (sweeps per grid barrier) with the
  tile ``relax_tiling`` picks for it, and a few tiles given outright.  Beside
  each time it prints the **barrier floor**: the time of an empty
  cooperative kernel (``tools/grid_barrier.cu``) that takes the same number
  of grid barriers on the same grid (blocks, threads, shared memory).
- The walk is compiled once per (threads per block, resident blocks per SM)
  with ``-DTOD_THREADS`` and ``-DTOD_BLOCKS_PER_SM``.
- K1 runs at several (pixels a block, detection groups) and K2 at several
  band heights: both are launch arguments of the committed libraries.  K2
  runs by both of its staging routes: the committed library's, and the
  same source built with ``-DTOD_K2_BULK=0`` (coalesced loads only).  Each
  time is printed beside the kernel's own time (``chip_smoke.own_ms``, all of
  a kernel's shapes in one profiler session, before the event times).
- K3 runs on a synthetic frame's VGA terrain peaks at L = 10 (``chip_smoke.
  check_bump``'s input) at several (pixels a thread, thread rows a block),
  launch arguments of the committed library, and by other builds at a few of
  them: ``-DTOD_K3_TABLE=0`` (the ring table's offsets read from device
  memory in place of the compile-time immediates) and ``-DTOD_K3_MEMO=0``
  (every bump computed, none read from the memo table).
- K5 runs on the pinned tree's largest kernel (1152x288, as in
  ``chip_smoke.check_k5``): the memset, the column-maximum kernel and the
  quantize kernel, whose own times are summed.

Every build goes into ``build/tod_tpu_torch/sweep/``; every output is
checked against the committed kernel's on the same inputs, and a device time
is the median of CUDA events over 20 calls (50 for the walk and the floor),
as ``chip_smoke.py`` times kernels.  The inputs are ``chip_smoke.py``'s: a
480x640 rolling height map with two seeds, and the walk from the robot's
start node over its relaxation with max_steps 2048; K1's are 1x64x80x32
prototypes with 32 detections made as ``chip_smoke.py`` makes them (seed 0),
and K2's that 480x640 height map.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
RELAX_THREADS = [256, 512, 1024]
RELAX_K = [2, 4, 8, 12, 16]  # each with relax_tiling's tile
# (k, tile) given outright
RELAX_TILES = [(8, (40, 59)), (8, (60, 40)), (8, (20, 120)), (6, (30, 80)), (9, (30, 80))]
WALK_SHAPES = [(256, 8), (256, 1), (512, 1), (1024, 2), (1024, 1)]  # (threads, blocks per SM)
K1_TILES = [(32, 2), (32, 4), (32, 8), (32, 16), (64, 4), (64, 8), (128, 4)]  # (pixels, groups)
K2_ROWS = [1, 2, 3, 4, 6, 8]
K3_TILES = [(1, 2), (1, 4), (1, 8), (1, 16), (2, 2), (2, 4), (2, 8), (2, 16), (4, 1), (4, 2),
            (4, 4), (4, 8)]
# builds of csrc/bump.cu beside the committed one, and the tilings each runs at
K3_BUILDS = {"table": ["-DTOD_K3_TABLE=0"], "nomemo": ["-DTOD_K3_MEMO=0"]}
K3_BUILD_TILES = [(1, 4), (2, 4), (4, 2), (4, 4)]
SECTIONS = ("relax", "walk", "k1", "k2", "k3", "k5")


def main(argv: list[str]) -> int:
    sections = set(argv) or set(SECTIONS)
    if not sections <= set(SECTIONS):
        print(f"block_sweep: sections are {SECTIONS}, got {argv}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels.bump import SIGNATURES as K3_SIG
    from tod_tpu_torch.kernels.connections import SIGNATURES as K2_SIG
    from tod_tpu_torch.kernels.path_walk import SIGNATURES as WALK_SIG
    from tod_tpu_torch.kernels.path_walk import walk_path
    from tod_tpu_torch.kernels.relax import SIGNATURES as RELAX_SIG
    from tod_tpu_torch.kernels.relax import (SMEM_LIMIT, bellman_ford_grid, region_fits,
                                             relax_tiling, smem_bytes)
    from tod_tpu_torch.ops.quantize import SIGNATURES as K5_SIG
    from tod_tpu_torch.planner.dijkstra import start_node_yx

    if not torch.cuda.is_available():
        print("block_sweep: CUDA is not available", file=sys.stderr)
        return 2
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}

    def start(key, src, defines):
        so = out / ("lib" + "_".join(map(str, key)) + ".so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(so), str(src)]
        jobs[key] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), so

    for threads in RELAX_THREADS if "relax" in sections else ():
        start(("relax", threads), _build.CSRC / "relax.cu", [f"-DTOD_THREADS={threads}"])
    for threads, per_sm in WALK_SHAPES if "walk" in sections else ():
        start(("path_walk", threads, per_sm), _build.CSRC / "path_walk.cu",
              [f"-DTOD_THREADS={threads}", f"-DTOD_BLOCKS_PER_SM={per_sm}"])
    if "relax" in sections:
        start(("grid_barrier",), ROOT / "tools" / "grid_barrier.cu", [])
    if "k2" in sections:
        start(("connections", "coalesced"), _build.CSRC / "connections.cu", ["-DTOD_K2_BULK=0"])
    for name, defines in K3_BUILDS.items() if "k3" in sections else ():
        start(("bump", name), _build.CSRC / "bump.cu", defines)
    libs, regs = {}, {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        found = re.findall(r"Used (\d+) registers", log)
        regs[key] = found[0] if found else "?"
        libs[key] = ctypes.CDLL(str(so))
    for key, lib in libs.items():
        signatures = {"relax": RELAX_SIG, "path_walk": WALK_SIG, "connections": K2_SIG,
                      "bump": K3_SIG, "quantize": K5_SIG}.get(
            key[0], {"tod_grid_barriers": ([ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int)})
        for entry, (argtypes, restype) in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
        libs[key] = lib if key[0] in ("bump", "quantize") else getattr(lib, next(iter(signatures)))
    print(chip_smoke.nvidia_smi_line(), flush=True)

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    height, conns, seed = chip_smoke.relax_inputs(torch, np, rng, dev, 480, 640,
                                                  [(20, 100), (200, 600)])
    h, w = height.shape
    want = bellman_ford_grid(height, conns, seed)
    n_sweeps = int(want[2])

    def relax(fn, t):
        dist, scratch = (torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(2))
        next_dir = torch.empty((h, w), dtype=torch.int64, device=dev)
        sweeps = torch.empty((), dtype=torch.int32, device=dev)
        flags = torch.empty(2049, dtype=torch.int32, device=dev)
        err = fn(height.data_ptr(), conns.data_ptr(), seed.data_ptr(), dist.data_ptr(),
                 scratch.data_ptr(), next_dir.data_ptr(), flags.data_ptr(), sweeps.data_ptr(),
                 h, w, 2048, t.tile_h, t.tile_w, t.k, t.blocks, stream)
        if err:
            raise RuntimeError(f"relax launch failed: CUDA error {err}")
        return dist, next_dir, sweeps

    def barriers(threads, t, n):
        err = libs["grid_barrier",](t.blocks, threads, t.smem_bytes, n, stream)
        if err:
            raise RuntimeError(f"grid_barrier launch failed: CUDA error {err}")

    if "k1" in sections:
        k1_sweep(torch, np, dev, sms, stream)
    if "k2" in sections:
        k2_sweep(torch, height, sms, stream, libs["connections", "coalesced"])
    if "k3" in sections:
        k3_sweep(torch, np, dev, sms, stream, {name: libs["bump", name] for name in K3_BUILDS},
                 regs)
    if "k5" in sections:
        k5_sweep(torch, np, dev, sms, stream)
    tilings = [relax_tiling(h, w, sms, k) for k in RELAX_K] if "relax" in sections else []
    tilings += [relax_tiling(h, w, sms, k, tile) for k, tile in RELAX_TILES] if tilings else []
    print(f"relax at ({h},{w}), {n_sweeps} sweeps, {sms} SMs; the committed tiling is "
          f"{relax_tiling(h, w, sms)}", flush=True)
    for threads in RELAX_THREADS if tilings else ():
        fn = libs["relax", threads]
        for t in tilings:
            smem = smem_bytes(t.tile_h, t.tile_w, t.k, threads)
            if smem > SMEM_LIMIT or not region_fits(t.tile_h, t.tile_w, t.k, threads):
                print(f"relax threads={threads} k={t.k} tile={t.tile_h}x{t.tile_w}: does not "
                      f"fit ({smem} bytes of shared memory)", flush=True)
                continue
            t = t._replace(smem_bytes=smem)
            got = relax(fn, t)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms, _ = chip_smoke.time_ms(lambda: relax(fn, t), torch, n=20, warmup=2)
            n_bar = -(-n_sweeps // t.k) + 1
            floor, _ = chip_smoke.time_ms(lambda: barriers(threads, t, n_bar), torch)
            print(f"relax threads={threads} ({regs['relax', threads]} registers) k={t.k} "
                  f"tile={t.tile_h}x{t.tile_w} tiles={t.tiles} blocks={t.blocks} "
                  f"smem={t.smem_bytes}: {ms:.5f} ms, {1e3 * ms / n_sweeps:.3f} us a sweep; "
                  f"barrier floor {floor:.5f} ms for {n_bar} barriers "
                  f"({1e3 * floor / n_bar:.3f} us each); equal to the committed kernel={same}",
                  flush=True)
            if not same:
                raise AssertionError(f"relax at {threads} threads, {t} disagrees with the "
                                     "committed kernel")

    dist, next_dir, _ = want
    start_yx = start_node_yx((h, w), 240)
    plan_want = walk_path(dist, next_dir, start_yx, 2048)
    levels = (2048).bit_length()

    def walk(fn):
        plan = torch.empty((2049, 2), dtype=torch.float32, device=dev)
        succ = torch.empty(levels * h * w, dtype=torch.int32, device=dev)
        err = fn(dist.data_ptr(), next_dir.data_ptr(), succ.data_ptr(), plan.data_ptr(), h * w, w,
                 start_yx[0] * w + start_yx[1], 2048, levels, 0, stream)
        if err:
            raise RuntimeError(f"path_walk launch failed: CUDA error {err}")
        return plan

    for threads, per_sm in WALK_SHAPES if "walk" in sections else ():
        fn = libs["path_walk", threads, per_sm]
        same = torch.equal(walk(fn), plan_want)
        ms, _ = chip_smoke.time_ms(lambda: walk(fn), torch)
        print(f"path_walk threads={threads} blocks/SM<={per_sm} "
              f"({regs['path_walk', threads, per_sm]} registers): {ms:.5f} ms, "
              f"{int(plan_want[0, 0])} hops; equal to the committed kernel={same}", flush=True)
        if not same:
            raise AssertionError(f"path_walk at {threads}x{per_sm} disagrees with the committed "
                                 "kernel")
    return 0


def k1_sweep(torch, np, dev, sms, stream) -> None:
    import chip_smoke
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels import mask_assembly as k1

    b, hm, wm, k, n = 1, 64, 80, 32, 32
    protos, coeffs, boxes = chip_smoke.k1_inputs(torch, np, np.random.default_rng(0), dev,
                                                 b, hm, wm, k, n)
    want = k1.assemble_crop_masks(protos, coeffs, boxes)
    fn = _build.load(k1.SOURCE, k1.SIGNATURES).tod_mask_assembly
    print(f"K1 at {tuple(protos.shape)}, N={n}, {sms} SMs; the committed tiling is "
          f"{k1.mask_tiling(b, hm * wm, n, k, sms)}", flush=True)

    def masks(pixels, groups):
        out = torch.empty_like(want)
        err = fn(protos.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(), out.data_ptr(),
                 b, n, hm, wm, k, pixels, groups, stream)
        if err:
            raise RuntimeError(f"mask_assembly launch failed: CUDA error {err}")
        return out

    calls = [(lambda p=p, g=g: masks(p, g), "mask_assembly_kernel") for p, g in K1_TILES]
    _, own = chip_smoke.own_ms(torch, calls)
    for (pixels, groups), (call, _), own_ms in zip(K1_TILES, calls, own):
        same = torch.equal(call(), want)
        ms, _ = chip_smoke.time_ms(call, torch)
        print(f"K1 pixels={pixels} groups={groups} blocks={b * -(-hm * wm // pixels)} "
              f"threads={pixels * groups}: {ms:.5f} ms, own {chip_smoke.fmt(own_ms)} ms; "
              f"equal to the committed tiling={same}", flush=True)
        if not same:
            raise AssertionError(f"K1 at {pixels}x{groups} disagrees with the committed tiling")


def k2_sweep(torch, height, sms, stream, coalesced) -> None:
    """K2 at each band height, by both staging routes: the committed
    library's (a bulk copy a row where the rows allow it) and ``coalesced``,
    the same source built with ``-DTOD_K2_BULK=0`` (coalesced loads only)."""
    import chip_smoke
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels import connections as k2

    h, w = height.shape
    want = k2.connection_planes(height)
    routes = {"bulk": _build.load(k2.SOURCE, k2.SIGNATURES).tod_connections,
              "coalesced": coalesced}
    print(f"K2 at ({h},{w}), {sms} SMs; the committed tiling is "
          f"{k2.connection_tiling(h, w, sms)}", flush=True)

    def planes(fn, rows):
        out = torch.empty_like(want)
        err = fn(height.data_ptr(), out.data_ptr(), h, w, rows, k2.row_stride(w), stream)
        if err:
            raise RuntimeError(f"connections launch failed: CUDA error {err}")
        return out

    cases = [(rows, route) for rows in K2_ROWS for route in routes]
    calls = [(lambda r=rows, fn=routes[route]: planes(fn, r), "connections_kernel")
             for rows, route in cases]
    _, own = chip_smoke.own_ms(torch, calls)
    for (rows, route), (call, _), own_ms in zip(cases, calls, own):
        same = torch.equal(call(), want)
        ms, _ = chip_smoke.time_ms(call, torch)
        print(f"K2 {route} rows={rows} blocks={-(-h // rows)}: {ms:.5f} ms, own "
              f"{chip_smoke.fmt(own_ms)} ms; equal to the committed kernel={same}", flush=True)
        if not same:
            raise AssertionError(f"K2 {route} at {rows} rows disagrees with the committed kernel")


def k3_sweep(torch, np, dev, sms, stream, builds, regs) -> None:
    """K3 at each (pixels, rows) by the committed library, and each build
    of ``builds`` at ``bump_tiling``'s tiling; outputs equal (NaN where NaN)
    to the committed kernel's at its own tiling."""
    import chip_smoke
    from tod_tpu_torch.core.config import CameraConfig, GeometryConfig
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels import bump as k3
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    geom = GeometryConfig()
    f = synth_frame_numpy(0, 0, 480, 640)
    ext = chip_smoke.terrain_peaks(
        torch, np, torch.from_numpy(f.depth.astype(np.int32)).to(dev),
        torch.from_numpy(chip_smoke.color_class_map(np, f.rgb)).to(dev), CameraConfig(), geom)
    L, err, shape = geom.terrain_norm_const, geom.bump_err, (480, 640)
    h, w = shape
    hp, wp = ext.shape
    want = k3.dilate_peaks(ext, L, err, shape)
    libs = {"committed": _build.load(k3.SOURCE, k3.SIGNATURES), **builds}
    rings = k3._ring_state(libs["committed"], L, err, dev)  # filled by the call above
    committed = k3.bump_tiling(h, w, L, sms)
    print(f"K3 at the VGA terrain {tuple(ext.shape)} -> {shape}, L={L}, {sms} SMs; the "
          f"committed tiling is {committed}; registers {dict((k[1], v) for k, v in regs.items() if k[0] == 'bump')}",
          flush=True)

    def dilate(lib, pixels, rows):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        e = lib.tod_bump(ext.data_ptr(), hp, wp, out.data_ptr(), h, w, (hp - h) // 2, L, err,
                         rings.table.data_ptr(), 4 * L * L, rings.memo.shape[0], pixels, rows,
                         rings.memo.data_ptr(), k3.MEMO_VALUES, stream)
        if e:
            raise RuntimeError(f"bump launch failed: CUDA error {e}")
        return out

    cases = [("committed", p, r) for p, r in K3_TILES]
    cases += [(name, p, r) for name in builds for p, r in K3_BUILD_TILES]
    calls = [(lambda n=n, p=p, r=r: dilate(libs[n], p, r), "bump_kernel") for n, p, r in cases]
    _, own = chip_smoke.own_ms(torch, calls)
    for (name, pixels, rows), (call, _), own_ms in zip(cases, calls, own):
        got = call()
        same = bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
        ms, _ = chip_smoke.time_ms(call, torch)
        t = k3.bump_tiling(h, w, L, sms, pixels, rows)
        print(f"K3 {name} pixels={pixels} rows={rows} blocks={t.blocks} threads={t.threads}: "
              f"{ms:.5f} ms, own {chip_smoke.fmt(own_ms)} ms; equal to the committed kernel={same}",
              flush=True)
        if not same:
            raise AssertionError(f"K3 {name} at {pixels}x{rows} disagrees with the committed kernel")


def k5_sweep(torch, np, dev, sms, stream) -> None:
    """K5 by a direct call of the committed library: its own time (memset
    and both kernels) and its event time; output equal to the wrapper's."""
    import chip_smoke
    from tod_tpu_torch.core.weights import read_tree
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.ops import quantize as k5

    tree = read_tree()
    key = max((k for k in tree if k.endswith("/kernel")), key=lambda k: tree[k].size)
    x = torch.from_numpy(tree[key].reshape(-1, tree[key].shape[-1]).astype(np.float32)).to(dev)
    n, c = x.shape
    want = k5.quantize_tensor_pallas(x, seed=7)
    lib = _build.load(k5.SOURCE, k5.SIGNATURES)
    print(f"K5 at {key} {(n, c)}, {sms} SMs", flush=True)

    amax_bits = torch.empty(c, dtype=torch.int32, device=dev)

    def quantize():
        q = torch.empty((n, c), dtype=torch.int8, device=dev)
        scale = torch.empty((1, c), dtype=torch.float32, device=dev)
        e = lib.tod_quantize(x.data_ptr(), n, c, 7, q.data_ptr(), scale.data_ptr(),
                             amax_bits.data_ptr(), sms, stream)
        if e:
            raise RuntimeError(f"quantize launch failed: CUDA error {e}")
        return q, scale

    _, (own_ms,) = chip_smoke.own_ms(torch, [(quantize, chip_smoke.K5_PARTS)])
    q, scale = quantize()
    same = torch.equal(q, want[0]) and torch.equal(scale, want[1])
    ms, _ = chip_smoke.time_ms(quantize, torch)
    print(f"K5: {ms:.5f} ms, own {chip_smoke.fmt(own_ms)} ms (memset and both kernels); equal "
          f"to the wrapper's={same}", flush=True)
    if not same:
        raise AssertionError("K5 by the library disagrees with the wrapper")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
