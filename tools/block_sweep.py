#!/usr/bin/env python3
"""Time the relaxation and path-walk kernels at several block shapes.

Run from the repository root on a machine with an NVIDIA GPU:
``python3 tools/block_sweep.py``.  Each kernel's source is compiled once per
shape (threads per block, resident blocks per SM) with ``-DTOD_THREADS``
and ``-DTOD_BLOCKS_PER_SM`` into ``build/tod_tpu_torch/sweep/``, its output is
checked against the committed kernel's on the same inputs, and its device
time is the median of CUDA events over 20 calls (50 for the walk), as
``chip_smoke.py`` times kernels.  The inputs are ``chip_smoke.py``'s: a
480x640 rolling height map with two seeds, and the walk from the robot's
start node over its relaxation with max_steps 2048.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {  # (threads per block, blocks per SM)
    "relax": [(256, 8), (256, 2), (512, 2), (512, 1), (1024, 1)],
    "path_walk": [(256, 8), (256, 1), (512, 1), (1024, 2), (1024, 1)],
}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels.path_walk import SIGNATURES as WALK_SIG
    from tod_tpu_torch.kernels.path_walk import walk_path
    from tod_tpu_torch.kernels.relax import SIGNATURES as RELAX_SIG
    from tod_tpu_torch.kernels.relax import bellman_ford_grid
    from tod_tpu_torch.planner.dijkstra import start_node_yx

    if not torch.cuda.is_available():
        print("block_sweep: CUDA is not available", file=sys.stderr)
        return 2
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, shapes in SHAPES.items():
        for threads, per_sm in shapes:
            so = out / f"lib{name}_{threads}_{per_sm}.so"
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DTOD_THREADS={threads}",
                   f"-DTOD_BLOCKS_PER_SM={per_sm}", "-o", str(so), str(_build.CSRC / f"{name}.cu")]
            jobs[name, threads, per_sm] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so
    fns, regs = {}, {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs[key] = re.search(r"Used (\d+) registers", log).group(1)
        signatures = RELAX_SIG if key[0] == "relax" else WALK_SIG
        entry, (argtypes, restype) = next(iter(signatures.items()))
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes, fn.restype = argtypes, restype
        fns[key] = fn
    print(chip_smoke.nvidia_smi_line(), flush=True)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    height, conns, seed = chip_smoke.relax_inputs(torch, np, rng, dev, 480, 640,
                                                  [(20, 100), (200, 600)])
    h, w = height.shape
    want = bellman_ford_grid(height, conns, seed)

    def relax(fn):
        dist, scratch = (torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(2))
        next_dir = torch.empty((h, w), dtype=torch.int64, device=dev)
        sweeps = torch.empty((), dtype=torch.int32, device=dev)
        flags = torch.empty(2049, dtype=torch.int32, device=dev)
        err = fn(height.data_ptr(), conns.data_ptr(), seed.data_ptr(), dist.data_ptr(),
                 scratch.data_ptr(), next_dir.data_ptr(), flags.data_ptr(), sweeps.data_ptr(),
                 h, w, 2048, stream)
        if err:
            raise RuntimeError(f"relax launch failed: CUDA error {err}")
        return dist, next_dir, sweeps

    dist, next_dir, n_sweeps = want
    start = start_node_yx((h, w), 240)
    plan_want = walk_path(dist, next_dir, start, 2048)
    levels = (2048).bit_length()

    def walk(fn):
        plan = torch.empty((2049, 2), dtype=torch.float32, device=dev)
        succ = torch.empty(levels * h * w, dtype=torch.int32, device=dev)
        err = fn(dist.data_ptr(), next_dir.data_ptr(), succ.data_ptr(), plan.data_ptr(), h * w, w,
                 start[0] * w + start[1], 2048, levels, 0, stream)
        if err:
            raise RuntimeError(f"path_walk launch failed: CUDA error {err}")
        return plan

    for (name, threads, per_sm), fn in fns.items():
        if name == "relax":
            got = relax(fn)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms, _ = chip_smoke.time_ms(lambda: relax(fn), torch, n=20, warmup=2)
            extra = f", {1e3 * ms / int(n_sweeps):.3f} us a sweep over {int(n_sweeps)} sweeps"
        else:
            same = torch.equal(walk(fn), plan_want)
            ms, _ = chip_smoke.time_ms(lambda: walk(fn), torch)
            extra = f", {int(plan_want[0, 0])} hops"
        print(f"{name} threads={threads} blocks/SM<={per_sm} "
              f"({regs[name, threads, per_sm]} registers): {ms:.5f} ms{extra}; "
              f"equal to the committed kernel={same}", flush=True)
        if not same:
            raise AssertionError(f"{name} at {threads}x{per_sm} disagrees with the committed "
                                 "kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
