"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a profiled run).  Every line also
holds ``correct``, from the comparison with the plain reference in
``benchmark/reference/``, and, last, ``checks``: each compared number with
its limit.  Exits non-zero, printing no result, where no card (or fewer
than the cell asks for) is visible, or where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (the kernel's
    start time, to its clock tick), so that set-up counts the interpreter's
    own start and every import."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.resolve(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    ctx.log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace} on "
            f"{harness.power_limit_w()}")
    result = harness.run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[bench] loaded {bad}: the run must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
