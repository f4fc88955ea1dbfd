"""Read a cell's compared numbers over many seeds in one process: the
program as the configuration states it, or with ``--control`` its control
(the configuration's ``control`` overrides: the program's own lower
precision).  The limits in the configuration files were set from these
readings (``PERF.md``).  On the card::

    python3 benchmark/control.py --workload mnv2_train.b16 --seeds 1,2,3 --seconds 4 [--control]

Each seed prints one JSON line (its numbers, limits and notes).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("half_batch", "altered", "unchanged"),
                    help="plant a fault in the timed path (its reading must fail the check)")
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.seconds, False, args.device, time.perf_counter(),
                              control=args.control, fault=args.fault)
        res = harness.run_cell(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control, "fault": args.fault,
                          "correct": res["correct"], "checks": res["checks"],
                          "notes": res.get("notes"), "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
