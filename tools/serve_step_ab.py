#!/usr/bin/env python3
"""The eager serve step's cost on two checkouts, in turns on one card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 tools/serve_step_ab.py OLD_ROOT [ROUNDS]
    python3 tools/serve_step_ab.py --via-op [ROUNDS]

where OLD_ROOT holds an older commit's ``tod_tpu_torch`` package (for
example unpacked there by ``git archive``).  Each of ROUNDS rounds (default
2) runs the old checkout and this one in a fresh process each, in the
order old, new, new, old, and each process prints one JSON line: the
headline's ``device_step_ms`` (128 ``serve_step_plan`` calls chained at
320x240, bf16, pinned weights, by CUDA events; three repeats) and bench
config 10's chained int8 and bf16 serve steps.  Each checkout builds its
own kernels into its own ``build/``.  The card's name and power limit come
first.

``--via-op`` measures what the kernel wrappers' direct eager call saves
over calling their ``torch.library`` op (``tod::*``, which export traces).
It first prints the host microseconds of one ``qconv`` call at an int8
MobileNetV2 site through the op and through the direct launch, in
alternating blocks in one process.  Then it copies this checkout's package
into ``build/via_op`` with every wrapper's ``is_exporting()`` route taken
always (each eager call goes through the op, which launches the same
kernel) and compares that copy ("old") with this checkout as above.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

ONE = r"""
import json, pathlib, sys
root = pathlib.Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch
from tod_tpu_torch.bench import configs
from tod_tpu_torch.ops.preprocess import pack_frame
from tod_tpu_torch.runtime.frame_source import SyntheticSource
dev = torch.device("cuda")
eng = configs._engine(configs._pipeline_cfg((240, 320)), dev)
eng.warmup()
f = next(SyntheticSource(eng.cfg.camera, seed=0, n_frames=1).frames())
packed = torch.from_numpy(pack_frame(f.rgb, f.depth)).to(dev)
steps = [configs.chained_step_s(eng.serve_step_plan, packed, 128, dev)[0] * 1e3
         for _ in range(3)]
c10 = configs.run_config(10, device=dev)
print(json.dumps({"root": str(root), "device_step_ms": [round(s, 4) for s in steps],
                  "config10": {k: c10[k] for k in ("bf16_step_ms", "int8_step_ms",
                                                   "bf16_busy_ms", "int8_busy_ms")}}))
"""


PER_CALL = r"""
import json, statistics, time
import torch
from tod_tpu_torch.kernels import qconv as q
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
x = torch.rand((1, 96, 60, 80), generator=g).to(dev, torch.bfloat16)
kq = torch.randint(-127, 128, (24, 96, 1, 1), generator=g, dtype=torch.int8).to(dev)
ws = (torch.rand(24, generator=g) * 0.01).to(dev)
sx = torch.full((1,), 0.02, device=dev).expand(1)
bias = torch.zeros(24, device=dev)
args = (x, kq, ws, sx, bias, 1, 1, False, False, q.pack_kernel(kq))
routes = {"op": q._op, "direct": q._launch}
us = {name: [] for name in routes}
for block in range(41):
    for name, fn in routes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        t = (time.perf_counter() - t0) / 200 * 1e6
        if block:  # the first block warms
            us[name].append(t)
torch.cuda.synchronize()
med = {name: statistics.median(v) for name, v in us.items()}
print(json.dumps({"qconv_host_us_a_call": {n: round(m, 3) for n, m in med.items()},
                  "spread_us": {n: [round(min(v), 3), round(max(v), 3)] for n, v in us.items()},
                  "op_minus_direct_us": round(med["op"] - med["direct"], 3)}))
"""


def via_op_copy() -> pathlib.Path:
    """This checkout's package under ``build/via_op`` with every kernel
    wrapper's eager call routed through its op."""
    out = ROOT / "build" / "via_op"
    shutil.rmtree(out, ignore_errors=True)
    pkg = out / "tod_tpu_torch"
    shutil.copytree(ROOT / "tod_tpu_torch", pkg, ignore=shutil.ignore_patterns("__pycache__"))
    routed = 0
    for path in sorted((pkg / "kernels").glob("*.py")):
        text = path.read_text()
        routed += text.count("if torch.compiler.is_exporting():")
        path.write_text(text.replace("if torch.compiler.is_exporting():", "if True:"))
    if routed < 8:
        raise RuntimeError(f"only {routed} wrapper routes found to take")
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args or len(args) > 2:
        raise SystemExit("usage: python3 tools/serve_step_ab.py OLD_ROOT|--via-op [ROUNDS]")
    rounds = int(args[1]) if len(args) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args[0] == "--via-op":
        r = subprocess.run([sys.executable, "-c", PER_CALL], capture_output=True, text=True,
                           timeout=600, cwd=ROOT)
        if r.returncode != 0:
            raise RuntimeError(f"per-call timing: rc {r.returncode}\n{r.stderr[-3000:]}")
        print(r.stdout.strip().splitlines()[-1], flush=True)
        old, arms = via_op_copy(), ("via_op", "direct")
    else:
        old, arms = pathlib.Path(args[0]).resolve(), ("old", "new")
    for _ in range(rounds):
        for root in (old, ROOT, ROOT, old):
            r = subprocess.run([sys.executable, "-c", ONE, str(root)], capture_output=True,
                               text=True, timeout=600, cwd=root)
            if r.returncode != 0:
                raise RuntimeError(f"{root}: rc {r.returncode}\n{r.stderr[-3000:]}")
            line = json.loads(r.stdout.strip().splitlines()[-1])
            line["arm"] = arms[0] if root == old else arms[1]
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
