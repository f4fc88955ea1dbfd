"""A step's device timeline from ``torch.profiler``, by kernel and by
category (counterpart of ``tod_tpu/bench/profiling.py``, which parses a
``jax.profiler`` xplane).

``capture_trace`` runs a step once to warm it, then ``iters`` times under
the profiler (CPU and CUDA activities), ending in a synchronise.
``top_ops`` reads the device's activities from the profile (kernels,
copies, memsets on the card, and raises where a card's profile holds none;
on the CPU the outermost aten ops stand in for them): each kernel's own time a step by name, sums by category, the
device's busy time a step (the union of its activities), the idle share of
the profiled window and the longest idle gaps.  A profiler session slows the
host's launches, so its idle share is an upper bound on the idle share
without it.

CLI, on the card::

    python -m tod_tpu_torch.bench.profiling                    # batch-16 VGA forward
    python -m tod_tpu_torch.bench.profiling --int8             # the same, int8 model
    python -m tod_tpu_torch.bench.profiling --qvga-serve [--plan]  # the QVGA serve step
    python -m tod_tpu_torch.bench.profiling --train            # the batch-8 QVGA train step

``--train`` splits the train step into its phases (``PHASES``) by the
step's own ``train/<phase>`` spans, which open profiler ranges while a
profiler runs: each device activity falls in the phase whose range was open
when its launch started.  Nothing synchronises inside the step, so the
split is of the step as it runs.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
from collections import Counter, defaultdict

import torch

from tod_tpu_torch.kernels._build import CSRC

ITERS = 4  # profiled steps
CATEGORIES = ("convolution", "gemm", "ours", "elementwise", "reduction", "memcpy", "memset",
              "other")
_PATTERNS = (
    # "conv" but not "convert"
    ("convolution", re.compile(r"conv(?!ert)|fprop|cudnn|depthwise", re.I)),
    # nvjet: cuBLASLt's Hopper GEMM kernels
    ("gemm", re.compile(r"gemm|matmul|cublas|cutlass|nvjet|aten::(mm|bmm|addmm|linear)$", re.I)),
    ("memcpy", re.compile(r"memcpy|aten::(copy_|_to_copy|to|contiguous|clone)$", re.I)),
    ("memset", re.compile(r"memset|aten::(fill_|zero_|zeros|zeros_like|full|empty)$", re.I)),
    ("reduction", re.compile(r"reduce|softmax|sort|scan|topk|aten::(sum|amax|amin|max|min|mean|"
                             r"argmax|argmin|any|all|cumsum|scatter_reduce_?|index_add_?)$", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|^aten::", re.I)),
)


def our_kernels() -> tuple[str, ...]:
    """The names of the ``__global__`` functions in ``csrc/*.cu``."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    return tuple(sorted({name for src in CSRC.glob("*.cu")
                         for name in pattern.findall(src.read_text())}))


def category(name: str, ours: tuple[str, ...] = ()) -> str:
    """The category of a kernel (or, on the CPU, an aten op) by its name."""
    if any(re.search(rf"\b{k}\b", name) for k in ours):
        return "ours"
    for cat, pattern in _PATTERNS:
        if pattern.search(name):
            return cat
    return "other"


def capture_trace(fn, device: torch.device, iters: int = ITERS):
    """``fn()`` once, then ``iters`` times under ``torch.profiler`` (CUDA
    activities too where ``device`` is the card) ending in a synchronise
    -> the profile."""
    from torch.profiler import ProfilerActivity, profile

    card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with torch.inference_mode():
        fn()
        if card:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            if card:
                torch.cuda.synchronize()
    return prof


def _device_events(events, device: torch.device) -> list:
    """The device's activities: on the card its kernels, copies and memsets
    (a card's profile without them raises: no host time stands in for the
    card's), on the CPU the outermost aten ops."""
    from torch.autograd import DeviceType

    if device.type == "cuda":
        cuda = [e for e in events if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("stage/")]
        if not cuda:
            raise RuntimeError("the profile holds no CUDA activity: the profiler did not "
                               "trace the card")
        return cuda

    def outermost(e) -> bool:
        parent = e.cpu_parent
        while parent is not None:
            if parent.name.startswith("aten::"):
                return False
            parent = parent.cpu_parent
        return True

    return [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::") and outermost(e)]


def top_ops(prof, device: torch.device, iters: int = ITERS) -> dict:
    """``device``'s time per step in a profile of ``iters`` steps:
    ``timeline`` (``device.type``), ``wall_ms`` (the profiled window),
    ``busy_ms``, ``idle_share``, ``activities``, ``categories`` (ms by
    category), ``top`` (the 20 kernels of most own ms, with their launches
    a step) and ``gaps_ms`` (the 5 longest idle gaps in the window)."""
    events = list(prof.events())
    if not events:
        raise RuntimeError("the profile holds no events")
    acts = _device_events(events, device)
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    ours = our_kernels()
    own: Counter = Counter()
    calls: Counter = Counter()
    cats: Counter = Counter()
    for e in acts:
        us = e.time_range.elapsed_us()
        own[e.name] += us
        calls[e.name] += 1
        cats[category(e.name, ours)] += us
    busy = 0.0
    gaps = []
    end = t0
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in acts):
        if start > end:
            gaps.append(start - end)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    gaps.append(max(0.0, t1 - end))
    wall = t1 - t0
    return {
        "timeline": device.type,
        "iters": iters,
        "wall_ms": round(wall / 1e3 / iters, 4),
        "busy_ms": round(busy / 1e3 / iters, 4),
        "idle_share": round(1.0 - busy / wall, 4) if wall > 0 else None,
        "activities": len(acts) // iters,
        "categories": {c: round(cats[c] / 1e3 / iters, 4) for c in CATEGORIES if cats[c]},
        "top": [{"name": name, "ms": round(us / 1e3 / iters, 4), "count": calls[name] // iters}
                for name, us in own.most_common(20)],
        "gaps_ms": [round(g / 1e3, 4) for g in sorted(gaps, reverse=True)[:5]],
    }


def print_report(report: dict, title: str) -> None:
    print(f"== {title}: {report['busy_ms']:.3f} ms busy a step of {report['wall_ms']:.3f} ms "
          f"profiled ({report['timeline']}), idle share {report['idle_share']}, "
          f"{report['activities']} activities a step")
    print("-- by category (ms a step) --")
    for c, ms in sorted(report["categories"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.4f}  {c}")
    print("-- top kernels (own ms a step, launches a step) --")
    for row in report["top"]:
        print(f"  {row['ms']:9.4f} x{row['count']:4d}  {row['name'][:110]}")
    print(f"-- longest idle gaps (ms): {report['gaps_ms']}")


def profile_forward(batch: int = 16, device=None, int8: bool = False) -> dict:
    """Trace the flagship forward at batch ``batch``, bf16, pinned weights;
    with ``int8``, config 13's static int8 model (``configs.int8_model``)."""
    from tod_tpu_torch.bench.configs import _model, device_info, int8_model
    from tod_tpu_torch.core.config import ModelConfig
    from tod_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    hw = (480, 640)
    mcfg = ModelConfig(input_size=hw, quantized=int8)
    model = int8_model(mcfg, dev) if int8 else _model(mcfg, dev)
    x0 = torch.zeros((batch, *hw, 3), dtype=model.compute_dtype, device=dev)
    report = top_ops(capture_trace(lambda: model(x0).loc, dev), dev)
    name = f"forward_b{batch}_{hw[0]}x{hw[1]}" + ("_int8" if int8 else "")
    print_report(report, name.replace("_", " "))
    return {"profile": name, **report, "device": device_info(dev)}


def profile_flagship_forward(batch: int = 16, hw=(480, 640), device=None) -> dict:
    """The JAX package's name for :func:`profile_forward`: the batch-``batch``
    flagship forward at the VGA input (the only size it traces)."""
    if tuple(hw) != (480, 640):
        raise ValueError(f"profile_forward traces the 480x640 input, not {tuple(hw)}")
    return profile_forward(batch, device)


def profile_qvga_serve(plan: bool = False, device=None) -> dict:
    """Trace the 320x240 serve step: ``serve_step_packed`` (the frame to
    the scene's bytes), or with ``plan`` the frame+plan step
    ``serve_step_plan`` (the relaxation and the walk in the same
    timeline), on a synthetic frame already on the device."""
    from tod_tpu_torch.bench.configs import _engine, _pipeline_cfg, device_info
    from tod_tpu_torch.core.device import resolve_device
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.runtime.frame_source import SyntheticSource

    dev = resolve_device(device)
    eng = _engine(_pipeline_cfg((240, 320)), dev)
    eng.warmup()
    frame = next(SyntheticSource(eng.cfg.camera, seed=0, n_frames=1).frames())
    packed = torch.from_numpy(pack_frame(frame.rgb, frame.depth)).to(dev)
    step = eng.serve_step_plan if plan else eng.serve_step_packed
    report = top_ops(capture_trace(lambda: step(packed), dev), dev)
    title = "320x240 frame+plan step" if plan else "320x240 serve step"
    print_report(report, title)
    return {"profile": "qvga_serve_plan" if plan else "qvga_serve", **report,
            "device": device_info(dev)}


PHASES = ("augment", "forward", "loss", "backward", "optimizer")
TRAIN_HW = (240, 320)  # bench config 11's size


def by_category(own: Counter, ours: tuple[str, ...]) -> Counter:
    """Own time summed by each kernel's category."""
    cats: Counter = Counter()
    for name, us in own.items():
        cats[category(name, ours)] += us
    return cats


def phase_split(prof, device: torch.device, phases=PHASES) -> tuple[list, list]:
    """The ``train/<phase>`` ranges of a profile, ``(start, end, phase)``
    in ns, and the device's activities, ``(name, start, end, phase)``, each
    in the phase whose range was open when its launch started (None
    outside them).  By launch time, not by thread: the backward launches
    from autograd's device thread while the main thread waits inside
    ``train/backward``.  On the CPU the outermost aten ops stand in for the
    activities, each launched at its own start."""
    names = {f"train/{p}": p for p in phases}
    ranges, launches, ops, cuda, aten = [], {}, {}, [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if kind == "CPU":
            if name in names:
                ranges.append((start, end, names[name]))
            elif name.startswith("aten::"):
                aten.append((e.start_thread_id(), start, end, name))
            if e.correlation_id():
                # a runtime call (cudaLaunchKernel, cudaMemcpyAsync...) or the op
                (launches if name.startswith("cu") else ops)[e.correlation_id()] = start
        elif kind == "CUDA" and not e.is_user_annotation():
            cuda.append((name, start, end, e.correlation_id(), e.linked_correlation_id()))
    if device.type == "cuda":
        if not cuda:
            raise RuntimeError("the profile holds no CUDA activity: the profiler did not "
                               "trace the card")
        acts = [(name, start, end, launches.get(corr) or ops.get(linked))
                for name, start, end, corr, linked in cuda]
    else:
        acts, open_until = [], {}
        for thread, start, end, name in sorted(aten, key=lambda a: (a[0], a[1], -a[2])):
            if start >= open_until.get(thread, start):
                acts.append((name, start, end, start))
                open_until[thread] = end
    ranges.sort()
    starts = [r[0] for r in ranges]

    def phase_at(t):
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return ranges[i][2] if i >= 0 and ranges[i][1] >= t else None

    return ranges, [(name, start, end, phase_at(t)) for name, start, end, t in acts]


def profile_train_step(batch: int = 8, hw=TRAIN_HW, iters: int = ITERS, device=None) -> dict:
    """Trace ``iters`` train steps of the flagship at ``hw`` and batch
    ``batch`` (synthetic data, seed 0) after a warm step, phase by phase
    (``phase_split``: the step's own ``train/*`` spans, nothing
    synchronised inside it): each phase's device busy ms a step (the union
    of the activities it launched), its host ms, its share of the step's
    busy time, its activities and top kernels, and the whole step's
    ``top_ops`` report."""
    from torch.profiler import ProfilerActivity, profile

    from tod_tpu_torch.bench.configs import device_info, sync
    from tod_tpu_torch.core.config import ModelConfig, TrainConfig
    from tod_tpu_torch.core.device import resolve_device
    from tod_tpu_torch.train import SyntheticDetectionData, Trainer
    from tod_tpu_torch.train.trainer import device_batch

    dev = resolve_device(device)
    trainer = Trainer(ModelConfig(input_size=hw), TrainConfig(batch_size=batch), device=dev)
    b = device_batch(SyntheticDetectionData(hw, batch_size=batch, seed=0).next_batch(), dev)
    trainer.train_step(b)  # warm: cuDNN plans
    sync(dev)
    card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        for _ in range(iters):
            trainer.train_step(b)
        sync(dev)
    ranges, acts = phase_split(prof, dev)
    ours = our_kernels()
    busy, host, count = defaultdict(float), defaultdict(float), Counter()
    kernels: dict[str, Counter] = defaultdict(Counter)
    for start, end, phase in ranges:
        host[phase] += end - start
    for phase in PHASES:
        mine = sorted((start, end) for _, start, end, p in acts if p == phase)
        last = float("-inf")
        for start, end in mine:
            busy[phase] += max(0, end - max(start, last))
            last = max(last, end)
    for name, start, end, phase in acts:
        if phase is not None:
            count[phase] += 1
            kernels[phase][name] += (end - start) / 1e3
    total = sum(busy.values())
    phases = {
        phase: {
            "busy_ms": round(busy[phase] / 1e6 / iters, 4),
            "host_ms": round(host[phase] / 1e6 / iters, 4),
            "share": round(busy[phase] / total, 4) if total else None,
            "activities": count[phase] // iters,
            "categories": {c: round(us / 1e3 / iters, 4)
                           for c, us in by_category(kernels[phase], ours).most_common()},
            "top": [{"name": n[:110], "ms": round(us / 1e3 / iters, 4)}
                    for n, us in kernels[phase].most_common(5)],
        }
        for phase in PHASES
    }
    report = top_ops(prof, dev, iters)
    name = f"train_step_b{batch}_{hw[0]}x{hw[1]}"
    print_report(report, name.replace("_", " "))
    print("-- by phase (device busy ms, host ms a step, share of busy) --")
    for phase, row in phases.items():
        print(f"  {phase:10s} {row['busy_ms']:9.4f} {row['host_ms']:9.4f} {row['share']}  "
              f"{row['activities']} activities; top "
              + ", ".join(f"{k['name'][:40]} {k['ms']}" for k in row["top"][:3]))
    return {"profile": name, "phases": phases, **report, "device": device_info(dev)}


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--qvga-serve", action="store_true", help="the 320x240 serve step")
    p.add_argument("--plan", action="store_true", help="the frame+plan step")
    p.add_argument("--train", action="store_true", help="the train step")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--int8", action="store_true", help="the forward of the int8 model")
    args = p.parse_args(argv)
    if args.train:
        report = profile_train_step(batch=args.batch if args.batch != 16 else 8, hw=TRAIN_HW,
                                    device=device)
    elif args.qvga_serve or args.plan:
        report = profile_qvga_serve(plan=args.plan, device=device)
    else:
        report = profile_forward(batch=args.batch, device=device, int8=args.int8)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
