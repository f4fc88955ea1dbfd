#!/usr/bin/env python3
"""An older commit's kernels beside this tree's, in one process on one card.

Run from the repository root on a machine with an NVIDIA GPU:
``python3 tools/kernel_ab.py OLD_ROOT [ROUNDS]`` (K1 and K2),
``python3 tools/kernel_ab.py --qconv OLD_ROOT`` (the int8 convolution),
``python3 tools/kernel_ab.py --cc OLD_ROOT`` (the connected-components
labels) or ``python3 tools/kernel_ab.py --track OLD_ROOT`` (the tracker),
where OLD_ROOT is a checkout of a commit from before the kernels were
redesigned (for example unpacked by ``git archive``).

K1 and K2: serve and stream with the old kernels and with this tree's, in
turns, to tell the two kernels' effect on the host-clock metrics apart
from the host's run-to-run noise.  Its ``tod_tpu_torch/csrc/mask_assembly.cu``
and ``connections.cu`` are built with this tree's nvcc flags into
``build/tod_tpu_torch/ab/`` and called through their C interfaces
(``tod_mask_assembly(protos, coeffs, boxes, out, b, n, hm, wm, k, stream)``,
``tod_connections(height, conn, pos, h, w, stream)``, the planner keeping
``conn``); every other module, the Python around both kernels included, is
this tree's.  The "old" arm binds those two into ``models.yolact`` and
``planner.relax``; the "new" arm binds this tree's wrappers back.

Each of ROUNDS rounds (default 8) runs each arm once, alternating which goes
first, on engines built once:
- serve: ``chip_smoke.N_FRAMES`` frames of ``Engine.serve_step_plan`` at
  ``PipelineConfig()``, host clock from the call to the plan on the host;
  the median;
- stream: ``run_supervised`` at the app's configuration with ``pallas_bump``
  (model at 480x640), ``chip_smoke.STREAM_FRAMES`` frames, a plan every 4th,
  2 in flight: fps, ``frame`` p50 and ``dispatch_plan`` p50;
- host: ``run_supervised`` with the native planner (only K1 on the card),
  ``chip_smoke.N_FRAMES`` frames, every one planned: fps.
Before the rounds the old kernels are held against the new ones (K1 within
2e-6 with an identical crop, K2's planes bit for bit, NaN included), and
each arm's launches are counted, so that a round ran the kernels it names.
The last line is a JSON object with every reading by arm and metric.

The int8 convolution: the old ``tod_tpu_torch/csrc/qconv.cu`` (PR 13's
``tod_qconv(x, wq, w_scale, sx, sx_stride, bias, y, dtype, b, cin, h, w,
cout, k, stride, pad_t, pad_l, ho, wo, groups, divide, bn, stream)`` entry,
the OIHW kernel as it is, or a later one's ``tod_qconv_dense``, launched by
this tree's ``kernels.qconv._launch``) beside this tree's
``kernels.qconv.qconv`` with the packed kernel:
1. the two held against each other, bit for bit, at every dense conv site
   of the default 256x320 forward (batch 1, bf16);
2. the ProtoNet 3x3 site, (1, 128, 32, 40) -> 128, K = 1152, bf16: each
   arm's CUDA-event time (``chip_smoke.time_ms``) in turns old, new, new,
   old, and each arm's own device time (``chip_smoke.own_ms``), beside
   ``torch._int_mm`` on the im2col'd operands, the bf16 cuDNN conv and the
   bound;
3. the forward's dense sites, each timed by events and summed by its calls
   (68 launches a forward), old, new, new, old.
The last line is a JSON object with every reading and the card's name and
power limit.

The connected-components labels (``--cc``): the old
``tod_tpu_torch/csrc/cc_labels.cu`` (its ``tod_cc_labels(mask, labels, h,
w, stream)`` entry) beside this tree's ``kernels.cc_labels.root_labels``,
held bit for bit on ``chip_smoke.py``'s masks at 480x640 and 479x641 and on
the synthetic frame's balls, then timed at the balls (the main path's input)
in turns old, new, new, old by CUDA events, with each arm's own device time
and each of its launches' own time from the profiler, beside the bound.
The same passes in one cooperative launch (``tools/cc_coop.cu``, two grid
barriers in place of the launch boundaries) are held bit for bit too and
timed in turns with this tree's three launches (new, coop, coop, new).

The tracker (``--track``): the old ``tod_tpu_torch/csrc/track.cu`` (its
``tod_track`` entry, the same arguments as this tree's) beside this tree's
``kernels.track.track_banks``, held bit for bit (banks and seeds) on
``chip_smoke.py``'s random banks at N = 1, 4, 16 and 33, its tie banks and
its 64-step sequence, then timed at N = 1, 4 and 16 in turns old, new, new,
old by CUDA events, with each arm's own device time, beside the bound.
Each prints, as its last line, a JSON object with every reading and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIGNATURES = {
    "mask_assembly": ("tod_mask_assembly", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p]),
    "connections": ("tod_connections", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p]),
    "qconv": ("tod_qconv", [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 15 + [ctypes.c_void_p]),
    "cc_labels": ("tod_cc_labels", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "track": ("tod_track", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 9
              + [ctypes.c_void_p]),
}
SIGNATURES_CC_COOP = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
OLD_CC_PARTS = ("cc_init_kernel", "cc_merge_kernel", "cc_flatten_kernel")
OLD_TRACK_KERNEL = "track_kernel"
PROTONET = ((128, 32, 40), (128, 128, 3, 3), 1, 1, False)


def build_old(old_root: pathlib.Path, names) -> dict:
    """Compile the old commit's sources of ``names`` side by side -> entry
    points."""
    libs = build_old_libs(old_root, names)
    fns = {}
    for name, lib in libs.items():
        entry, argtypes = SIGNATURES[name]
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def build_old_libs(old_root: pathlib.Path, names) -> dict:
    """Compile the old commit's sources of ``names`` side by side -> the
    loaded libraries."""
    from tod_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = out / f"lib{name}_old.so"
        src = old_root / "tod_tpu_torch" / "csrc" / f"{name}.cu"
        jobs[name] = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                       str(src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True), so
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the old {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def old_wrappers(torch, fns):
    """The old kernels behind this tree's wrappers' signatures, each counting
    its launches."""

    def assemble_crop_masks(protos, coeffs, boxes):
        b, hm, wm, k = protos.shape
        n = coeffs.shape[1]
        out = torch.empty((b, n, hm, wm), dtype=torch.float32, device=protos.device)
        err = fns["mask_assembly"](protos.data_ptr(), coeffs.data_ptr(), boxes.data_ptr(),
                                   out.data_ptr(), b, n, hm, wm, k,
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old mask_assembly launch failed: CUDA error {err}")
        assemble_crop_masks.launches += 1
        return out

    def connection_planes(height):
        h, w = height.shape
        conn = torch.empty((h, w, 8), dtype=torch.float32, device=height.device)
        pos = torch.empty((h, w, 3), dtype=torch.float32, device=height.device)
        err = fns["connections"](height.data_ptr(), conn.data_ptr(), pos.data_ptr(), h, w,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old connections launch failed: CUDA error {err}")
        connection_planes.launches += 1
        return conn

    assemble_crop_masks.launches = connection_planes.launches = 0
    return assemble_crop_masks, connection_planes


def old_qconv(torch, old_root: pathlib.Path) -> tuple:
    """The old int8 kernel behind this tree's ``qconv`` signature (dense
    sites) -> (the call, its kernel's name).  An old library with this
    tree's C interface (``tod_qconv_dense``, the packed kernel) is launched
    by this tree's ``_launch``; PR 13's (``tod_qconv``, the OIHW kernel as
    it is) by the call below, which does not read the packed kernel."""
    from unittest import mock

    from tod_tpu_torch.kernels import qconv as qk
    from tod_tpu_torch.kernels.qconv import DTYPES, _pads

    lib = build_old_libs(old_root, ["qconv"])["qconv"]
    if hasattr(lib, "tod_qconv_dense"):
        for entry, (argtypes, restype) in qk.SIGNATURES.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype

        def launch(x, kq, ws, sx, bias, stride=1, groups=1, bn=False, divide=False,
                   packed=None):
            if sx.dim() == 0:
                sx = sx.reshape(1).expand(x.shape[0])
            with mock.patch.object(qk._build, "load", return_value=lib):
                return qk._launch(x, kq, ws, sx, bias, stride, groups, bn, divide, packed)

        return launch, "qconv_wgmma_kernel"
    fn = lib.tod_qconv
    fn.argtypes, fn.restype = SIGNATURES["qconv"][1], ctypes.c_int

    def qconv(x, kq, ws, sx, bias, stride=1, groups=1, bn=False, divide=False, packed=None):
        b, cin, h, w = x.shape
        cout, _, k, _ = kq.shape
        (pt, pb), (pl, pr) = _pads(x, k, stride)
        ho, wo = (h + pt + pb - k) // stride + 1, (w + pl + pr - k) // stride + 1
        y = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
        if sx.dim() == 0:
            sx = sx.reshape(1).expand(b)
        err = fn(x.data_ptr(), kq.data_ptr(), ws.data_ptr(), sx.data_ptr(),
                 0 if sx.stride(0) == 0 else 1, bias.data_ptr(), y.data_ptr(), DTYPES[x.dtype],
                 b, cin, h, w, cout, k, stride, pt, pl, ho, wo, groups, int(divide), int(bn),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old qconv launch failed: CUDA error {err}")
        return y

    return qconv, "qconv_dense_kernel"


def qconv_ab(old_root: pathlib.Path) -> int:
    """The int8 convolution by the old commit's kernel and by this tree's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels.qconv import pack_kernel, qconv

    smi = cs.nvidia_smi_line()
    cs.log(smi)
    _build.build(["qconv"])
    old, old_kernel = old_qconv(torch, old_root)
    arms = {"old": old, "new": qconv}
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(14)

    sites = {site: n for site, n in cs.forward_conv_sites(torch, np).items() if site[3] == 1}
    inputs = {}
    for site in sites:
        x, kq, ws, sx, bias = cs.qconv_inputs(torch, gen, device, 1, site, torch.bfloat16)
        inputs[site] = (x, kq, ws, sx[0], bias, site[2], 1, site[4], False, pack_kernel(kq))
        got = {name: fn(*inputs[site]) for name, fn in arms.items()}
        if not torch.equal(got["old"], got["new"]):
            raise AssertionError(f"the old and new kernels disagree at {site}")
    cs.log(f"  old and new kernels equal bit for bit at the {len(sites)} distinct dense sites "
           f"({sum(sites.values())} calls a forward)")

    proto = inputs[PROTONET]
    events = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        events[name].append(cs.time_ms(lambda fn=arms[name]: fn(*proto), torch)[0])
    floor, own = cs.own_ms(torch, [(lambda: arms["old"](*proto), old_kernel),
                                   (lambda: arms["new"](*proto), "qconv_wgmma_kernel")])
    x, kq = proto[0], proto[1]
    m, k, n = 32 * 40, 128 * 9, 128
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=device)
    bmat = kq.reshape(n, k).t()
    try:
        int_mm_ms = cs.time_ms(lambda: torch._int_mm(a, bmat), torch)[0]
    except RuntimeError:
        bmat = bmat.contiguous()
        int_mm_ms = cs.time_ms(lambda: torch._int_mm(a, bmat), torch)[0]
    wb = kq.to(torch.bfloat16)
    cudnn_ms = cs.time_ms(lambda: torch.nn.functional.conv2d(x, wb, None, 1, 1), torch)[0]
    bound, by = cs.bound_ms(2 * 128 * 32 * 40 * 2 + 128 * k + 3 * 128 * 4, 2.0 * m * n * k,
                            cs.INT8_OPS)
    cs.log(f"  ProtoNet 3x3 (1, 128, 32, 40) -> 128, bf16, events old / new / new / old: "
           f"{events['old'][0]:.5f} / {events['new'][0]:.5f} / {events['new'][1]:.5f} / "
           f"{events['old'][1]:.5f} ms; own old {cs.fmt(own[0])}, new {cs.fmt(own[1])} (an "
           f"empty kernel {cs.fmt(floor)}); torch._int_mm {int_mm_ms:.5f}, bf16 cuDNN conv "
           f"{cudnn_ms:.5f}, bound {bound:.6f} ({by})")

    forward = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        total = 0.0
        for site, calls in sites.items():
            total += calls * cs.time_ms(lambda fn=arms[name], s=site: fn(*inputs[s]), torch,
                                        n=20)[0]
        forward[name].append(total)
    cs.log(f"  the forward's {sum(sites.values())} dense launches by events, summed by calls, "
           f"old / new / new / old: {forward['old'][0]:.4f} / {forward['new'][0]:.4f} / "
           f"{forward['new'][1]:.4f} / {forward['old'][1]:.4f} ms")
    cs.log(smi)
    print(json.dumps({
        "device": smi, "protonet": {"events_ms": events, "own_ms": {"old": own[0], "new": own[1]},
                                    "empty_own_ms": floor, "int_mm_ms": int_mm_ms,
                                    "cudnn_bf16_ms": cudnn_ms, "bound_ms": bound},
        "forward_dense_ms": forward, "dense_launches": sum(sites.values())}))
    return 0


def in_turns(cs, torch, arms, make_call, order=("old", "new", "new", "old")) -> dict:
    """Each arm's CUDA-event time (``chip_smoke.time_ms``) in the turns of
    ``order`` -> {arm: [its times in turn]}."""
    events = {name: [] for name in dict.fromkeys(order)}
    for name in order:
        events[name].append(cs.time_ms(make_call(arms[name]), torch)[0])
    return events


def cc_ab(old_root: pathlib.Path) -> int:
    """The connected-components labels by the old commit's kernel and by
    this tree's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tod_tpu_torch.core.config import CameraConfig
    from tod_tpu_torch.kernels import _build
    from tod_tpu_torch.kernels.cc_labels import TILE, root_labels
    from tod_tpu_torch.runtime.frame_source import synth_frame_numpy

    smi = cs.nvidia_smi_line()
    cs.log(smi)
    coop_so = _build.BUILD_DIR / "ab" / "libcc_coop.so"
    coop_so.parent.mkdir(parents=True, exist_ok=True)
    coop_build = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(coop_so),
                                   str(ROOT / "tools" / "cc_coop.cu")], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
    fn = build_old(old_root, ["cc_labels"])["cc_labels"]
    coop_log, _ = coop_build.communicate()
    if coop_build.returncode:
        raise RuntimeError(f"nvcc failed for tools/cc_coop.cu:\n{coop_log}")
    coop_fn = ctypes.CDLL(str(coop_so)).tod_cc_coop
    coop_fn.argtypes, coop_fn.restype = SIGNATURES_CC_COOP, ctypes.c_int

    def coop(mask):
        h, w = mask.shape
        tiles = -(-h // TILE) * -(-w // TILE)
        buf = torch.empty(h * w + tiles, dtype=torch.int32, device=mask.device)
        err = coop_fn(mask.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * h * w, h, w,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cooperative cc launch failed: CUDA error {err}")
        return buf[: h * w].view(h, w)

    def old(mask):
        h, w = mask.shape
        labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
        err = fn(mask.data_ptr(), labels.data_ptr(), h, w, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old cc_labels launch failed: CUDA error {err}")
        return labels

    arms = {"old": old, "new": root_labels, "coop": coop}
    device = torch.device("cuda", 0)
    gen = np.random.default_rng(15)
    masks = {}
    for h, w in ((480, 640), (479, 641)):
        for name, m in {**cs.cc_masks(np, gen, h, w), **cs.tile_masks(np, gen, h, w)}.items():
            masks[f"{name} {h}x{w}"] = m
    cam = CameraConfig()
    f = synth_frame_numpy(0, 3, cam.height, cam.width)
    masks["synthetic balls"] = cs.color_class_map(np, f.rgb) == 3
    for name, m in masks.items():
        card = torch.from_numpy(m).to(device)
        want = old(card)
        for arm in ("new", "coop"):
            if not torch.equal(want, arms[arm](card)):
                raise AssertionError(f"the old and {arm} cc kernels disagree on {name}")
    cs.log(f"  old, new and cooperative cc kernels equal bit for bit on {len(masks)} masks: "
           f"{list(masks)}")

    balls = torch.from_numpy(masks["synthetic balls"]).to(device)
    h, w = balls.shape
    events = in_turns(cs, torch, arms, lambda fn: lambda: fn(balls))
    coop_events = in_turns(cs, torch, arms, lambda fn: lambda: fn(balls),
                           ("new", "coop", "coop", "new"))
    calls = [(lambda: old(balls), OLD_CC_PARTS), (lambda: root_labels(balls), cs.CC_PARTS),
             (lambda: coop(balls), "cc_coop_kernel")]
    calls += [(lambda: old(balls), part) for part in OLD_CC_PARTS]
    calls += [(lambda: root_labels(balls), part) for part in cs.CC_PARTS]
    floor, own = cs.own_ms(torch, calls)
    parts = {"old": dict(zip(OLD_CC_PARTS, own[3:6])), "new": dict(zip(cs.CC_PARTS, own[6:9]))}
    bound, by = cs.bound_ms(5.0 * h * w, 8.0 * h * w, cs.ALU_OPS)
    cs.log(f"  cc_labels at the synthetic balls ({h}x{w}, {int(balls.sum())} pixels), events old / "
           f"new / new / old: {events['old'][0]:.5f} / {events['new'][0]:.5f} / "
           f"{events['new'][1]:.5f} / {events['old'][1]:.5f} ms; own old {cs.fmt(own[0])} "
           f"({', '.join(f'{k} {cs.fmt(v)}' for k, v in parts['old'].items())}), new "
           f"{cs.fmt(own[1])} ({', '.join(f'{k} {cs.fmt(v)}' for k, v in parts['new'].items())});"
           f" an empty kernel {cs.fmt(floor)}; bound {bound:.6f} ({by})")
    cs.log(f"  the same passes in one cooperative launch, events new / coop / coop / new: "
           f"{coop_events['new'][0]:.5f} / {coop_events['coop'][0]:.5f} / "
           f"{coop_events['coop'][1]:.5f} / {coop_events['new'][1]:.5f} ms; own coop "
           f"{cs.fmt(own[2])}")
    cs.log(smi)
    print(json.dumps({"device": smi, "cc_labels": {
        "events_ms": events, "own_ms": {"old": own[0], "new": own[1]}, "own_parts_ms": parts,
        "empty_own_ms": floor, "bound_ms": bound, "bound_by": by,
        "cooperative": {"events_ms": coop_events, "own_ms": own[2]}}}))
    return 0


def track_ab(old_root: pathlib.Path) -> int:
    """The tracker by the old commit's kernel and by this tree's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tod_tpu_torch.core.config import TrackerConfig
    from tod_tpu_torch.kernels.track import track_banks

    smi = cs.nvidia_smi_line()
    cs.log(smi)
    fn = build_old(old_root, ["track"])["track"]
    cfg = TrackerConfig(enabled=True)
    q = cfg.accel_var

    def old(tracks, balls, cfg, max_balls):
        n, k, _ = tracks.shape
        seeds = torch.empty((n, max_balls, 4), dtype=torch.float32, device=tracks.device)
        err = fn(tracks.data_ptr(), balls.data_ptr(), seeds.data_ptr(), n, k, balls.shape[1],
                 max_balls, q * 0.25, q * 0.5, q, cfg.gate**2, cfg.meas_var, cfg.vel0_var,
                 cfg.min_pixels, float(cfg.max_misses), float(cfg.min_hits),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old track launch failed: CUDA error {err}")
        return seeds

    arms = {"old": old, "new": track_banks}
    device = torch.device("cuda", 0)
    gen = np.random.default_rng(15)
    cases = 0
    for n in (1, 4, 16, 33):
        for make in (cs.random_banks, cs.tie_banks):
            banks, balls = make(np, gen, n)
            b = torch.from_numpy(balls).to(device)
            got = {}
            for name, arm in arms.items():
                card = torch.from_numpy(banks).to(device)
                got[name] = (card, arm(card, b, cfg, 100))
            if not all(torch.equal(x, y) for x, y in zip(got["old"], got["new"])):
                raise AssertionError(f"the old and new trackers disagree at N={n} "
                                     f"({make.__name__})")
            cases += 1
    seq = torch.from_numpy(cs.track_sequence(np, gen, 4, cs.TRACK_STEPS)).to(device)
    banks = {name: torch.zeros((4, 8, 10), device=device) for name in arms}
    for s in range(cs.TRACK_STEPS):
        seeds = {name: arm(banks[name], seq[s], cfg, 100) for name, arm in arms.items()}
        if not (torch.equal(banks["old"], banks["new"])
                and torch.equal(seeds["old"], seeds["new"])):
            raise AssertionError(f"the old and new trackers disagree at step {s} of the sequence")
    cs.log(f"  old and new trackers equal bit for bit (banks and seeds) on {cases} bank sets "
           f"and a {cs.TRACK_STEPS}-step sequence of 4 banks")

    readings = {}
    for n in (1, 4, 16):
        banks, balls = cs.random_banks(np, gen, n)
        card = torch.from_numpy(banks).to(device)
        b = torch.from_numpy(balls).to(device)
        events = in_turns(cs, torch, arms, lambda fn: lambda: fn(card, b, cfg, 100))
        floor, own = cs.own_ms(torch, [(lambda: old(card, b, cfg, 100), OLD_TRACK_KERNEL),
                                       (lambda: track_banks(card, b, cfg, 100), cs.TRACK_KERNEL)])
        bound, by = cs.bound_ms(2 * 4 * n * (8 * 10 + 100 * 4), 0.0)
        readings[n] = {"events_ms": events, "own_ms": {"old": own[0], "new": own[1]},
                       "empty_own_ms": floor, "bound_ms": bound, "bound_by": by}
        cs.log(f"  track N={n}, events old / new / new / old: {events['old'][0]:.5f} / "
               f"{events['new'][0]:.5f} / {events['new'][1]:.5f} / {events['old'][1]:.5f} ms; "
               f"own old {cs.fmt(own[0])}, new {cs.fmt(own[1])} (an empty kernel "
               f"{cs.fmt(floor)}); bound {bound:.7f} ({by})")
    cs.log(smi)
    print(json.dumps({"device": smi, "track": readings}))
    return 0


MODES = {"--qconv": qconv_ab, "--cc": cc_ab, "--track": track_ab}


def main(argv: list[str]) -> int:
    mode = MODES.get(argv[0]) if argv else None
    if mode:
        argv = argv[1:]
    if not 1 <= len(argv) <= (1 if mode else 2):
        print("usage: kernel_ab.py OLD_ROOT [ROUNDS] | kernel_ab.py --qconv|--cc|--track "
              "OLD_ROOT", file=sys.stderr)
        return 2
    old_root, rounds = pathlib.Path(argv[0]).resolve(), int(argv[1]) if len(argv) > 1 else 8
    sys.path.insert(0, str(ROOT))
    if mode:
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: CUDA is not available", file=sys.stderr)
            return 2
        return mode(old_root)
    import numpy as np
    import torch

    import chip_smoke
    from tod_tpu_torch.core.config import (GeometryConfig, ModelConfig, PipelineConfig,
                                           PlannerConfig)
    from tod_tpu_torch.core.weights import load_pinned
    from tod_tpu_torch.kernels import connections, mask_assembly
    from tod_tpu_torch.models import yolact
    from tod_tpu_torch.ops.preprocess import pack_frame
    from tod_tpu_torch.planner import relax
    from tod_tpu_torch.runtime.engine import Engine
    from tod_tpu_torch.runtime.frame_source import SyntheticSource
    from tod_tpu_torch.serve.server import PathStore

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    old_k1, old_k2 = old_wrappers(torch, build_old(old_root, ["mask_assembly", "connections"]))
    new_k1, new_k2 = mask_assembly.assemble_crop_masks, connections.connection_planes
    arms = {"old": (old_k1, old_k2), "new": (new_k1, new_k2)}

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    args = chip_smoke.k1_inputs(torch, np, rng, dev, 1, 64, 80, 32, 32)
    got, want = old_k1(*args), new_k1(*args)
    hm = rng.uniform(0, 300, (480, 640)).astype(np.float32)
    hm[rng.random(hm.shape) < 0.01] = np.nan
    height = torch.from_numpy(hm).to(dev)
    a, b = old_k2(height), new_k2(height)
    k1_err = (got - want).abs().max().item()
    k2_same = bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    print(f"old against new: K1 max_abs_err {k1_err:.3e} (tol 2e-6), crop identical "
          f"{torch.equal(got == 0, want == 0)}; K2 planes bitwise equal {k2_same}", flush=True)
    if not (k1_err <= 2e-6 and torch.equal(got == 0, want == 0) and k2_same):
        raise AssertionError("the old kernels disagree with the new ones")

    def bind(arm):
        yolact.assemble_crop_masks, relax.connection_planes = arms[arm]

    state = load_pinned()
    serve_cfg = PipelineConfig()
    stream_cfg = PipelineConfig(model=ModelConfig(input_size=(480, 640)),
                                geometry=GeometryConfig(pallas_bump=True))
    host_cfg = PipelineConfig(planner=PlannerConfig(backend="native"))
    serve = Engine(serve_cfg, state, device="cuda")
    stream = Engine(stream_cfg, state, device="cuda")
    host = Engine(host_cfg, state, device="cuda")
    frames = [torch.from_numpy(pack_frame(f.rgb, f.depth)).pin_memory()
              for f in SyntheticSource(serve_cfg.camera, seed=0,
                                       n_frames=chip_smoke.N_FRAMES).frames()]
    for arm in arms:  # cuDNN plans, kernel loads, both arms' first launches
        bind(arm)
        serve.serve_step_plan(frames[0]).cpu()
        stream.warmup()
        host.warmup()

    def supervised(eng, cfg, n, plan_every):
        return eng.run_supervised(lambda: SyntheticSource(cfg.camera, n_frames=n), n_frames=n,
                                  path_store=PathStore(), max_restarts=0, stall_timeout_s=10.0,
                                  plan_every=plan_every, max_inflight=2, warmup=False)

    def run(arm):
        bind(arm)
        k1, k2 = arms[arm]
        other = arms["new" if arm == "old" else "old"]
        before = (k1.launches, k2.launches, other[0].launches, other[1].launches)
        per_frame = []
        for packed in frames:
            t = time.perf_counter()
            serve.serve_step_plan(packed).cpu()
            per_frame.append(1e3 * (time.perf_counter() - t))
        s = supervised(stream, stream_cfg, chip_smoke.STREAM_FRAMES, 4)
        h = supervised(host, host_cfg, chip_smoke.N_FRAMES, 1)
        after = (k1.launches, k2.launches, other[0].launches, other[1].launches)
        ran = [y - x for x, y in zip(before, after)]
        if min(ran[:2]) == 0 or max(ran[2:]) != 0:
            raise AssertionError(f"arm {arm} launched (K1, K2, the other arm's K1, K2) {ran}")
        p50 = {k: v["p50_ms"] for k, v in s["stages"].items() if v.get("n")}
        return {"serve_frame_ms": statistics.median(per_frame), "stream_fps": s["fps"],
                "stream_frame_p50_ms": p50["frame"],
                "stream_dispatch_plan_p50_ms": p50["dispatch_plan"], "host_fps": h["fps"]}

    readings = {arm: [] for arm in arms}
    for r in range(rounds):
        for arm in ("old", "new") if r % 2 == 0 else ("new", "old"):
            m = run(arm)
            readings[arm].append(m)
            print(f"round {r} {arm}: " + ", ".join(f"{k} {v:.3f}" for k, v in m.items()),
                  flush=True)
    metrics = list(readings["old"][0])
    lower_is_better = {"serve_frame_ms", "stream_frame_p50_ms", "stream_dispatch_plan_p50_ms"}
    for k in metrics:
        old = [m[k] for m in readings["old"]]
        new = [m[k] for m in readings["new"]]
        wins = sum(n < o if k in lower_is_better else n > o for o, n in zip(old, new))
        print(f"{k}: median old {statistics.median(old):.3f} new {statistics.median(new):.3f}; "
              f"range old {min(old):.3f}-{max(old):.3f} new {min(new):.3f}-{max(new):.3f}; "
              f"new better in {wins} of {rounds} rounds", flush=True)
    print(json.dumps({arm: {k: [m[k] for m in ms] for k in metrics}
                      for arm, ms in readings.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
