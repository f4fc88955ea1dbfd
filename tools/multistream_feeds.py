#!/usr/bin/env python3
"""Tell apart what stalls the multistream tick at many streams: the feed
threads' per-frame Python and numpy work holding the GIL, or the tick's own
launches.

Run from the repository root on a machine with an NVIDIA GPU:
``python3 tools/multistream_feeds.py [--streams N ...] [--ticks T]
[--rounds R]`` (defaults: N = 4 and 16, T = 5, R = 2; ``--cpu`` runs on the
CPU instead, for a check of the script itself).

For each N, one ``MultiStreamEngine`` at config 16's configuration
(``bench.configs._pipeline_cfg()``: 320x240 camera, model at 240x320, bf16,
device planner, pinned weights) serves T ticks through ``run`` in each of
three arms, in turns (the order reversed every other round):

- ``synthetic``: config 16's feeds, ``PacedSource(SyntheticSource)`` at 30
  fps: each feed thread makes every frame with numpy, then packs it;
- ``prepared``: the same 30 fps pacing over 8 frames a stream made before
  the run: a feed thread only packs;
- ``synthetic_switch``: as ``synthetic`` with the interpreter's switch
  interval cut from 5 ms to 0.25 ms (``sys.setswitchinterval``): a thread
  waiting for the GIL gets it sooner.

Beside them: the tick chained with no feed running
(``bench.configs.chained_step_s``, 8 ticks) and the host ms of one
``synth_frame_numpy`` frame on this thread alone, times N x 30 frames a
second: the share of one core the synthetic feeds ask for.

Each arm prints its ticks a second, its mean tick (the tick timer) and its
fresh frames a second; the last line is a JSON object with every reading,
the card's name and its power limit.  If the GIL held by the feeds is the
stall, ``prepared`` ticks near the chained tick and ``synthetic_switch``
faster than ``synthetic``; if the tick's own launches are, all three arms
tick alike.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tod_tpu_torch.bench.configs import (  # noqa: E402
    _pipeline_cfg,
    chained_step_s,
    device_info,
    model_state,
)
from tod_tpu_torch.core.device import resolve_device  # noqa: E402
from tod_tpu_torch.runtime.frame_source import (  # noqa: E402
    PacedSource,
    SyntheticSource,
    synth_frame_numpy,
)
from tod_tpu_torch.runtime.multistream import MultiStreamEngine  # noqa: E402

CAM_FPS = 30.0
ARMS = ("synthetic", "prepared", "synthetic_switch")


class _Cycle:
    """A source that hands out frames made before the run, in a loop."""

    def __init__(self, frames):
        self._frames = frames

    def frames(self):
        i = 0
        while True:
            yield self._frames[i % len(self._frames)]
            i += 1

    def close(self) -> None:
        pass


def _sources(arm: str, cfg, n: int, prepared):
    if arm == "prepared":
        return [PacedSource(_Cycle(prepared[i]), fps=CAM_FPS) for i in range(n)]
    return [PacedSource(SyntheticSource(cfg.camera, seed=7 + i, n_frames=None), fps=CAM_FPS)
            for i in range(n)]


def run_arm(eng: MultiStreamEngine, arm: str, n_ticks: int, prepared) -> dict:
    cfg = eng.cfg
    eng.timer = type(eng.timer)()  # this arm's ticks only
    interval = sys.getswitchinterval()
    if arm == "synthetic_switch":
        sys.setswitchinterval(0.00025)
    try:
        m = eng.run(_sources(arm, cfg, eng.n_streams, prepared), n_ticks=n_ticks,
                    warmup=False, max_inflight=None)
    finally:
        sys.setswitchinterval(interval)
    tick = eng.timer.stats("tick")
    return {
        "n_ticks": m["n_ticks"],
        "ticks_per_s": m["ticks_per_s"],
        "tick_mean_ms": tick.get("mean_ms"),
        "fresh_frames_per_s": m["fresh_frames_per_s"],
    }


def synth_frame_ms(cfg, n: int = 30) -> float:
    cam = cfg.camera
    t0 = time.perf_counter()
    for t in range(n):
        synth_frame_numpy(7, t, cam.height, cam.width)
    return (time.perf_counter() - t0) / n * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check of the script)")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = _pipeline_cfg()
    state = model_state(cfg.model)
    frame_ms = synth_frame_ms(cfg)
    print(f"synth_frame_numpy at {cfg.camera.width}x{cfg.camera.height}: {frame_ms:.3f} host ms "
          f"a frame on one thread", flush=True)
    out = {"synth_frame_ms": frame_ms, "camera_fps_each": CAM_FPS, "points": []}
    for n in args.streams:
        eng = MultiStreamEngine(cfg, n_streams=n, params=state, device=dev)
        eng.warmup()
        cam = cfg.camera
        prepared = [[synth_frame_numpy(7 + i, t, cam.height, cam.width) for t in range(8)]
                    for i in range(n)]
        packed0 = torch.zeros((n, cam.height * cam.width * 5), dtype=torch.uint8, device=dev)
        chained_ms = chained_step_s(eng._serve_plan_batch, packed0, 8, dev)[0] * 1e3
        readings = {arm: [] for arm in ARMS}
        for r in range(args.rounds):
            for arm in (ARMS if r % 2 == 0 else ARMS[::-1]):
                reading = run_arm(eng, arm, args.ticks, prepared)
                readings[arm].append(reading)
                print(f"N={n} round {r} {arm}: {reading}", flush=True)
        point = {
            "n_streams": n,
            "chained_tick_ms": chained_ms,
            # the share of one core the synthetic feeds ask for at 30 fps
            "synthetic_feed_core_share": n * CAM_FPS * frame_ms / 1e3,
            **{arm: {
                "tick_mean_ms": statistics.median(x["tick_mean_ms"] for x in readings[arm]),
                "ticks_per_s": statistics.median(x["ticks_per_s"] for x in readings[arm]),
                "fresh_frames_per_s": statistics.median(x["fresh_frames_per_s"]
                                                        for x in readings[arm]),
                "runs": readings[arm],
            } for arm in ARMS},
        }
        print(f"N={n}: chained tick {chained_ms:.3f} ms; median tick "
              + ", ".join(f"{arm} {point[arm]['tick_mean_ms']:.3f} ms" for arm in ARMS),
              flush=True)
        out["points"].append(point)
        del eng
    out["device"] = device_info(dev)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
