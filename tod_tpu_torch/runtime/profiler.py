"""Stage timers, an FPS meter and a device trace (counterpart of the JAX
package's ``runtime/profiler.py``).

Per-stage wall timers with percentile stats, an FPS meter over a sliding
window, and ``device_trace``, a ``torch.profiler`` trace of the host and the
card written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from collections import defaultdict, deque

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage.  Thread-safe: the
    loop, its helper threads and the path server's ``GetStat`` share one."""

    def __init__(self, window: int = 512):
        self.samples: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a block; ``sync`` (a ``torch.cuda.Event`` recorded inside
        the block, or anything with ``synchronize()``) is waited on before
        the clock stops, so that the device's work is counted."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync.synchronize()
        self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.samples[name].append(seconds)

    def stats(self, name: str) -> dict:
        with self._lock:
            xs = np.asarray(self.samples.get(name, ()), np.float64)
        if xs.size == 0:
            return {"n": 0}
        return {
            "n": int(xs.size),
            "mean_ms": float(xs.mean() * 1e3),
            "min_ms": float(xs.min() * 1e3),
            "p50_ms": float(np.percentile(xs, 50) * 1e3),
            "p90_ms": float(np.percentile(xs, 90) * 1e3),
            "p99_ms": float(np.percentile(xs, 99) * 1e3),
            "max_ms": float(xs.max() * 1e3),
        }

    def summary(self) -> dict:
        with self._lock:
            names = list(self.samples)
        return {k: self.stats(k) for k in names}

    def reset(self) -> None:
        with self._lock:
            self.samples.clear()


class FPSMeter:
    """Frames per second over a sliding window."""

    def __init__(self, window: int = 120):
        self.times: deque = deque(maxlen=window)

    def tick(self) -> None:
        self.times.append(time.perf_counter())

    @property
    def fps(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / dt if dt > 0 else 0.0


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """``torch.profiler`` trace of the block, host and (where there is one)
    card, written to ``<logdir>/trace.json``; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
