"""Stage timers, an FPS meter, the program's spans and counters, and a
device trace (counterpart of the JAX package's ``runtime/profiler.py``).

Per-stage wall timers with percentile stats, an FPS meter over a sliding
window, and ``device_trace``, a ``torch.profiler`` trace of the host and the
card written as a Chrome trace.

``span(name)`` is the one way the program opens a named range: it records
the block's host time into the process-wide table ``SPANS`` always, and
opens a ``torch.profiler`` range of the same name only while a profiler
session is active, so that the range lands in the profile on the device's
clock and costs nothing else without one.  ``count(name, n)`` adds to a
counter of the same table.  Names are ``<layer>/<part>``: ``stage/*`` for
the serving steps, ``train/*`` for ``Trainer.train`` (which clears its own
at entry, ``SPANS.reset("train/")``).
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from collections import defaultdict, deque

import numpy as np
from torch.autograd import profiler as _autograd_profiler


class StageTimer:
    """Accumulates wall-clock samples per named stage, and counters.
    Thread-safe: the loop, its helper threads and the path server's
    ``GetStat`` share one."""

    def __init__(self, window: int = 512):
        self.samples: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self.counts: dict[str, int] = defaultdict(int)
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

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

    def counter(self, name: str) -> int:
        """The counter ``name`` (0 where nothing was counted)."""
        with self._lock:
            return self.counts.get(name, 0)

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

    def summary(self, prefix: str = "") -> dict:
        """``stats`` of every stage whose name starts with ``prefix``."""
        with self._lock:
            names = [k for k in self.samples if k.startswith(prefix)]
        return {k: self.stats(k) for k in names}

    def reset(self, prefix: str = "") -> None:
        """Clear the samples and counters whose names start with
        ``prefix`` (all of them by default)."""
        with self._lock:
            for table in (self.samples, self.counts):
                for k in [k for k in table if k.startswith(prefix)]:
                    del table[k]


SPANS = StageTimer()


class span:
    """``with span(name):`` records the block's host seconds into ``SPANS``
    when it exits normally, and, while a ``torch.profiler`` session is
    active in the process, wraps it in ``record_function(name)``.

    The check is the profiler's process-wide flag (``torch.autograd.
    profiler._is_profiler_enabled``, a Python bool read): the range opens
    on every thread while any session runs, and lands in the profile on
    the threads that carry the session (the one that started it, autograd's
    device threads); a thread of one's own does not (torch 2.11 and 2.13).
    Without a session a span costs two clock reads and a lock: 1.4 µs on
    the H100 machine's host, where ``record_function`` costs 10.8 µs."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if exc_type is None:
            SPANS.record(self.name, seconds)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name`` in ``SPANS``."""
    SPANS.count(name, n)


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
