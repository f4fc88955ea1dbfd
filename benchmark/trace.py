"""The traced run's records, from ``torch.profiler``.

``Tracer`` profiles the CPU and, on the card, CUDA activities between
``start()`` and ``stop()``; the harness's drivers open ``bench.<layer>``
ranges (``record_function``) around their calls into the program.
``reduce()`` turns the profile into plain records:

- ``spans``: for each ``bench.*`` range name, its count, its host seconds,
  and the device seconds of the activities launched inside it (a device
  activity belongs to every range open on its launching thread when the
  CPU operation it is correlated with started);
- ``kernels``: device seconds and launches by activity name;
- ``busy_s`` (the union of the device's activities) and ``window_s`` (the
  traced window on the host's clock);
- ``gaps``: the longest idle stretches of the device, each named by the
  innermost ``bench.*`` range open on the main thread when it began.

On the CPU there are no device activities and no device numbers.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

PREFIX = "bench."


class Tracer:
    def __init__(self, on_card: bool):
        from torch.profiler import ProfilerActivity, profile

        self.on_card = on_card
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self.prof = profile(activities=acts)
        self.started = self.stopped = False
        self.window_s = 0.0

    def warm(self, work) -> None:
        """Profile ``work()`` once and drop it: the first session in a
        process initialises the device tracer (seconds), which set-up pays."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        with profile(activities=acts):
            work()
            if self.on_card:
                torch.cuda.synchronize()

    def start(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()
        self.prof.start()
        self.started, self._t = True, time.perf_counter()

    def stop(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t
        self.prof.stop()
        self.stopped = True

    def reduce(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        cpu_types = {"CPU"}
        ranges = collections.defaultdict(list)  # (name, thread) -> [(start, end)]
        ops = {}  # an operation's correlation id -> (start ns, thread)
        launches = {}  # a runtime call's correlation id -> (start ns, thread)
        acts = []
        for e in events:
            dev = str(e.device_type()).rsplit(".", 1)[-1]
            if dev in cpu_types:
                name = e.name()
                start = e.start_ns()
                thread = e.start_thread_id()
                if name.startswith(PREFIX):
                    ranges[(name, thread)].append((start, start + e.duration_ns()))
                if e.correlation_id():
                    table = launches if name.startswith(("cuda", "cu")) else ops
                    table[e.correlation_id()] = (start, thread)
            elif dev == "CUDA" and not e.is_user_annotation():
                acts.append((e.name(), e.start_ns(), e.duration_ns(), e.correlation_id(),
                             e.linked_correlation_id()))
        index = {}
        for key, rs in ranges.items():
            rs.sort()
            index[key] = ([s for s, _ in rs], rs)
        threads = collections.defaultdict(list)
        for name, thread in ranges:
            threads[thread].append(name)

        def open_at(t: int, thread: int) -> list[str]:
            names = []
            for name in threads.get(thread, ()):
                starts, rs = index[(name, thread)]
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and rs[i][1] >= t:
                    names.append((rs[i][0], name))
            return [n for _, n in sorted(names)]  # outermost first

        spans = {}
        for (name, _), rs in ranges.items():
            s = spans.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
            s["count"] += len(rs)
            s["host_s"] += sum(b - a for a, b in rs) / 1e9
        kernels = collections.defaultdict(lambda: [0.0, 0])
        for name, start, dur, corr, linked in acts:
            kernels[name][0] += dur / 1e9
            kernels[name][1] += 1
            # the launch call itself where the trace holds it, else the
            # operation the activity is linked to
            op = launches.get(corr) or ops.get(linked)
            if op is not None:
                for rname in open_at(*op):
                    spans[rname]["device_s"] += dur / 1e9
        busy, gaps, end = 0, [], None
        for _, start, dur, _, _ in sorted(acts, key=lambda a: a[1]):
            stop = start + dur
            if end is None or start > end:
                if end is not None:
                    gaps.append((start - end, end))
                busy, end = busy + dur, stop
            elif stop > end:
                busy, end = busy + stop - end, stop
        main = self.main_thread_id(events)
        named = []
        for gap, at in sorted(gaps, reverse=True)[:10]:
            inner = open_at(at, main) if main is not None else []
            named.append([inner[-1] if inner else "outside bench ranges", gap / 1e9])
        return {"on_card": self.on_card and bool(acts), "window_s": self.window_s,
                "busy_s": busy / 1e9, "spans": spans,
                "kernels": {k: tuple(v) for k, v in kernels.items()}, "gaps": named}

    @staticmethod
    def main_thread_id(events):
        """The thread that opened the ``bench.*`` ranges (the driver's)."""
        counts = collections.Counter(e.start_thread_id() for e in events
                                     if e.name().startswith(PREFIX))
        return counts.most_common(1)[0][0] if counts else None


def breakdown(records: dict) -> dict:
    """The ten device operations of most time and the ten longest idle gaps."""
    top = sorted(records["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name, s] for name, (s, _) in top], "idle_gaps": records["gaps"][:10]}


def span(name: str):
    """A ``bench.*`` range (a no-op where nothing profiles)."""
    from torch.profiler import record_function

    return record_function(name)
