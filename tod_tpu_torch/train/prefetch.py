"""Host-side training input pipeline: background batch staging (the
port's copy of the JAX package's ``train/prefetch.py``).

Scene synthesis and ``np.stack`` staging run on a producer thread while the
main thread launches the train steps of the chunk before: a one-thread
producer/consumer queue.  The single producer calls ``data.next_batch()``
strictly in order, so the consumed batch stream is identical to the
serial loop's.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class PrefetchChunks:
    """Iterator of stacked batch dicts, staged by a background thread.

    ``sizes`` is the chunk-size schedule (e.g. ``[8, 8, 8, 4]`` for 28 steps
    at chunk=8); each yielded item is ``{k: (n, B, ...) np.ndarray}`` holding
    ``n`` consecutive batches from ``data``.  ``depth`` bounds the staging
    queue (memory = depth × chunk × batch bytes).  Producer exceptions are
    re-raised in the consumer at the failing position.
    """

    _DONE = object()

    def __init__(self, data, sizes: list[int], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._sizes = list(sizes)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(data,), daemon=True, name="train-prefetch"
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when close() is called — an abandoned
        consumer (training loop raised mid-chunk) must not pin the producer
        thread + depth×chunk×batch of staged arrays for process lifetime."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, data) -> None:
        try:
            for n in self._sizes:
                if self._stop.is_set():
                    return
                bs = [data.next_batch() for _ in range(n)]
                if not self._put({k: np.stack([b[k] for b in bs]) for k in bs[0]}):
                    return
            self._put(self._DONE)
        except BaseException as e:  # surfaced to the consumer
            self._put(e)

    def close(self) -> None:
        """Release the producer thread and staged memory (idempotent; called
        by Trainer.train's finally)."""
        self._stop.set()
        try:  # drain so a blocked put can observe the stop promptly
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def chunk_schedule(steps: int, chunk: int) -> list[int]:
    """Chunk sizes covering ``steps``: full chunks then one remainder."""
    if chunk <= 1:
        return [1] * steps
    full, rem = divmod(steps, chunk)
    return [chunk] * full + ([rem] if rem else [])
