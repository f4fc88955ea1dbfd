"""A frame-progress watchdog (counterpart of the JAX package's
``runtime/watchdog.py``): if the engine stops producing frames (a camera
stall, a wedged source), it fires a callback instead of hanging silently."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class Watchdog:
    """Fires ``on_stall`` if ``heartbeat()`` isn't called within ``timeout_s``."""

    def __init__(
        self,
        timeout_s: float = 5.0,
        on_stall: Optional[Callable[[float], None]] = None,
        check_interval_s: float = 0.5,
    ):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or (
            lambda age: log.error("watchdog: no frame for %.1fs", age)
        )
        self.check_interval_s = check_interval_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def heartbeat(self) -> None:
        self._last = time.monotonic()
        self._fired = False

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tod-watchdog")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            age = time.monotonic() - self._last
            if age > self.timeout_s and not self._fired:
                self._fired = True
                self.stall_count += 1
                self.on_stall(age)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
