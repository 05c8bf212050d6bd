"""Wall-clock phase timers (the port's copy of the JAX package's
``utils/time_watcher.py``; reference utils/time_watcher.py)."""

from __future__ import annotations

import time

from . import log


class TimeWatcher:
    """Start/stop wall-clock timer that logs its duration on stop."""

    def __init__(self, name: str = "", quiet: bool = False):
        self.name = name
        self._quiet = quiet
        self._start = time.perf_counter()
        self._elapsed: float | None = None
        if not quiet and name:
            log.log("TimeWatcher start: {}".format(name))

    def stop(self) -> float:
        if self._elapsed is None:
            self._elapsed = time.perf_counter() - self._start
            if not self._quiet and self.name:
                log.log(
                    "TimeWatcher stop: {} ({})".format(
                        self.name, self.seconds_to_str(self._elapsed)
                    )
                )
        return self._elapsed

    @property
    def elapsed_seconds(self) -> float:
        if self._elapsed is not None:
            return self._elapsed
        return time.perf_counter() - self._start

    def __enter__(self) -> "TimeWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    @staticmethod
    def seconds_to_str(seconds: float) -> str:
        if seconds < 1:
            return "{:.0f}ms".format(seconds * 1000)
        m, s = divmod(seconds, 60)
        h, m = divmod(int(m), 60)
        if h:
            return "{:d}h {:02d}m {:04.1f}s".format(h, m, s)
        if m:
            return "{:d}m {:04.1f}s".format(m, s)
        return "{:.2f}s".format(s)
