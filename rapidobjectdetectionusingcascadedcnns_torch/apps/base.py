"""Application base: timing, interrupt handling, log persistence
(counterpart of the JAX package's ``apps/base.py``).

Re-design of ``BaseApp`` (app/base_app.py:32-65): ``run()`` wraps ``_main()``
with a phase timer, converts Ctrl-C into the cancel hook, and saves the
session log on completion.

The JAX ``BaseApp.run`` first enables XLA's persistent compilation cache
(its ``utils/jit_cache.py``). The port has no counterpart module: it
compiles no program at run time, and its kernels' build cache is
``ops/_build.py``'s, libraries named by a hash of their sources and flags,
built once and reused by every process.
"""

from __future__ import annotations

import abc

from .. import config as cf
from ..utils import log
from ..utils.time_watcher import TimeWatcher


class BaseApp(abc.ABC):
    def __init__(self, run_now: bool = True):
        if run_now:
            self.run()

    @abc.abstractmethod
    def _main(self):
        ...

    def _on_cancel(self):
        log.log("cancelled by user")

    def _on_finished(self):
        if cf.get("log_auto_save"):
            log.log_save(cf.ensure_dir("log_dir"), cf.get("session_key"))

    def run(self):
        # no compile cache to enable (module docstring)
        timer = TimeWatcher(type(self).__name__)
        try:
            self._main()
        except KeyboardInterrupt:
            self._on_cancel()
        finally:
            timer.stop()
            self._on_finished()
