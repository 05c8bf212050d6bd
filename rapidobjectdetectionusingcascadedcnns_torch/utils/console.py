"""Subprocess runner that logs stdout lines (the port's copy of the JAX
package's ``utils/console.py``; reference utils/console.py:8-22)."""

from __future__ import annotations

import subprocess
from typing import List, Union

from . import log


def run(command: Union[str, List[str]]) -> int:
    """Run a console command, streaming stdout lines into the log."""
    if isinstance(command, str):
        command = [command]
    log.log("console.run: {}".format(" ".join(command)))
    proc = subprocess.Popen(
        command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    assert proc.stdout is not None
    for line in proc.stdout:
        log.log("  | {}".format(line.rstrip()))
    return proc.wait()
