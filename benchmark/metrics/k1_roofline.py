"""k1_roofline (layer: re-extraction K1, ``ops/windows_cuda.py``): the
least time K1 could take for the boxes the traced requests need (each
later stage's windows, the survivors of the stage before by the
reference; ``harness/counts.resample_bound_s``, f32 output), over the
device time of K1's kernel (``resample_kernel`` launched under
``ops/windows_cuda.py``). Nothing to read where K1 did not run."""

import re

from benchmark.harness import counts

MODULE = "ops/windows_cuda.py"
KERNEL = re.compile(r"\bresample_kernel\b")


def _k1(chain, name):
    return MODULE in chain and bool(KERNEL.search(name))


def read(run):
    if run.stacked is None:
        return None
    seconds = run.stacked.trace.seconds(_k1)
    if seconds <= 0:
        return None
    fr = run.traffic["frame"]
    bound = 0.0
    for r in run.stacked.requests:
        windows = run.stage_windows(r)
        for st, n in zip(run.stages[1:], windows[1:]):
            bound += counts.resample_bound_s(len(r["idx"]), fr["height"], fr["width"], n,
                                             st["size"], 4)
    return 100.0 * bound / seconds
