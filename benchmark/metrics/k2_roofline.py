"""k2_roofline (layer: stage-0 crop K2, ``ops/windows_sched_cuda.py``): the
least time K2 could take for the windows of the traced frames' pyramids
(every window once, bf16 output; ``harness/counts.resample_bound_s``),
over the device time of K2's kernel (``sched_kernel`` launched under
``ops/windows_sched_cuda.py``). Nothing to read where K2 did not run."""

import re

from benchmark.harness import counts

MODULE = "ops/windows_sched_cuda.py"
KERNEL = re.compile(r"\bsched_kernel\b")


def _k2(chain, name):
    return MODULE in chain and bool(KERNEL.search(name))


def read(run):
    if run.stacked is None:
        return None
    seconds = run.stacked.trace.seconds(_k2)
    if seconds <= 0:
        return None
    fr = run.traffic["frame"]
    bound = sum(counts.resample_bound_s(len(r["idx"]), fr["height"], fr["width"],
                                        run.stage_windows(r)[0], run.stages[0]["size"], 2)
                for r in run.stacked.requests)
    return 100.0 * bound / seconds
