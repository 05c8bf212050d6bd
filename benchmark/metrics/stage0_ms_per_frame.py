"""stage0_ms_per_frame (layer: stage-0 windows): device milliseconds a
frame of the work launched from the colour decode, the pyramid and the
stage-0 extraction, K2 included (innermost detector module on the launch's
Python stack), not from under K1's wrapper."""

MODULES = ("ops/color.py", "ops/windows.py", "ops/windows_sched.py",
           "ops/windows_sched_cuda.py")


def _stage0(chain, name):
    return bool(chain) and chain[-1] in MODULES and "ops/windows_cuda.py" not in chain


def read(run):
    if run.stacked is None or not run.stacked.frames:
        return None
    return 1e3 * run.stacked.trace.seconds(_stage0) / run.stacked.frames
