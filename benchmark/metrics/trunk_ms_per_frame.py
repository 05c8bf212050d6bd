"""trunk_ms_per_frame (layer: Inception stage, ``models/inception.py``,
``models/inception_v3.py``): device milliseconds a frame of the work
launched with the trunk's modules on the launch's Python stack. Nothing
to read without an Inception stage."""

MODULES = ("models/inception.py", "models/inception_v3.py")


def _trunk(chain, name):
    return any(m in chain for m in MODULES)


def read(run):
    if run.stacked is None or not run.stacked.frames:
        return None
    seconds = run.stacked.trace.seconds(_trunk)
    return 1e3 * seconds / run.stacked.frames if seconds > 0 else None
