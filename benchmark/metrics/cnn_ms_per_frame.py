"""cnn_ms_per_frame (layer: stage CNNs, ``models/cnn.py``): device
milliseconds a frame of the work launched from the stage CNNs (innermost
detector module on the launch's Python stack), the Inception trunk's
modules not on that stack."""

MODULES = ("models/cnn.py",)
TRUNK = ("models/inception.py", "models/inception_v3.py")


def _cnn(chain, name):
    return bool(chain) and chain[-1] in MODULES and not any(m in chain for m in TRUNK)


def read(run):
    if run.stacked is None or not run.stacked.frames:
        return None
    return 1e3 * run.stacked.trace.seconds(_cnn) / run.stacked.frames
