"""host_nms_ms_per_frame (layer: host NMS, ``ops/nms.py`` and ``native.py``
through ``serve.postprocess_raw``): host milliseconds a frame spent in
``serve.postprocess_raw`` during the requests traced without Python
stacks, timed by a spy on it (``systems/cascade.py``)."""


def read(run):
    if run.plain is None or not run.plain.frames:
        return None
    return 1e3 * run.plain.nms_s / run.plain.frames
