"""redispatches_per_req (layer: orchestration, ``models/cascade.py``): the
detector's saturation re-runs (``CascadeDetector.redispatches``) during
the requests traced without Python stacks, per request."""


def read(run):
    if run.plain is None or not run.plain.requests:
        return None
    return run.plain.redispatches / len(run.plain.requests)
