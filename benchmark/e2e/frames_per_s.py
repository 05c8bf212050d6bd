"""frames_per_s: every frame the window's requests completed (host NMS
done, detections on the host) over the window's seconds, host clock."""


def read(run):
    if run.window_s <= 0 or not run.requests:
        return None
    return run.frames / run.window_s
