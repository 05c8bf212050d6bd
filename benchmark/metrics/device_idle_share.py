"""device_idle_share (layer: device): the share of the traced window in
which nothing ran on the card: the window minus the union of the kernel,
copy and set intervals, from the session traced without Python stacks."""


def read(run):
    if run.plain is None or run.plain.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.plain.trace.busy_s() / run.plain.window_s)
