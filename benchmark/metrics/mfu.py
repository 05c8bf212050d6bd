"""mfu (layer: the whole step): the operations the frames of the session
traced without Python stacks need, over that session's window and the
card's bf16 peak (989 TFLOP/s, H100 SXM at 700 W). Counted by the
benchmark from the reference's survivors (``harness/counts.py``): stage 0
over every pyramid window, each later stage over the windows the stage
before kept, the InceptionV3 trunk over what reaches it; two operations a
multiply-add of every convolution and fully connected layer."""

from benchmark.harness import counts


def read(run):
    if run.plain is None or run.plain.window_s <= 0 or not run.plain.requests:
        return None
    per_window = counts.stage_flops(run.stages, run.config)
    flops = sum(n * f for r in run.plain.requests
                for n, f in zip(run.stage_windows(r), per_window))
    return 100.0 * flops / (run.plain.window_s * counts.BF16_FLOPS)
