"""step_ms_p95: the 95th percentile of the times of all the window's
steps, each from the mark after the step before it to its own."""

from portbench.window import percentile


def read(ctx):
    return percentile(ctx.window.step_ms, 95)
