"""tflops: all the window's useful operations (2mnk a real call, 8mnk a
complex one) over all its device time, first mark to last."""

from portbench.window import rate


def read(ctx):
    return rate(ctx.steps, ctx.plan.flops_per_step, ctx.window.span_s)
