"""launches_per_step: the program's kernel-launch counter
(`gemmul8_tpu_torch.hopper.build.LAUNCHES`, one count a wrapper's launch)
summed over the window, per step."""


def read(ctx):
    if ctx.launches is None or not ctx.steps:
        return None
    return ctx.launches / ctx.steps
