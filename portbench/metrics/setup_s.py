"""setup_s: host seconds from the process's start to the window's."""


def read(ctx):
    return ctx.setup_s
