"""device_idle_pct: percent of the traced stretch (first device operation's
start to last one's end) in which no kernel, copy or fill ran."""


def read(ctx):
    if ctx.trace is None:
        return None
    span = ctx.trace.window_us()
    return 100.0 * (1.0 - ctx.trace.busy_us() / span) if span > 0 else None
