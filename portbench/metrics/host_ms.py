"""host_ms: the host's time in each step's calls (the benchmark's own span
around them: `api` down through `core` and the `hopper` wrappers to the
launches), a mean over the traced run's untraced steps, which bear no
profiler cost. With at most `harness.IN_FLIGHT` steps queued, it is the
host's work and not a wait for room in the launch queue."""


def read(ctx):
    spans = ctx.window.host_ms[ctx.window.traced_steps:]
    return sum(spans) / len(spans) if spans else None
