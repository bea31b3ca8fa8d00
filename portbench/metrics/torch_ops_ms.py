"""torch_ops_ms: device time per step in operations that no file under
`kernels/` assigns to a phase: the torch operations of `api` and `core`
(complex parts, copies, shift arithmetic, epilogue)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.window.traced_steps:
        return None
    return ctx.trace.torch_ops_us() / 1e3 / ctx.window.traced_steps
