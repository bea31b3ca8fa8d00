"""gemm_roofline: percent of the residue products' bound (L products of
2mnk int8 operations a real call, 4L a complex one; each slice read once,
each residue written once; merged with the phases of any kernel that
also does other work) over the device time of the kernels doing it."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.roofline("gemm")
