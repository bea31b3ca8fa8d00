"""crt_roofline: percent of the CRT reconstruct's byte bound (the L
residues of each output element read, the shifts read, C written once;
merged with the phases of any kernel that also does other work) over the
device time of the kernels doing it."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.roofline("crt")
